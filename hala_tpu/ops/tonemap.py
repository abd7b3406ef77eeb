"""Tonemap operators.

Parity: reference src/rt_renderer.rs:1256-1316 — the three CPU tonemap
operators applied in save_images:

* `tonemap_reinhard_lum` — luminance-limited c / (1 + Y/limit), limit 1.5;
* `tonemap_aces_simple` — Narkowicz ACES fit (2.51/0.03/2.43/0.59/0.14);
* `tonemap_aces_fitted` — Stephen Hill's fitted ACES with RRT/ODT fit and
  the input/output matrices at rt_renderer.rs:1266-1281.

All operate on (..., 3) linear radiance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# BT.709 luminance (rt_renderer.rs:1258-1260, also envmap.rs:249-251).
LUMA = jnp.asarray([0.212671, 0.715160, 0.072169], jnp.float32)

# ACES fitted matrices (rt_renderer.rs:1266-1281; public Stephen Hill
# constants). Stored row-major for `c @ M.T`.
_ACES_INPUT = jnp.asarray(
    [
        [0.59719, 0.35458, 0.04823],
        [0.07600, 0.90834, 0.01566],
        [0.02840, 0.13383, 0.83777],
    ],
    jnp.float32,
)
_ACES_OUTPUT = jnp.asarray(
    [
        [1.60475, -0.53108, -0.07367],
        [-0.10208, 1.10813, -0.00605],
        [-0.00327, -0.07276, 1.07602],
    ],
    jnp.float32,
)


def luminance(c: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(c * LUMA, axis=-1, keepdims=True)


def tonemap_reinhard_lum(c: jnp.ndarray, limit: float = 1.5) -> jnp.ndarray:
    return c / (1.0 + luminance(c) / limit)


def tonemap_aces_simple(c: jnp.ndarray) -> jnp.ndarray:
    a, b, y, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return jnp.clip((c * (a * c + b)) / (c * (y * c + d) + e), 0.0, 1.0)


def _rrt_odt_fit(v: jnp.ndarray) -> jnp.ndarray:
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.432951) + 0.238081
    return a / b


def tonemap_aces_fitted(c: jnp.ndarray) -> jnp.ndarray:
    # float32 products (the GPU default would round operands to TF32)
    hi = jax.lax.Precision.HIGHEST
    c = jnp.matmul(c, _ACES_INPUT.T, precision=hi)
    c = _rrt_odt_fit(c)
    c = jnp.matmul(c, _ACES_OUTPUT.T, precision=hi)
    return jnp.clip(c, 0.0, 1.0)


def apply_tonemap(
    c: jnp.ndarray,
    enable_tonemap: bool,
    enable_aces: bool,
    use_simple_aces: bool,
) -> jnp.ndarray:
    """Operator selection exactly as rt_renderer.rs:1303-1313."""
    if not enable_tonemap:
        return c
    if enable_aces:
        if use_simple_aces:
            return tonemap_aces_simple(c)
        return tonemap_aces_fitted(c)
    return tonemap_reinhard_lum(c, 1.5)
