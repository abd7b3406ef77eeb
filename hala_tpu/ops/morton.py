"""Morton (Z-order) codes: host (numpy) and device (jnp) versions.

The device path is the first stage of the on-device LBVH build
(BASELINE config[4]: Morton codes -> radix sort -> hierarchy): 30-bit
codes (10 bits/axis) over positions normalized to a scene AABB, sorted
with `jax.lax.sort`. The host version orders small meshes into
spatially coherent clusters at upload (scene/loader/uploader.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _expand_bits_np(v: np.ndarray) -> np.ndarray:
    """Spread 10 bits to every 3rd bit (u32)."""
    v = v.astype(np.uint32) & np.uint32(0x3FF)
    v = (v | (v << 16)) & np.uint32(0x030000FF)
    v = (v | (v << 8)) & np.uint32(0x0300F00F)
    v = (v | (v << 4)) & np.uint32(0x030C30C3)
    v = (v | (v << 2)) & np.uint32(0x09249249)
    return v


def morton3d_np(points: np.ndarray, bounds_min, bounds_max) -> np.ndarray:
    """30-bit Morton codes for (N, 3) points within the given AABB."""
    ext = np.maximum(np.asarray(bounds_max) - np.asarray(bounds_min), 1e-9)
    q = np.clip((points - bounds_min) / ext, 0.0, 1.0 - 1e-7)
    cells = (q * 1024.0).astype(np.uint32)
    return (
        (_expand_bits_np(cells[:, 0]) << 2)
        | (_expand_bits_np(cells[:, 1]) << 1)
        | _expand_bits_np(cells[:, 2])
    )


def _expand_bits_jnp(v: jnp.ndarray) -> jnp.ndarray:
    v = v.astype(jnp.uint32) & jnp.uint32(0x3FF)
    v = (v | (v << 16)) & jnp.uint32(0x030000FF)
    v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
    v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
    v = (v | (v << 2)) & jnp.uint32(0x09249249)
    return v


def morton3d(points: jnp.ndarray, bounds_min, bounds_max) -> jnp.ndarray:
    """Device 30-bit Morton codes for (N, 3) points."""
    ext = jnp.maximum(bounds_max - bounds_min, 1e-9)
    q = jnp.clip((points - bounds_min) / ext, 0.0, 1.0 - 1e-7)
    cells = (q * 1024.0).astype(jnp.uint32)
    return (
        (_expand_bits_jnp(cells[:, 0]) << 2)
        | (_expand_bits_jnp(cells[:, 1]) << 1)
        | _expand_bits_jnp(cells[:, 2])
    )


def sort_by_morton(codes: jnp.ndarray, *payloads):
    """Device sort: (sorted_codes, permuted payloads...). XLA sort takes
    the radix-sort role (SURVEY.md section 7 stage 4)."""
    order = jnp.argsort(codes)
    return (codes[order],) + tuple(
        jnp.take(p, order, axis=0) for p in payloads
    )
