"""HDR environment map with 2-D CDF importance-sampling tables.

Parity: reference src/envmap.rs:

* decodes float RGB(A) images only and validates every texel against
  NaN/Inf (envmap.rs:57-71);
* builds per-row PDF/CDF + 1-D column CDF with BT.709 luminance weights
  (envmap.rs:249-308), then INVERTS both CDFs into lookup tables so
  sampling is two fetches instead of a binary search (envmap.rs:311-331):
  `marginal[v] = lower_bound(cdf_1d, (v+1)/H) / H` and
  `conditional[v][u] = lower_bound(cdf_2d[v], (u+1)/W) / W`;
* disk-caches the tables at ./out/{name}.dist_cache as a raw f32 LE
  stream [total_sum, marginal[H], conditional[H*W]] (envmap.rs:90-142) —
  the same binary layout, so caches interoperate.

The sampling-side code (2-fetch sample, pdf for MIS) lives in
hala_tpu.ops.env.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .error import HalaRendererError
from .scene.cpu.image_data import ImageData, ImageFormat

logger = logging.getLogger("hala_tpu.envmap")

# BT.709 luminance weights (envmap.rs:249-251).
_LUMA = np.array([0.212671, 0.715160, 0.072169], np.float32)


def _register(cls, meta_fields=()):
    data_fields = tuple(
        f.name for f in dataclasses.fields(cls) if f.name not in meta_fields
    )
    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=tuple(meta_fields)
    )
    return cls


@partial(_register, meta_fields=("width", "height", "name"))
@dataclasses.dataclass
class EnvMap:
    """Equirectangular HDR environment + inverted-CDF tables (pytree)."""

    image: jax.Array            # (H, W, 3) f32 radiance
    marginal: jax.Array         # (H,) f32 — inverted 1-D CDF lookup
    conditional: jax.Array      # (H, W) f32 — inverted per-row CDF lookup
    luminance: jax.Array        # (H, W) f32 — texel luminance (pdf eval)
    total_luminance: jax.Array  # () f32
    # Derived 2x2-neighborhood table (H, W, 16): for cell (y, x) the
    # rgb+luminance of [c(y,x) | c(y,x+1 wrap) | c(y+1 clamp,x) |
    # c(y+1,x+1)]. One 16-wide row take then serves an ENTIRE bilinear
    # fetch AND the nearest-texel pdf instead of ~9 separate per-bounce
    # gathers. None for large maps (memory x16).
    quad: jax.Array | None = None
    # Derived per-texel sample table (H, W, 8): [rgb | luminance |
    # dir0.xyz | sin_theta] where dir0 = uv_to_dir(x/W, y/H, rotation=0)
    # for the texel the inverted-CDF sample lands on. env_sample then
    # needs ZERO per-element transcendentals: env_rotation is a pure
    # Y-rotation, applied as a scalar 2x2 rotation of dir0.xz, and the
    # pdf's sin(theta) rides lane 7. None for large maps (memory x8).
    stab: jax.Array | None = None
    # Fused inverted-CDF sample table (H, W, 8): sstab[vi, ui] is the
    # stab row of the texel the 2-level CDF inversion lands on for
    # integer draw (vi, ui) — i.e. stab[vrow(vi), xi(vrow, ui)]. The
    # whole of env_sample's 3-take chain (marginal -> conditional ->
    # stab) collapses to ONE row take: both inversions are texel-grid
    # to texel-grid, so their composition is a precomputable
    # permutation. None for large maps (memory x8).
    sstab: jax.Array | None = None
    width: int = 0
    height: int = 0
    name: str = "envmap"

    @staticmethod
    def load(path: str, cache_dir: str = "./out") -> "EnvMap":
        img = ImageData.load(path)
        if img.format != ImageFormat.R32G32B32A32_SFLOAT:
            raise HalaRendererError(
                "Environment map must be a float image (envmap.rs:57-60)."
            )
        rgb = img.pixels[..., :3].astype(np.float32)
        if not np.isfinite(rgb).all():
            raise HalaRendererError(
                "Environment map contains NaN/Inf texels (envmap.rs:63-71)."
            )
        name = os.path.splitext(os.path.basename(path))[0]
        h, w = rgb.shape[:2]

        cache_path = os.path.join(cache_dir, f"{name}.dist_cache")
        total = marginal = conditional = None
        if os.path.exists(cache_path):
            try:
                raw = np.fromfile(cache_path, "<f4")
                if raw.size == 1 + h + h * w:
                    total = float(raw[0])
                    marginal = raw[1 : 1 + h].copy()
                    conditional = raw[1 + h :].reshape(h, w).copy()
                    logger.info("Loaded envmap distribution cache %s", cache_path)
            except OSError:
                pass
        if marginal is None:
            total, marginal, conditional = build_distribution_maps(rgb)
            try:
                os.makedirs(cache_dir, exist_ok=True)
                stream = np.concatenate(
                    [[np.float32(total)], marginal.ravel(), conditional.ravel()]
                ).astype("<f4")
                stream.tofile(cache_path)
            except OSError:  # cache write failure is non-fatal
                logger.warning("Could not write envmap cache %s", cache_path)

        lum = (rgb * _LUMA).sum(-1)
        quad = _build_quad(rgb, lum)
        stab = _build_stab(rgb, lum)
        sstab = _build_sstab(marginal, conditional, stab)
        return EnvMap(
            image=jnp.asarray(rgb),
            marginal=jnp.asarray(marginal),
            conditional=jnp.asarray(conditional),
            luminance=jnp.asarray(lum),
            total_luminance=jnp.float32(total),
            quad=None if quad is None else jnp.asarray(quad),
            stab=None if stab is None else jnp.asarray(stab),
            sstab=None if sstab is None else jnp.asarray(sstab),
            width=w,
            height=h,
            name=name,
        )

    @staticmethod
    def from_array(rgb: np.ndarray, name: str = "envmap") -> "EnvMap":
        """Build directly from an (H, W, 3) float array (tests/procedural)."""
        rgb = np.asarray(rgb, np.float32)
        total, marginal, conditional = build_distribution_maps(rgb)
        lum = (rgb * _LUMA).sum(-1)
        quad = _build_quad(rgb, lum)
        stab = _build_stab(rgb, lum)
        sstab = _build_sstab(marginal, conditional, stab)
        return EnvMap(
            image=jnp.asarray(rgb),
            marginal=jnp.asarray(marginal),
            conditional=jnp.asarray(conditional),
            luminance=jnp.asarray(lum),
            total_luminance=jnp.float32(total),
            quad=None if quad is None else jnp.asarray(quad),
            stab=None if stab is None else jnp.asarray(stab),
            sstab=None if sstab is None else jnp.asarray(sstab),
            width=rgb.shape[1],
            height=rgb.shape[0],
            name=name,
        )


# Quad tables above this texel count are skipped (16x memory).
_QUAD_MAX_TEXELS = 1 << 22


def _build_quad(rgb: np.ndarray, lum: np.ndarray) -> "np.ndarray | None":
    """(H, W, 16) 2x2-neighborhood table (see EnvMap.quad)."""
    h, w = rgb.shape[:2]
    if h * w > _QUAD_MAX_TEXELS:
        return None
    packed = np.concatenate([rgb, lum[..., None]], axis=-1)  # (H, W, 4)
    px = np.roll(packed, -1, axis=1)                # x+1 with wrap
    py = np.concatenate([packed[1:], packed[-1:]])  # y+1 with clamp
    pxy = np.roll(py, -1, axis=1)
    return np.concatenate([packed, px, py, pxy], axis=-1).astype(np.float32)


def _build_stab(rgb: np.ndarray, lum: np.ndarray) -> "np.ndarray | None":
    """(H, W, 8) per-texel sample table (see EnvMap.stab).

    dir0 mirrors ops.env.uv_to_dir(x/W, y/H, rotation=0) in f32: the
    inverted-CDF tables only ever emit u = col/W, v = row/H, so the
    direction (and the pdf's sin(theta)) is a pure per-texel constant
    up to the runtime Y-rotation.
    """
    h, w = rgb.shape[:2]
    if h * w > _QUAD_MAX_TEXELS:
        return None
    u = (np.arange(w, dtype=np.float32) / np.float32(w))[None, :]  # (1, W)
    v = (np.arange(h, dtype=np.float32) / np.float32(h))[:, None]  # (H, 1)
    phi = ((u - np.float32(0.5)) * np.float32(2.0 * np.pi)).astype(np.float32)
    theta = (v * np.float32(np.pi)).astype(np.float32)
    sin_t = np.sin(theta).astype(np.float32)                       # (H, 1)
    dir0 = np.empty((h, w, 3), np.float32)
    dir0[..., 0] = sin_t * np.cos(phi)
    dir0[..., 1] = np.broadcast_to(np.cos(theta), (h, w))
    dir0[..., 2] = sin_t * np.sin(phi)
    sin_clamped = np.broadcast_to(np.maximum(sin_t, np.float32(1e-6)), (h, w))
    return np.concatenate(
        [rgb, lum[..., None], dir0, sin_clamped[..., None]], axis=-1
    ).astype(np.float32)


def _build_sstab(
    marginal: np.ndarray, conditional: np.ndarray, stab: "np.ndarray | None"
) -> "np.ndarray | None":
    """(H, W, 8) fused sample table (see EnvMap.sstab).

    Reproduces ops.env.env_sample's two inversion steps in the exact
    f32-multiply-then-truncate semantics the kernel used, so swapping
    three takes for one is bit-identical.
    """
    if stab is None:
        return None
    h, w = conditional.shape
    vi = np.arange(h, dtype=np.int32)
    v = np.asarray(marginal, np.float32)[vi]
    vrow = np.clip((v * np.float32(h)).astype(np.int32), 0, h - 1)  # (H,)
    u = np.asarray(conditional, np.float32)[vrow, :]                # (H, W)
    xi = np.clip((u * np.float32(w)).astype(np.int32), 0, w - 1)
    return stab[vrow[:, None], xi]


def build_distribution_maps(rgb: np.ndarray):
    """(total_sum, marginal (H,), conditional (H, W)) per envmap.rs:239-388.

    Vectorized re-expression of the reference's rayon row loop: identical
    outputs (same lower_bound-on-CDF inversion), no per-texel Python.
    """
    h, w = rgb.shape[:2]
    weight = (rgb[..., :3] * _LUMA).sum(-1).astype(np.float32)  # (H, W)
    total_sum = float(np.cumsum(weight.ravel(), dtype=np.float32)[-1])

    # Sequential cumsum; the row normalizer must be the cumsum's own last
    # element (not a pairwise .sum()) to reproduce the reference's
    # accumulate-then-divide float semantics exactly.
    cdf_2d_raw = np.cumsum(weight, axis=1, dtype=np.float32)
    row_sum = cdf_2d_raw[:, -1]
    safe_row = np.where(row_sum > 0, row_sum, 1.0)
    cdf_2d = cdf_2d_raw / safe_row[:, None]

    col_cdf = np.cumsum(row_sum, dtype=np.float32)
    col_total = col_cdf[-1] if col_cdf[-1] > 0 else 1.0
    cdf_1d = (col_cdf / col_total).astype(np.float32)

    # Invert: marginal[v] = lower_bound(cdf_1d, (v+1)/H) / H.
    targets_v = (np.arange(1, h + 1, dtype=np.float32)) / np.float32(h)
    rows = np.searchsorted(cdf_1d, targets_v, side="left")
    marginal = rows.astype(np.float32) / np.float32(h)

    # conditional[v][u] = lower_bound(cdf_2d[v], (u+1)/W) / W.
    targets_u = (np.arange(1, w + 1, dtype=np.float32)) / np.float32(w)
    cols = np.empty((h, w), np.int64)
    for v in range(h):
        cols[v] = np.searchsorted(cdf_2d[v], targets_u, side="left")
    conditional = cols.astype(np.float32) / np.float32(w)

    return total_sum, marginal, conditional
