"""Counter-based per-pixel RNG for rendering.

Role parity: the reference seeds its external shaders with a blue-noise
texture + `frame_index` uniform (rt_renderer.rs:414, 1117-1156). Here the
sampler is a PCG4D counter hash (Jarzynski & Olano, "Hash Functions for
GPU Rendering", JCGT 2020 — public domain): stateless, vectorizes
perfectly on the VPU, and gives each (pixel, frame, bounce, dim) its own
stream, so renders are deterministic given (seed, frame_index) exactly
like the reference's progressive accumulation contract.

An optional blue-noise texture can replace the first two dimensions of
the first sample for parity with load_blue_noise_texture.
"""

from __future__ import annotations

import jax.numpy as jnp

_INV_U24 = jnp.float32(1.0 / (1 << 24))  # exact in f32


def pcg4d(v: jnp.ndarray) -> jnp.ndarray:
    """PCG4D hash. v: (..., 4) uint32 -> (..., 4) uint32."""
    v = v * jnp.uint32(1664525) + jnp.uint32(1013904223)
    x = v[..., 0] + v[..., 1] * v[..., 3]
    y = v[..., 1] + v[..., 2] * x
    z = v[..., 2] + x * y
    w = v[..., 3] + y * z
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return jnp.stack([x, y, z, w], axis=-1)


def sample4(
    pixel_index: jnp.ndarray, frame_index, bounce, seed=0
) -> jnp.ndarray:
    """Four uniform floats in [0, 1) per pixel for one (frame, bounce).

    pixel_index: (...,) int32/uint32 linear pixel id.
    """
    shape = jnp.shape(pixel_index)
    ctr = jnp.stack(
        [
            jnp.asarray(pixel_index, jnp.uint32),
            jnp.broadcast_to(jnp.asarray(frame_index, jnp.uint32), shape),
            jnp.broadcast_to(jnp.asarray(bounce, jnp.uint32), shape),
            jnp.broadcast_to(jnp.asarray(seed, jnp.uint32), shape),
        ],
        axis=-1,
    )
    bits = pcg4d(ctr)
    # 24-bit construction: the top 24 bits convert to f32 exactly, so the
    # result is uniform on [0, 1) with no rounding to 1.0 (a raw
    # u32 * 2^-32 rounds values >= 2^32-128 up to exactly 1.0, which can
    # push pixel jitter into the neighboring pixel).
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * _INV_U24


def bn_sample4(
    blue_noise: jnp.ndarray, px, py, frame_index, bounce, seed=0
) -> jnp.ndarray:
    """Blue-noise-seeded four-dimensional sample (the reference binds its
    blue-noise texture as the per-pixel low-discrepancy source for ALL
    shader sampling — rt_renderer.rs:1117-1156, static binding 5 at
    rt_renderer.rs:676-740; this is the JAX equivalent for every
    sampling dimension, not just primary jitter).

    Cranley-Patterson construction: the texture supplies the PER-PIXEL
    value (so estimation error is blue-distributed in screen space),
    while PCG4D supplies (a) a per-(frame, bounce, stream) global
    rotation shared by all pixels — each virtual frame sees a fresh
    uniform offset, keeping the progressive accumulation unbiased — and
    (b) a per-(bounce, stream) toroidal texture shift so distinct
    sampling dimensions read decorrelated regions of the texture.

    px/py are GLOBAL screen coordinates, so output stays independent of
    tiling/order/device count (the multi-chip bit-identity invariant).
    blue_noise: (H, W, 4) float32 in [0, 1).
    """
    bh, bw = blue_noise.shape[0], blue_noise.shape[1]
    ss = jnp.stack(
        [
            jnp.asarray(bounce, jnp.uint32),
            jnp.asarray(seed, jnp.uint32),
            jnp.uint32(0x9E3779B9),
            jnp.uint32(0x85EBCA6B),
        ],
        axis=-1,
    )
    hsh = pcg4d(ss)
    ox = (hsh[..., 0] % jnp.uint32(bw)).astype(jnp.int32)
    oy = (hsh[..., 1] % jnp.uint32(bh)).astype(jnp.int32)
    tx = (jnp.asarray(px, jnp.int32) + ox) % bw
    ty = (jnp.asarray(py, jnp.int32) + oy) % bh
    # single-index gather (multi-vector indexing lowers to a
    # multi-dim XLA gather; see ops/env.py)
    flat = blue_noise[:, :, :4].reshape(bh * bw, 4)
    texel = jnp.take(flat, ty * bw + tx, axis=0)
    # The rotation's pixel counter is fixed at 0 (shared by all pixels —
    # that is what makes it a Cranley-Patterson rotation), but
    # frame_index may be per-ray (spp>1 virtual frames), so broadcast
    # the zero counter to the common shape first.
    shape = jnp.broadcast_shapes(jnp.shape(px), jnp.shape(frame_index))
    rot = sample4(
        jnp.broadcast_to(jnp.uint32(0), shape), frame_index, bounce, seed
    )
    return (texel + rot) % 1.0
