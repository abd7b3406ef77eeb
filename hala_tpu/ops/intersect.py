"""Ray-primitive intersection kernels.

Replaces the reference's hardware `trace_rays` + TLAS traversal
(rt_renderer.rs:458-464, gpu_uploader.rs:774-967). Two paths:

* `intersect_bruteforce` — scan over triangle chunks keeping the best
  hit per ray. This is the "flat BVH" of BASELINE config[0] and the
  ground truth the BVH traversal is validated against.
* BVH traversal lives in ops/bvh.py.

Also analytic ray-vs-light intersection: the reference routes light hits
through a separate procedural-AABB hit group (SBT record offset 1,
gpu_uploader.rs:877-885); here quad and sphere lights are intersected
analytically so emissive lights are visible to BSDF rays (needed for MIS).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

T_MAX = jnp.float32(3.0e38)
EPS = jnp.float32(1.0e-7)


class Hit(NamedTuple):
    """Best hit per ray (SoA)."""

    t: jnp.ndarray        # (N,) f32, T_MAX if miss
    tri: jnp.ndarray      # (N,) i32 triangle index, -1 if miss
    u: jnp.ndarray        # (N,) f32 barycentric
    v: jnp.ndarray        # (N,) f32 barycentric


def varying_like(ref: jnp.ndarray, value, dtype=None) -> jnp.ndarray:
    """Constant-valued array derived from `ref` so loop-carry inits carry
    ref's varying-manual-axes type under shard_map (a fresh jnp constant
    would be 'replicated' and trip jax's vma check when the loop body
    mixes it with per-shard data)."""
    out = ref * 0 + value
    return out.astype(dtype) if dtype is not None else out


def out_struct(shape, dtype, like) -> jax.ShapeDtypeStruct:
    """ShapeDtypeStruct for a pallas_call output that inherits `like`'s
    varying-manual-axes set, so kernels work inside shard_map (jax's
    check_vma requires outputs to declare how they vary over mesh
    axes; outside shard_map the vma set is empty and this is a no-op)."""
    vma = getattr(jax.typeof(like), "vma", None)
    if vma:
        return jax.ShapeDtypeStruct(shape, dtype, vma=vma)
    return jax.ShapeDtypeStruct(shape, dtype)


def canonical_hit(o, d, tri_v0, tri_e1, tri_e2, hit: Hit) -> Hit:
    """Re-evaluate (t, u, v) for each ray's winning triangle with the
    canonical XLA Moller-Trumbore (same formulas as `ray_triangle`, so
    canonical results match the brute-force ground truth bit-for-bit).

    A kernel that keeps its running t in registers rounds differently
    from the XLA scan (fused multiply-adds, another division).
    Canonicalizing the winner makes the reported bits a pure function of
    (ray, winning triangle), so results do not depend on the engine or
    on how rays are batched across devices. Winner identity itself can
    still flip on exact cross-engine ties — measure-zero in practice.
    """
    tid = jnp.maximum(hit.tri, 0)
    v0 = jnp.take(tri_v0, tid, axis=0)
    e1 = jnp.take(tri_e1, tid, axis=0)
    e2 = jnp.take(tri_e2, tid, axis=0)
    pvec = jnp.cross(d, e2)
    det = jnp.sum(pvec * e1, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > EPS, 1.0 / det, 0.0)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(qvec * d, axis=-1) * inv_det
    t = jnp.sum(qvec * e2, axis=-1) * inv_det
    ok = hit.tri >= 0
    return Hit(
        t=jnp.where(ok, t, hit.t),
        tri=hit.tri,
        u=jnp.where(ok, u, hit.u),
        v=jnp.where(ok, v, hit.v),
    )


def ray_triangle(o, d, v0, e1, e2, t_min=1e-4):
    """Moller-Trumbore. o,d: (N,3); v0,e1,e2: (C,3). Returns (t, u, v)
    with t = inf on miss, all shaped (N, C)."""
    # pvec = d x e2 : (N, C, 3)
    pvec = jnp.cross(d[:, None, :], e2[None, :, :])
    det = jnp.sum(pvec * e1[None, :, :], axis=-1)  # (N, C)
    inv_det = jnp.where(jnp.abs(det) > EPS, 1.0 / det, 0.0)
    tvec = o[:, None, :] - v0[None, :, :]
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1[None, :, :])
    v = jnp.sum(qvec * d[:, None, :], axis=-1) * inv_det
    t = jnp.sum(qvec * e2[None, :, :], axis=-1) * inv_det
    valid = (
        (jnp.abs(det) > EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
    )
    return jnp.where(valid, t, T_MAX), u, v


def intersect_bruteforce(
    o: jnp.ndarray,
    d: jnp.ndarray,
    tri_v0: jnp.ndarray,
    tri_e1: jnp.ndarray,
    tri_e2: jnp.ndarray,
    t_max=None,
    chunk: int = 2048,
) -> Hit:
    """Closest-hit over all triangles, scanning chunks of `chunk` tris.

    The scan keeps peak memory at N x chunk while XLA fuses the
    triangle-test elementwise chain into the reduction.
    """
    n = o.shape[0]
    num_tris = tri_v0.shape[0]
    # Geometry is only padded to TRI_PAD (128); pick the largest chunk
    # that divides the buffer rather than asserting (gcd keeps it a
    # multiple of the pad granularity for typical pow2 chunks).
    chunk = math.gcd(min(chunk, num_tris), num_tris)
    zeros = varying_like(o[:, 0], 0.0)
    t_best = zeros + (T_MAX if t_max is None else t_max)
    init = Hit(
        t=t_best,
        tri=varying_like(zeros, -1, jnp.int32),
        u=zeros,
        v=zeros,
    )

    def body(carry: Hit, idx):
        start = idx * chunk
        v0 = jax.lax.dynamic_slice_in_dim(tri_v0, start, chunk)
        e1 = jax.lax.dynamic_slice_in_dim(tri_e1, start, chunk)
        e2 = jax.lax.dynamic_slice_in_dim(tri_e2, start, chunk)
        t, u, v = ray_triangle(o, d, v0, e1, e2)
        t_min = jnp.min(t, axis=1)
        arg = jnp.argmin(t, axis=1)
        better = t_min < carry.t
        rows = jnp.arange(n)
        return Hit(
            t=jnp.where(better, t_min, carry.t),
            tri=jnp.where(better, (start + arg).astype(jnp.int32), carry.tri),
            u=jnp.where(better, u[rows, arg], carry.u),
            v=jnp.where(better, v[rows, arg], carry.v),
        ), None

    out, _ = jax.lax.scan(body, init, jnp.arange(num_tris // chunk))
    return out


def occluded_bruteforce(
    o, d, t_far, tri_v0, tri_e1, tri_e2, chunk: int = 2048
) -> jnp.ndarray:
    """Any-hit shadow query: True where a triangle lies in the open
    interval (t_min, t_far) — the same bound as a closest-hit query with
    t_max = t_far, so either form answers a shadow ray alike."""
    num_tris = tri_v0.shape[0]
    chunk = math.gcd(min(chunk, num_tris), num_tris)

    def body(blocked, idx):
        start = idx * chunk
        v0 = jax.lax.dynamic_slice_in_dim(tri_v0, start, chunk)
        e1 = jax.lax.dynamic_slice_in_dim(tri_e1, start, chunk)
        e2 = jax.lax.dynamic_slice_in_dim(tri_e2, start, chunk)
        t, _, _ = ray_triangle(o, d, v0, e1, e2)
        hit_any = jnp.any(t < t_far[:, None], axis=1)
        return blocked | hit_any, None

    blocked, _ = jax.lax.scan(
        body, varying_like(o[:, 0], 0.0) > 1.0, jnp.arange(num_tris // chunk)
    )
    return blocked


def ray_sphere(o, d, center, radius, t_min=1e-4):
    """Ray-sphere: o,d (N,3); center (L,3); radius (L,). -> t (N,L)."""
    oc = o[:, None, :] - center[None, :, :]
    b = jnp.sum(oc * d[:, None, :], axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - radius[None, :] ** 2
    disc = b * b - c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = jnp.where(t0 > t_min, t0, t1)
    valid = (disc > 0.0) & (t > t_min)
    return jnp.where(valid, t, T_MAX)


def ray_quad(o, d, corner, edge_u, edge_v, t_min=1e-4):
    """Ray-parallelogram: corner + a*edge_u + b*edge_v, a,b in [0,1].

    corner/edge_u/edge_v: (L,3). Returns t (N,L), T_MAX on miss.
    Matches the quad-light record layout of gpu_uploader.rs:225-247.
    """
    n = jnp.cross(edge_u, edge_v)  # (L,3), unnormalized
    denom = jnp.sum(d[:, None, :] * n[None, :, :], axis=-1)
    safe = jnp.abs(denom) > EPS
    t = (
        jnp.sum((corner[None, :, :] - o[:, None, :]) * n[None, :, :], axis=-1)
        / jnp.where(safe, denom, 1.0)
    )
    p = o[:, None, :] + t[..., None] * d[:, None, :] - corner[None, :, :]
    uu = jnp.sum(edge_u * edge_u, axis=-1)[None, :]
    vv = jnp.sum(edge_v * edge_v, axis=-1)[None, :]
    a = jnp.sum(p * edge_u[None, :, :], axis=-1) / jnp.maximum(uu, EPS)
    b = jnp.sum(p * edge_v[None, :, :], axis=-1) / jnp.maximum(vv, EPS)
    valid = safe & (t > t_min) & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
    return jnp.where(valid, t, T_MAX)
