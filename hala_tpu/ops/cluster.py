"""Cluster tables of the uploaded triangle soup (plain XLA).

Triangles are ordered at upload so every TRI_CHUNK block of slots is a
spatially coherent *cluster* (ops/sahbuild.py, or Morton order for
small meshes). The tables here describe those clusters: per-cluster
AABBs, the packed (C, 16, TRI_CHUNK) geometry blocks and their 16-tri
sub-chunk AABB rows. Geometry sharding (parallel/scene_shard.py) splits
the scene at cluster-block boundaries, and animation (ops/animate.py)
refits the tables after a retransform; this module builds and refits
them on the device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

LANES = 128
TRI_CHUNK = 128                     # == scene/gpu TRI_PAD (block size)
# AABB granularity of the cluster tables (triangles per AABB).
SUB_CLUSTER = 128
# In-chunk granularity: each block carries 8 x 16-triangle sub-AABBs in
# tri_packed row 9 (lanes 0-47, [min.xyz|max.xyz] x 8).
PRETEST_TRIS = 16
PRETEST_PER_CHUNK = TRI_CHUNK // PRETEST_TRIS


def subchunk_aabb_row(t_min, t_max):
    """(T, 3) per-triangle slot AABBs -> (C, LANES) packed pretest row:
    lanes [s*6 : s*6+6] = [min.xyz | max.xyz] of 16-tri sub-chunk s.

    Padding slots must carry (+inf, -inf) bounds so they vanish from
    mixed sub-chunks; fully empty sub-chunks collapse to a far-away
    POINT box (min == max == 3e37), the same sentinel convention as the
    cluster AABB tables."""
    t = t_min.shape[0]
    n_chunks = t // TRI_CHUNK
    lo = t_min.reshape(n_chunks, PRETEST_PER_CHUNK, PRETEST_TRIS, 3).min(2)
    hi = t_max.reshape(n_chunks, PRETEST_PER_CHUNK, PRETEST_TRIS, 3).max(2)
    far = jnp.float32(3.0e37)
    empty = ~jnp.isfinite(lo[..., :1]) | ~jnp.isfinite(hi[..., :1])
    lo = jnp.where(empty, far, lo)
    hi = jnp.where(empty, far, hi)
    packed = jnp.concatenate([lo, hi], axis=-1)  # (C, 8, 6)
    row = jnp.zeros((n_chunks, LANES), t_min.dtype)
    return row.at[:, : PRETEST_PER_CHUNK * 6].set(
        packed.reshape(n_chunks, PRETEST_PER_CHUNK * 6)
    )


@partial(jax.jit, static_argnames=("num_real",))
def build_cluster_tables_device(tri_v0, tri_e1, tri_e2, num_real: int):
    """On-device acceleration-structure (re)build — the LBVH-build role
    (BASELINE config[4], SURVEY.md section 7 stage 4) as device compute:
    Morton codes -> jax.lax.sort ->
    permuted triangle soup -> reshape-reduce cluster AABBs -> packed
    blocks. Everything jit-compiled, so dynamic/animated geometry
    can rebuild per frame without host round trips.

    Inputs are TRI_PAD-padded (T, 3) arrays; `num_real` marks the valid
    prefix. Returns (order, tri_v0, tri_e1, tri_e2, cluster_min,
    cluster_max, tri_packed) with the same conventions as the host
    uploader (padding sorts to the end because its Morton key is forced
    to the maximum).
    """
    from .morton import morton3d

    t = tri_v0.shape[0]
    centroid = tri_v0 + (tri_e1 + tri_e2) / 3.0
    real = jnp.arange(t) < num_real
    finite_centroid = jnp.where(real[:, None], centroid, 0.0)
    cmin = jnp.min(jnp.where(real[:, None], centroid, jnp.inf), axis=0)
    cmax = jnp.max(jnp.where(real[:, None], centroid, -jnp.inf), axis=0)
    codes = morton3d(finite_centroid, cmin, cmax)
    codes = jnp.where(real, codes, jnp.uint32(0xFFFFFFFF))
    order = jnp.argsort(codes).astype(jnp.int32)

    v0 = jnp.take(tri_v0, order, axis=0)
    e1 = jnp.take(tri_e1, order, axis=0)
    e2 = jnp.take(tri_e2, order, axis=0)

    real_s = jnp.take(real, order)
    t_min = jnp.minimum(jnp.minimum(v0, v0 + e1), v0 + e2)
    t_max = jnp.maximum(jnp.maximum(v0, v0 + e1), v0 + e2)
    far = jnp.float32(3.0e37)
    t_min = jnp.where(real_s[:, None], t_min, far)
    t_max = jnp.where(real_s[:, None], t_max, far)
    n_sub = t // SUB_CLUSTER
    cluster_min = t_min.reshape(n_sub, SUB_CLUSTER, 3).min(axis=1)
    cluster_max = t_max.reshape(n_sub, SUB_CLUSTER, 3).max(axis=1)

    n_chunks = t // TRI_CHUNK
    tri_packed = jnp.concatenate(
        [v0, e1, e2, jnp.zeros((t, 7), v0.dtype)], axis=1
    ).reshape(n_chunks, TRI_CHUNK, 16).transpose(0, 2, 1)
    pre_min = jnp.where(real_s[:, None], t_min, jnp.inf)
    pre_max = jnp.where(real_s[:, None], t_max, -jnp.inf)
    tri_packed = tri_packed.at[:, 9, :].set(
        subchunk_aabb_row(pre_min, pre_max)
    )
    return order, v0, e1, e2, cluster_min, cluster_max, tri_packed


@jax.jit
def refit_clusters(tri_v0, tri_e1, tri_e2, tri_mat):
    """AABB refit without re-sorting (deforming geometry with stable
    topology — the BLAS-refit role). Padding (tri_mat < 0) is excluded."""
    real = tri_mat >= 0
    t_min = jnp.minimum(jnp.minimum(tri_v0, tri_v0 + tri_e1), tri_v0 + tri_e2)
    t_max = jnp.maximum(jnp.maximum(tri_v0, tri_v0 + tri_e1), tri_v0 + tri_e2)
    far = jnp.float32(3.0e37)
    t_min = jnp.where(real[:, None], t_min, far)
    t_max = jnp.where(real[:, None], t_max, far)
    n_sub = tri_v0.shape[0] // SUB_CLUSTER
    return (
        t_min.reshape(n_sub, SUB_CLUSTER, 3).min(axis=1),
        t_max.reshape(n_sub, SUB_CLUSTER, 3).max(axis=1),
    )
