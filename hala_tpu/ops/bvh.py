"""BVH build + stackless traversal in plain XLA.

Replaces the reference's hardware acceleration structures
(gpu_uploader.rs:774-967: BLAS per primitive + TLAS over instances). The
device representation is a flat SoA node table in DFS pre-order with
*skip links* (ropes): on an AABB hit the ray descends to `node+1`, on a
miss it jumps to `skip[node]`. That makes traversal a single
`lax.while_loop` with one node pointer per ray — no per-ray stack
(SURVEY.md section 7 hard-part #3).

Round-1 build is a host-side median-split builder (numpy, iterative);
the on-device Morton/LBVH build (BASELINE config[4]) replaces the build
step later without touching the traversal contract.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .intersect import T_MAX, Hit

LEAF_SIZE = 4


def _register(cls, meta_fields=()):
    data_fields = tuple(
        f.name for f in dataclasses.fields(cls) if f.name not in meta_fields
    )
    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=tuple(meta_fields)
    )
    return cls


@partial(_register, meta_fields=("num_nodes",))
@dataclasses.dataclass
class BVH:
    """Flat skip-link BVH over the DeviceGeometry triangle soup."""

    node_min: jax.Array    # (M, 3) f32
    node_max: jax.Array    # (M, 3) f32
    skip: jax.Array        # (M,) i32 — next node on miss / after leaf
    first_tri: jax.Array   # (M,) i32 — index into tri_order, -1 = internal
    tri_count: jax.Array   # (M,) i32
    tri_order: jax.Array   # (T_pad,) i32 — leaf-contiguous triangle ids
    num_nodes: int = 0


def build_bvh(geometry) -> BVH:
    """Median-split build on the host over world-space triangles.

    Selects real triangles by mask (padding slots may be interior under
    the SAH cluster layout, see ops/sahbuild.py); `tri_order` carries
    device-slot indices so leaf gathers hit the right geometry rows."""
    slot = np.nonzero(np.asarray(geometry.tri_mat) >= 0)[0].astype(np.int32)
    v0 = np.asarray(geometry.tri_v0)[slot]
    e1 = np.asarray(geometry.tri_e1)[slot]
    e2 = np.asarray(geometry.tri_e2)[slot]
    n = v0.shape[0]
    v1, v2 = v0 + e1, v0 + e2
    tmin = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tmax = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    centroid = (tmin + tmax) * 0.5

    order = np.arange(n, dtype=np.int32)
    # Each stack entry: (start, end) range in `order`; emit DFS pre-order.
    node_min, node_max, first, count, parent_end = [], [], [], [], []
    # parent_end tracks subtree extent to fix skip pointers after build.
    stack = [(0, n)]
    spans = []  # (start,end) per node, for skip computation
    while stack:
        start, end = stack.pop()
        ids = order[start:end]
        bmin = tmin[ids].min(axis=0)
        bmax = tmax[ids].max(axis=0)
        node_min.append(bmin)
        node_max.append(bmax)
        spans.append((start, end))
        if end - start <= LEAF_SIZE:
            first.append(start)
            count.append(end - start)
            continue
        first.append(-1)
        count.append(0)
        c = centroid[ids]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        mid = (end - start) // 2
        part = np.argpartition(c[:, axis], mid)
        order[start:end] = ids[part]
        # Push right child first so left is processed next (pre-order).
        stack.append((start + mid, end))
        stack.append((start, start + mid))

    m = len(node_min)
    node_min = np.stack(node_min)
    node_max = np.stack(node_max)
    first = np.array(first, np.int32)
    count = np.array(count, np.int32)

    # skip[i] = first node after i's subtree. Pre-order emission means
    # the subtree of i occupies the contiguous block [i, i + size_i), so
    # skip = i + size. Sizes via span-containment scan (a node's span is a
    # strict sub-range of every ancestor's span).
    sizes = np.ones(m, np.int64)
    stack2: list[int] = []
    for i in range(m):
        s, e = spans[i]
        while stack2 and not (
            spans[stack2[-1]][0] <= s and e <= spans[stack2[-1]][1]
        ):
            stack2.pop()
        for anc in stack2:
            sizes[anc] += 1
        stack2.append(i)
    skip = (np.arange(m) + sizes).astype(np.int32)

    # Map to device slots; pad so leaf gathers of LEAF_SIZE never go
    # out of bounds.
    order_pad = np.concatenate([slot[order], np.zeros(LEAF_SIZE, np.int32)])
    return BVH(
        node_min=jnp.asarray(node_min),
        node_max=jnp.asarray(node_max),
        skip=jnp.asarray(skip),
        first_tri=jnp.asarray(first),
        tri_count=jnp.asarray(count),
        tri_order=jnp.asarray(order_pad.astype(np.int32)),
        num_nodes=m,
    )


def _ray_aabb(o, inv_d, bmin, bmax, t_best):
    """Slab test. All (N, 3) / (N,). Returns hit mask (N,)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tnear = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tfar = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return (tnear <= tfar) & (tfar > 0.0) & (tnear < t_best)


def _leaf_intersect(o, d, bvh, geometry, first, count, best: Hit, t_limit=None):
    """Intersect up to LEAF_SIZE triangles of a leaf per ray."""
    t_best, tri_best, u_best, v_best = best
    for k in range(LEAF_SIZE):
        slot = first + k
        tid = jnp.take(bvh.tri_order, slot)
        valid = k < count
        tv0 = jnp.take(geometry.tri_v0, tid, axis=0)
        te1 = jnp.take(geometry.tri_e1, tid, axis=0)
        te2 = jnp.take(geometry.tri_e2, tid, axis=0)
        # Inline single-triangle Moller-Trumbore (N,)
        pvec = jnp.cross(d, te2)
        det = jnp.sum(pvec * te1, axis=-1)
        inv_det = jnp.where(jnp.abs(det) > 1e-7, 1.0 / det, 0.0)
        tvec = o - tv0
        u = jnp.sum(tvec * pvec, axis=-1) * inv_det
        qvec = jnp.cross(tvec, te1)
        v = jnp.sum(qvec * d, axis=-1) * inv_det
        t = jnp.sum(qvec * te2, axis=-1) * inv_det
        ok = (
            valid
            & (jnp.abs(det) > 1e-7)
            & (u >= 0)
            & (v >= 0)
            & (u + v <= 1)
            & (t > 1e-4)
            & (t < t_best)
        )
        t_best = jnp.where(ok, t, t_best)
        tri_best = jnp.where(ok, tid, tri_best)
        u_best = jnp.where(ok, u, u_best)
        v_best = jnp.where(ok, v, v_best)
    return Hit(t=t_best, tri=tri_best, u=u_best, v=v_best)


def intersect_bvh(bvh: BVH, geometry, o, d, t_max=None) -> Hit:
    """Closest hit via skip-link traversal (one while_loop, no stack)."""
    from .intersect import varying_like

    n = o.shape[0]
    m = bvh.num_nodes
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, jnp.float32(1e-12), d)
    zeros = varying_like(o[:, 0], 0.0)
    t0 = zeros + (T_MAX if t_max is None else t_max)
    init = (
        varying_like(zeros, 0, jnp.int32),  # node ptr
        Hit(
            t=t0,
            tri=varying_like(zeros, -1, jnp.int32),
            u=zeros,
            v=zeros,
        ),
    )

    def cond(state):
        ptr, _ = state
        return jnp.any(ptr < m)

    def body(state):
        ptr, best = state
        p = jnp.minimum(ptr, m - 1)
        bmin = jnp.take(bvh.node_min, p, axis=0)
        bmax = jnp.take(bvh.node_max, p, axis=0)
        first = jnp.take(bvh.first_tri, p)
        count = jnp.take(bvh.tri_count, p)
        skip = jnp.take(bvh.skip, p)
        active = ptr < m
        box_hit = _ray_aabb(o, inv_d, bmin, bmax, best.t) & active
        is_leaf = first >= 0
        do_leaf = box_hit & is_leaf
        leaf_best = _leaf_intersect(
            o, d, bvh, geometry, jnp.maximum(first, 0),
            jnp.where(do_leaf, count, 0), best,
        )
        # Descend on internal hit, otherwise take the skip link.
        nxt = jnp.where(box_hit & ~is_leaf, ptr + 1, skip)
        nxt = jnp.where(active, nxt, ptr)
        return nxt, leaf_best

    _, best = jax.lax.while_loop(cond, body, init)
    return best


def occluded_bvh(bvh: BVH, geometry, o, d, t_far) -> jnp.ndarray:
    """Any-hit query: True where a triangle lies in (eps, t_far)."""
    hit = intersect_bvh(bvh, geometry, o, d, t_max=t_far)
    return hit.tri >= 0
