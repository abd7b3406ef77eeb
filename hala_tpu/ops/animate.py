"""Device-side node retransform + cluster refit — the animation path.

The reference rewrites per-mesh object uniforms every frame, so node
transforms are a per-frame input (/root/reference/src/rz_renderer.rs:
38-53, 690-716) and the BLAS is refit for deforming geometry. Here
geometry is baked to world space at upload (SceneUploader), so moving a
node means applying the DELTA transform (new_world @ inv(cur_world)) to
that node's triangles on device: no host re-upload, no jit retrace (the
scene pytree keeps its shapes), and the cluster AABB tables +
packed blocks are rebuilt from the transformed soup in the same jit.

The slot layout (and therefore the SAH/Morton cluster partition) is
NOT rebuilt — exactly the hardware-BVH refit contract: topology stable,
quality degrades gracefully as objects move far from their original
neighborhood (a full re-upload restores it).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .cluster import TRI_CHUNK, refit_clusters, subchunk_aabb_row

# float32 products (the GPU default would round operands to TF32)
_HI = jax.lax.Precision.HIGHEST


@jax.jit
def retransform_geometry(geometry, deltas, normal_deltas):
    """Apply per-primitive delta transforms to the device geometry.

    deltas: (P, 4, 4) f32 — delta world matrix per flattened primitive
    id (geometry.tri_prim), identity for unmoved primitives.
    normal_deltas: (P, 3, 3) f32 — inverse-transpose of the delta's
    linear part (normal matrix).

    Returns a new DeviceGeometry with transformed soup, re-derived
    shade-table columns (corner/geometric normals, tangents, uv texel
    density — world area changes under scale), refit cluster AABBs and
    repacked blocks. Everything else (uvs, materials, slot order,
    static metadata) is untouched.
    """
    g = geometry
    pid = jnp.maximum(g.tri_prim, 0)
    M = jnp.take(deltas, pid, axis=0)           # (T, 4, 4)
    R = jnp.take(normal_deltas, pid, axis=0)    # (T, 3, 3)
    lin = M[:, :3, :3]
    v0 = (
        jnp.einsum("tij,tj->ti", lin, g.tri_v0, precision=_HI)
        + M[:, :3, 3]
    )
    e1 = jnp.einsum("tij,tj->ti", lin, g.tri_e1, precision=_HI)
    e2 = jnp.einsum("tij,tj->ti", lin, g.tri_e2, precision=_HI)

    def unit(a, axis=-1):
        return a / jnp.maximum(
            jnp.linalg.norm(a, axis=axis, keepdims=True), 1e-30
        )

    normals = unit(
        jnp.einsum("tij,tcj->tci", R, g.normals, precision=_HI)
    )
    tangents = jnp.einsum("tij,tcj->tci", lin, g.tangents, precision=_HI)
    ng = unit(jnp.cross(e1, e2))

    shade = g.shade_table
    if shade is not None:
        t = shade.shape[0]
        uv3 = g.uvs
        uv_area = 0.5 * jnp.abs(
            (uv3[:, 1, 0] - uv3[:, 0, 0]) * (uv3[:, 2, 1] - uv3[:, 0, 1])
            - (uv3[:, 1, 1] - uv3[:, 0, 1]) * (uv3[:, 2, 0] - uv3[:, 0, 0])
        )
        world_area = 0.5 * jnp.linalg.norm(jnp.cross(e1, e2), axis=1)
        shade = shade.at[:, 0:9].set(normals.reshape(t, 9))
        shade = shade.at[:, 15:18].set(ng)
        shade = shade.at[:, 20:29].set(tangents.reshape(t, 9))
        shade = shade.at[:, 29].set(
            jnp.sqrt(uv_area / jnp.maximum(world_area, 1e-12))
        )

    cluster_min, cluster_max = refit_clusters(v0, e1, e2, g.tri_mat)
    n_chunks = g.tri_packed.shape[0] if g.tri_packed is not None else 0
    tri_packed = g.tri_packed
    if tri_packed is not None:
        tri_packed = jnp.zeros_like(tri_packed)
        pack = lambda a: a.reshape(n_chunks, TRI_CHUNK, 3).transpose(0, 2, 1)
        tri_packed = tri_packed.at[:, 0:3].set(pack(v0))
        tri_packed = tri_packed.at[:, 3:6].set(pack(e1))
        tri_packed = tri_packed.at[:, 6:9].set(pack(e2))
        real = (g.tri_mat >= 0)[:, None]
        t_lo = jnp.minimum(jnp.minimum(v0, v0 + e1), v0 + e2)
        t_hi = jnp.maximum(jnp.maximum(v0, v0 + e1), v0 + e2)
        tri_packed = tri_packed.at[:, 9, :].set(
            subchunk_aabb_row(
                jnp.where(real, t_lo, jnp.inf),
                jnp.where(real, t_hi, -jnp.inf),
            )
        )

    return dataclasses.replace(
        g,
        tri_v0=v0, tri_e1=e1, tri_e2=e2,
        normals=normals, tangents=tangents,
        shade_table=shade,
        cluster_min=cluster_min, cluster_max=cluster_max,
        tri_packed=tri_packed,
    )


def build_deltas(prim_node, node_deltas, num_nodes):
    """Host-side: (P, 4, 4) delta + (P, 3, 3) normal-delta tables from a
    {node_index: delta 4x4} dict and the prim -> node map recorded at
    upload (DeviceScene.prim_node)."""
    import numpy as np

    p = max(len(prim_node), 1)
    deltas = np.tile(np.eye(4, dtype=np.float32), (p, 1, 1))
    ndeltas = np.tile(np.eye(3, dtype=np.float32), (p, 1, 1))
    for pi, ni in enumerate(prim_node):
        d = node_deltas.get(ni)
        if d is not None:
            deltas[pi] = d
            ndeltas[pi] = np.linalg.inv(d[:3, :3]).T
    return jnp.asarray(deltas), jnp.asarray(ndeltas)
