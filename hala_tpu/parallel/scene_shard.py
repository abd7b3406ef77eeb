"""Geometry-sharded (tensor-parallel) rendering over the device mesh.

Film tiling (tiling.py) replicates the scene; this module shards it:
each device owns 1/n of the SAH cluster blocks (traversal tables,
packed geometry, shade rows) AND 1/n of the film rows, over the SAME
1-D mesh axis — the fully-sharded layout. Per visibility query the
integrator all-gathers the rays over the axis, intersects its local
cluster shard, and merges the per-shard hits with a lexicographic
(t, tri) min (integrator._intersect); winner shade rows come back
through one owner-masked psum per bounce (integrator._rows_sharded).
Because the merge ranks per-shard hits by the engine's own t and the
min over a partition of the triangle set IS the global min, every ray
finds the single-device winner, and rows come back bit-exact. The
shading around the queries is a different XLA program, though: on the
test scenes the render is bit-identical to the single-device one
(tests/test_scene_shard.py); on atrium_big at 1080p last-bit drift in
the shading flips a few stochastic decisions (chip_smoke.py --four
states the bound).

This is the scaling-book tensor-parallel recipe applied to rendering:
shard the big axis (triangles), replicate the small tables (materials/
lights/textures/cameras), let collectives (all_gather + pmin/psum) ride
the interconnect (NVLink between the cards of one host). It lifts the
one-card memory ceiling on scene size — the role of the reference's
single-GPU bindless storage buffers (rz_renderer.rs:189-206) at
multi-accelerator scale, which the reference has no analog for
(SURVEY.md §2.11: no multi-GPU path exists upstream).

Animation note: ops/animate.py retransforms the UNsharded scene
(normals/tangents/uvs/tri_prim stay replicated, but the sharded
traversal arrays would need re-slicing); re-shard after update_scene
rather than animating shards in place.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..models.integrator import RenderSettings, Uniforms
from ..scene.gpu.scene import TRI_PAD
from .tiling import AXIS, TiledFilm

# DeviceGeometry fields sharded along axis 0. Cluster tables split by
# cluster blocks; slot arrays (leading dim C*TRI_PAD) split in the same
# cluster-block order, so a shard's local slot ids are contiguous and
# global id = local id + shard * local_slots. normals/tangents/uvs/
# tri_prim serve only the host-side animation path and stay replicated.
_SHARDED_FIELDS = (
    "cluster_min", "cluster_max", "tri_packed",
    "tri_v0", "tri_e1", "tri_e2", "shade_table", "tri_mat",
)


def pad_scene_for_sharding(scene, n: int):
    """Pad the cluster count to a multiple of `n` (empty far-point
    clusters, degenerate slots, material -1) so cluster blocks split
    evenly. Padding is appended, so every real triangle keeps its
    global slot id. Returns a new DeviceScene (or the input unchanged
    when it already divides)."""
    g = scene.geometry
    assert g.tri_packed is not None, (
        "geometry sharding needs the cluster layout (tri_packed); "
        "small prefix-layout scenes have nothing worth sharding"
    )
    c = g.tri_packed.shape[0]
    cpad = -(-c // n) * n
    if cpad == c:
        return scene
    dc = cpad - c
    ds = dc * TRI_PAD
    far = jnp.float32(3.0e37)  # uploader's empty-cluster point box

    def pad0(a, rows, fill):
        return jnp.concatenate(
            [a, jnp.full((rows,) + a.shape[1:], fill, a.dtype)], axis=0
        )

    @jax.jit
    def _pad(gg):
        return dataclasses.replace(
            gg,
            cluster_min=pad0(gg.cluster_min, dc, far),
            cluster_max=pad0(gg.cluster_max, dc, far),
            tri_packed=pad0(gg.tri_packed, dc, 0.0),
            tri_v0=pad0(gg.tri_v0, ds, 0.0),
            tri_e1=pad0(gg.tri_e1, ds, 0.0),
            tri_e2=pad0(gg.tri_e2, ds, 0.0),
            shade_table=pad0(gg.shade_table, ds, 0.0),
            tri_mat=pad0(gg.tri_mat, ds, -1),
        )

    return dataclasses.replace(scene, geometry=_pad(g))


def scene_shard_specs(scene):
    """PartitionSpec pytree for `scene`: geometry's cluster/slot arrays
    over AXIS, every other leaf replicated."""
    spec = jax.tree.map(lambda _: P(), scene)
    gspec = {
        f.name: getattr(spec.geometry, f.name)
        for f in dataclasses.fields(spec.geometry)
        if f.name not in _SHARDED_FIELDS
    }
    for name in _SHARDED_FIELDS:
        arr = getattr(scene.geometry, name)
        gspec[name] = P(AXIS, *([None] * (arr.ndim - 1)))
    return dataclasses.replace(
        spec, geometry=dataclasses.replace(spec.geometry, **gspec)
    )


def shard_scene(scene, mesh):
    """Pad + device_put the scene so each device physically holds only
    its geometry shard (replicated leaves go everywhere)."""
    n = mesh.devices.size
    scene = pad_scene_for_sharding(scene, n)
    specs = scene_shard_specs(scene)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        scene, specs,
    ), specs


def render_frame_scene_sharded(
    scene,
    env,
    uniforms: Uniforms,
    tiled: TiledFilm,
    frame_index,
    settings: RenderSettings,
    specs=None,
):
    """One progressive frame with BOTH the film rows and the geometry
    sharded over the mesh axis. `scene` must be padded for the mesh
    size (use shard_scene); pass its `specs` to skip recomputing them.
    Returns (TiledFilm, total rays)."""
    from .tiling import _sharded_frame

    spec_scene = specs if specs is not None else scene_shard_specs(scene)
    return _sharded_frame(
        scene, env, uniforms, tiled, frame_index, settings,
        spec_scene=spec_scene, scene_axis=AXIS,
    )
