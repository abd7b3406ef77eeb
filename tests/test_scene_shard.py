"""Geometry-sharded (tensor-parallel) rendering on the 8-device CPU
mesh: film rows AND cluster blocks sharded over the same axis, rays
all-gathered per query, hits merged by lexicographic (t, tri) min —
must be BIT-identical to the single-device render (the min over a
partition of the triangle set is the global min; shade rows come back
through an owner-masked psum). parallel/scene_shard.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from hala_tpu.models.integrator import (
    Film,
    RenderSettings,
    Uniforms,
    render_frame,
)
from hala_tpu.parallel.scene_shard import (
    pad_scene_for_sharding,
    render_frame_scene_sharded,
    scene_shard_specs,
    shard_scene,
)
from hala_tpu.parallel.tiling import AXIS, TiledFilm, make_mesh


def _run_sharded_pair(scene_dev, settings, env=None, frames=2):
    """Render single-device (unsharded scene) and 8-device fully
    sharded; return films + ray totals."""
    w, h = settings.width, settings.height
    uniforms = Uniforms.default()
    film = Film.create(w, h)
    for f in range(frames):
        film, rays_s = render_frame(
            scene_dev, env, uniforms, film, f, settings
        )

    mesh = make_mesh()
    sharded, specs = shard_scene(scene_dev, mesh)
    tiled = TiledFilm.create(mesh, w, h)
    for f in range(frames):
        tiled, rays_m = render_frame_scene_sharded(
            sharded, env, uniforms, tiled, f, settings, specs=specs
        )
    return film, tiled.gather(), float(rays_s), float(rays_m)


def test_padding_appends_inert_clusters(cornell_device_scene):
    g = cornell_device_scene.geometry
    padded = pad_scene_for_sharding(cornell_device_scene, 8)
    pg = padded.geometry
    assert pg.tri_packed.shape[0] % 8 == 0
    # real prefix untouched (global slot ids preserved)
    np.testing.assert_array_equal(
        np.asarray(pg.tri_v0[: g.tri_v0.shape[0]]), np.asarray(g.tri_v0)
    )
    assert int(pg.tri_mat[g.tri_mat.shape[0]:].max()) == -1


def test_specs_mark_geometry_only(cornell_device_scene):
    padded = pad_scene_for_sharding(cornell_device_scene, 8)
    specs = scene_shard_specs(padded)
    assert AXIS in specs.geometry.tri_packed
    assert AXIS in specs.geometry.shade_table
    assert specs.geometry.normals == jax.sharding.PartitionSpec()
    assert specs.materials.base_color == jax.sharding.PartitionSpec()


def test_scene_sharded_matches_single(cornell_device_scene):
    """Cornell (1 real cluster + 7 padding shards): NEE shadows, quad
    light, full bounce loop — sharded film must equal single-device
    bits, including the ray statistic."""
    size = 32
    settings = RenderSettings(
        width=size, height=size, max_depth=3, rr_depth=2,
        tile_size=size * size // 8,
    )
    film, gathered, rays_s, rays_m = _run_sharded_pair(
        cornell_device_scene, settings
    )
    np.testing.assert_array_equal(
        np.asarray(film.accum), np.asarray(gathered.accum)
    )
    np.testing.assert_array_equal(
        np.asarray(film.normal), np.asarray(gathered.normal)
    )
    assert rays_s == rays_m


def test_scene_sharded_alpha_shadows():
    """Half-transparent blocker: the multi-blocker stochastic shadow
    loop re-enters the sharded _intersect with per-lane t_max and
    fetches blocker opacity through the sharded tri_mat — all of it
    must still reproduce the single-device bits."""
    import numpy as _np

    from hala_tpu.scene.cpu.material import Material, MaterialType
    from hala_tpu.scene.loader.uploader import SceneUploader
    from hala_tpu.scene.procedural import cornell_box

    pane = Material(
        type=MaterialType.DIFFUSE,
        base_color=_np.ones(3, _np.float32),
        opacity=0.5,
    )
    scene = SceneUploader.upload(
        cornell_box(tall_box_material=pane), use_ray_tracing=False
    )
    assert scene.materials.has_alpha
    size = 32
    settings = RenderSettings(
        width=size, height=size, max_depth=3, rr_depth=2,
        tile_size=size * size // 8,
    )
    film, gathered, rays_s, rays_m = _run_sharded_pair(scene, settings)
    np.testing.assert_array_equal(
        np.asarray(film.accum), np.asarray(gathered.accum)
    )
    assert rays_s == rays_m


def test_scene_sharded_multicluster():
    """sponza_like (several real clusters, every shard holds real
    geometry): the cross-shard (t, tri) merge and the owner-masked
    shade-row psum must reproduce the single-device bits."""
    from hala_tpu.scene.loader.uploader import SceneUploader
    from hala_tpu.scene.procedural import sponza_like

    scene = SceneUploader.upload(
        sponza_like(rooms=(2, 2), columns_per_room=4, boxes_per_room=2),
        use_ray_tracing=False,
    )
    size = 32
    settings = RenderSettings(
        width=size, height=size, max_depth=3, rr_depth=2,
        tile_size=size * size // 8,
    )
    film, gathered, rays_s, rays_m = _run_sharded_pair(scene, settings)
    np.testing.assert_array_equal(
        np.asarray(film.accum), np.asarray(gathered.accum)
    )
    assert rays_s == rays_m
    # the render actually saw geometry (not an all-sky film)
    assert float(np.asarray(gathered.accum).mean()) > 0.01


def test_scene_sharded_pallas_engine():
    """The TP merge composed with the Pallas intersect kernel (the
    engine "auto" picks on a GPU) in interpret mode — not just the CPU
    brute force — must still reproduce the single-device bits.
    Exercises the sharded _intersect's (t, tri) merge over per-shard
    kernel queries that scan every local slot."""
    from hala_tpu.scene.loader.uploader import SceneUploader
    from hala_tpu.scene.procedural import sponza_like

    scene = SceneUploader.upload(
        sponza_like(rooms=(2, 2), columns_per_room=4, boxes_per_room=2),
        use_ray_tracing=False,
    )
    size = 16
    settings = RenderSettings(
        width=size, height=size, max_depth=2, rr_depth=2,
        tile_size=size * size,
        intersector="pallas", interpret_pallas=True,
    )
    film, gathered, rays_s, rays_m = _run_sharded_pair(
        scene, settings, frames=1
    )
    np.testing.assert_array_equal(
        np.asarray(film.accum), np.asarray(gathered.accum)
    )
    assert rays_s == rays_m
    assert float(np.asarray(gathered.accum).mean()) > 0.01
