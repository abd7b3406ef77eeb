"""Multi-chip film tiling on the 8-device CPU mesh: sharded render must
be bit-identical to single-device (fixed per-tile ownership, SURVEY.md
section 7 hard-part #6)."""

import jax
import numpy as np

from hala_tpu.models.integrator import (
    Film,
    RenderSettings,
    Uniforms,
    render_frame,
)
from hala_tpu.parallel.tiling import (
    TiledFilm,
    make_mesh,
    render_frame_multichip,
)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_matches_single(cornell_device_scene):
    size = 32
    settings = RenderSettings(
        width=size, height=size, max_depth=3, rr_depth=2,
        tile_size=size * size // 8,
    )
    uniforms = Uniforms.default()

    # single device
    film = Film.create(size, size)
    for f in range(2):
        film, rays_single = render_frame(
            cornell_device_scene, None, uniforms, film, f, settings
        )

    # 8-device mesh, film sharded by rows
    mesh = make_mesh()
    tiled = TiledFilm.create(mesh, size, size)
    for f in range(2):
        tiled, rays_multi = render_frame_multichip(
            cornell_device_scene, None, uniforms, tiled, f, settings
        )

    gathered = tiled.gather()
    np.testing.assert_array_equal(
        np.asarray(film.accum), np.asarray(gathered.accum)
    )
    np.testing.assert_array_equal(
        np.asarray(film.normal), np.asarray(gathered.normal)
    )
    assert float(rays_single) == float(rays_multi)


def _run_pair(scene_dev, settings, env=None, frames=2, width=None,
              height=None):
    """Render single-device and 8-device sharded; return both films."""
    w = width or settings.width
    h = height or settings.height
    uniforms = Uniforms.default()
    film = Film.create(w, h)
    for f in range(frames):
        film, rays_s = render_frame(scene_dev, env, uniforms, film, f, settings)
    mesh = make_mesh()
    tiled = TiledFilm.create(mesh, w, h)
    for f in range(frames):
        tiled, rays_m = render_frame_multichip(
            scene_dev, env, uniforms, tiled, f, settings
        )
    return film, tiled.gather(), float(rays_s), float(rays_m)


def _assert_identical(film, gathered, rays_s, rays_m):
    np.testing.assert_array_equal(
        np.asarray(film.accum), np.asarray(gathered.accum)
    )
    np.testing.assert_array_equal(
        np.asarray(film.albedo), np.asarray(gathered.albedo)
    )
    np.testing.assert_array_equal(
        np.asarray(film.normal), np.asarray(gathered.normal)
    )
    assert rays_s == rays_m


def test_sharded_with_envmap(cornell_device_scene):
    """EnvMap pytree replicated through shard_map: CDF importance
    sampling + MIS must stay bit-identical under film tiling."""
    from hala_tpu.envmap import EnvMap
    from hala_tpu.models.integrator import ENV_MAP

    rs = np.random.RandomState(3)
    rgb = rs.uniform(0.1, 1.0, (8, 16, 3)).astype(np.float32)
    rgb[2, 5] = 40.0
    env = EnvMap.from_array(rgb)
    size = 32
    settings = RenderSettings(
        width=size, height=size, max_depth=3, rr_depth=2,
        tile_size=size * size // 8, env_type=ENV_MAP,
    )
    _assert_identical(*_run_pair(cornell_device_scene, settings, env=env))


def test_sharded_with_textures():
    """TextureStack + mip-LOD through the shard boundary: the LOD cone
    angle must use the FULL film height (round-1 advisor finding) or
    shards pick different mip levels per device count."""
    from hala_tpu.scene.cpu.image_data import ImageData, ImageFormat
    from hala_tpu.scene.loader.uploader import SceneUploader
    from hala_tpu.scene.procedural import cornell_box

    rs = np.random.RandomState(5)
    scene = cornell_box()
    scene.materials[0].base_color_map_index = 0
    tex = rs.uniform(0.2, 1.0, (16, 16, 4)).astype(np.float32)
    scene.image_data = [
        ImageData(16, 16, ImageFormat.R32G32B32A32_SFLOAT, tex)
    ]
    scene.texture2image_mapping = {0: 0}
    scene.image2data_mapping = {0: 0}
    dev = SceneUploader.upload(scene, use_ray_tracing=True)

    size = 32
    settings = RenderSettings(
        width=size, height=size, max_depth=2, rr_depth=2,
        tile_size=size * size // 8,
    )
    _assert_identical(*_run_pair(dev, settings))


def test_sharded_pallas_intersector(cornell_device_scene):
    """The Pallas intersect kernel (interpret mode) inside each shard:
    per-ray hits are a pure function of (ray, winning triangle), so the
    film must not depend on the device count."""
    size = 32
    settings = RenderSettings(
        width=size, height=size, max_depth=2, rr_depth=2,
        tile_size=size * size // 8, intersector="pallas",
        interpret_pallas=True,
    )
    _assert_identical(*_run_pair(cornell_device_scene, settings, frames=1))


def test_sharded_pallas_intersector_sah_scene():
    """The kernel on a multi-cluster binned-SAH scene (real triangles
    scattered past num_triangles, so every slot is scanned)."""
    from hala_tpu.scene.loader.uploader import SceneUploader
    from hala_tpu.scene.procedural import sponza_like

    dev = SceneUploader.upload(
        sponza_like(rooms=(2, 2), columns_per_room=3, boxes_per_room=2),
        use_ray_tracing=False,
    )
    size = 32
    settings = RenderSettings(
        width=size, height=size, max_depth=2, rr_depth=2,
        tile_size=size * size // 8, intersector="pallas",
        interpret_pallas=True,
    )
    _assert_identical(*_run_pair(dev, settings, frames=1))


def test_sharded_pallas_intersector_spp(cornell_device_scene):
    """The kernel with sample-adjacent spp batching under tiling."""
    size = 32
    settings = RenderSettings(
        width=size, height=size, max_depth=2, rr_depth=2,
        tile_size=size * size // 4, intersector="pallas",
        interpret_pallas=True, spp=2,
    )
    _assert_identical(*_run_pair(cornell_device_scene, settings, frames=1))


def test_sharded_spp_batch(cornell_device_scene):
    """spp batching under sharding: virtual RNG frames are a pure
    function of (global pixel id, frame), so the sample-adjacent
    dispatch must stay bit-identical to single-chip — and to the pixel
    partition, which row tiling changes."""
    size = 32
    settings = RenderSettings(
        width=size, height=size, max_depth=2, rr_depth=2,
        tile_size=size * size // 4, spp=2,
    )
    _assert_identical(*_run_pair(cornell_device_scene, settings, frames=1))


def test_sharded_pallas_intersector_envmap(cornell_device_scene):
    """The kernel under tiling with env NEE (a second any-hit batch per
    bounce)."""
    from hala_tpu.envmap import EnvMap
    from hala_tpu.models.integrator import ENV_MAP

    rs = np.random.RandomState(3)
    env = EnvMap.from_array(
        rs.uniform(0.05, 1.5, (16, 32, 3)).astype(np.float32)
    )
    size = 32
    settings = RenderSettings(
        width=size, height=size, max_depth=2, rr_depth=2,
        tile_size=size * size // 8, intersector="pallas",
        interpret_pallas=True, env_type=ENV_MAP,
    )
    _assert_identical(
        *_run_pair(cornell_device_scene, settings, env=env, frames=1)
    )


def test_sharded_pallas_intersector_alpha():
    """The kernel under tiling on a scene with alpha materials (shadow
    rays ride the closest-hit batch through `transmit`)."""
    from hala_tpu.scene.loader.uploader import SceneUploader
    from conftest import make_glass_scene

    dev = SceneUploader.upload(
        make_glass_scene(front_a=0.5), use_ray_tracing=False
    )
    assert dev.materials.has_alpha
    size = 32
    settings = RenderSettings(
        width=size, height=size, max_depth=2, rr_depth=2,
        tile_size=size * size // 8, intersector="pallas",
        interpret_pallas=True,
    )
    _assert_identical(*_run_pair(dev, settings, frames=1))


def test_sharded_uneven_aspect(cornell_device_scene):
    """Non-square film whose height still divides the mesh (40x48):
    per-shard row offsets + camera NDC must agree with single-chip."""
    settings = RenderSettings(
        width=40, height=48, max_depth=2, rr_depth=2,
        tile_size=240,
    )
    _assert_identical(
        *_run_pair(cornell_device_scene, settings, width=40, height=48)
    )


def test_sixteen_device_bit_identity():
    """Device-count scaling beyond the session's 8-device mesh: a
    subprocess with 16 virtual CPU devices must produce the same bits
    as its own single-device render (the ownership partition changes
    with the device count; pixel results must not)."""
    import subprocess
    import sys

    script = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 16)
import numpy as np
from hala_tpu.models.integrator import (
    Film, RenderSettings, Uniforms, render_frame,
)
from hala_tpu.parallel.tiling import (
    TiledFilm, make_mesh, render_frame_multichip,
)
from hala_tpu.scene.loader.uploader import SceneUploader
from hala_tpu.scene.procedural import cornell_box

assert len(jax.devices()) == 16
dev = SceneUploader.upload(cornell_box(), use_ray_tracing=False)
size = 32
settings = RenderSettings(
    width=size, height=size, max_depth=2, rr_depth=2,
    tile_size=size * size // 16, spp=2,
)
uniforms = Uniforms.default()
film = Film.create(size, size)
film, r1 = render_frame(dev, None, uniforms, film, 0, settings)
mesh = make_mesh()
tiled = TiledFilm.create(mesh, size, size)
tiled, r2 = render_frame_multichip(
    dev, None, uniforms, tiled, 0, settings
)
g = tiled.gather()
np.testing.assert_array_equal(np.asarray(film.accum), np.asarray(g.accum))
assert float(r1) == float(r2)
from hala_tpu.parallel.scene_shard import (
    render_frame_scene_sharded, shard_scene,
)
sharded, specs = shard_scene(dev, mesh)
tp = TiledFilm.create(mesh, size, size)
tp, r3 = render_frame_scene_sharded(
    sharded, None, uniforms, tp, 0, settings, specs=specs
)
np.testing.assert_array_equal(
    np.asarray(film.accum), np.asarray(tp.gather().accum)
)
assert float(r1) == float(r3)
print("OK16")
"""
    out = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True, text=True, timeout=540,
        cwd=__import__("os").path.dirname(
            __import__("os").path.dirname(__file__)
        ),
    )
    assert "OK16" in out.stdout, out.stderr[-2000:]
