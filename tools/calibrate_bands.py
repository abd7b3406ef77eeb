"""Calibrate bench.py ACCUM_MEAN_BANDS on the CPU.

Renders each BASELINE config's scene/camera at a reduced film (the
accumulated MEAN is resolution-invariant up to sampling detail) and
prints the means; bands in bench.py are these +-40%. Compare them with
the means the bench prints on the GPU ("[bench] <config>: accum mean").

  python -u tools/calibrate_bands.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from hala_tpu.models.integrator import (
    ENV_MAP, Film, RenderSettings, Uniforms, render_frame,
)
from hala_tpu.scene.loader.uploader import SceneUploader

t00 = time.perf_counter()


def mean_of(scene, env, settings, frames):
    uniforms = Uniforms.default()
    film = Film.create(settings.width, settings.height)
    for f in range(frames):
        film, rays = render_frame(scene, env, uniforms, film, f, settings)
    return float(jnp.mean(film.accum[..., :3])), float(rays)


def stamp(name, m):
    print(
        f"[{time.perf_counter()-t00:7.1f}s] {name}: mean={m:.4f} "
        f"band=({m*0.6:.3f}, {m*1.4:.3f})",
        flush=True,
    )


def run():
    from hala_tpu.scene.cpu.material import Material, MaterialType
    from hala_tpu.scene.procedural import cornell_box

    small = RenderSettings(
        width=128, height=128, max_depth=4, rr_depth=2, tile_size=16384,
        intersector="auto",
    )
    scene = SceneUploader.upload(cornell_box(), use_ray_tracing=False)
    m, _ = mean_of(scene, None, small, 4)
    stamp("cornell", m)

    metal = Material(
        type=MaterialType.DISNEY,
        base_color=np.array([0.9, 0.75, 0.4], np.float32),
        roughness=0.2, metallic=1.0,
    )
    glossy = Material(
        type=MaterialType.DISNEY,
        base_color=np.array([0.2, 0.4, 0.9], np.float32),
        roughness=0.45, metallic=0.0,
    )
    scene = SceneUploader.upload(
        cornell_box(tall_box_material=metal, short_box_material=glossy),
        use_ray_tracing=False,
    )
    m, _ = mean_of(scene, None, small, 4)
    stamp("ggx", m)

    from hala_tpu.envmap import EnvMap

    rs = np.random.RandomState(7)
    rgb = rs.uniform(0.05, 0.3, (64, 128, 3)).astype(np.float32)
    rgb[20:26, 40:48] = 60.0
    env = EnvMap.from_array(rgb)
    scene = SceneUploader.upload(
        cornell_box(light_intensity=0.0), use_ray_tracing=False
    )
    env_small = RenderSettings(
        width=128, height=128, max_depth=4, rr_depth=2, tile_size=16384,
        env_type=ENV_MAP, intersector="auto",
    )
    m, _ = mean_of(scene, env, env_small, 4)
    stamp("envmap", m)

    from hala_tpu.scene.cpu.scene import Scene

    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "assets", "atrium_big.glb",
    )
    scene = SceneUploader.upload(Scene.load(path), use_ray_tracing=False)
    sp = RenderSettings(
        width=192, height=96, max_depth=4, rr_depth=2, tile_size=16384,
        intersector="auto",
    )
    m, _ = mean_of(scene, None, sp, 2)
    stamp("sponza", m)

    from hala_tpu.models.rz_renderer import RasterizationRenderer
    from hala_tpu.programs.compute_program import (
        ComputeProgram, ComputeProgramDesc,
    )

    post = ComputeProgram(ComputeProgramDesc(
        shader_file_path="hala_tpu.ops.tonemap:tonemap_aces_simple"
    ))
    ra = RasterizationRenderer(
        "cal_atrium", 480, 272, binned=True, tile=64, post_program=post,
    )
    ra.set_scene(Scene.load(path))
    ra.commit()
    ra.update()
    m = float(jnp.mean(ra.color[..., :3]))
    stamp("raster_atrium", m)

    r = RasterizationRenderer(
        "cal_cornell", 480, 272, binned=True, tile=64, post_program=post,
    )
    from hala_tpu.scene.procedural import cornell_box as cb

    r.set_scene(cb())
    r.commit()
    r.update()
    m = float(jnp.mean(r.color[..., :3]))
    stamp("raster", m)


if __name__ == "__main__":
    run()
