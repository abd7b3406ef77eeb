#!/usr/bin/env python
"""Benchmark harness: every BASELINE.md config on one NVIDIA GPU.

Prints ONE JSON line per metric:
  {"metric": ..., "value": N, "unit": ...}

With no argument each config runs in its OWN subprocess, one after
another, so only one process holds the card at a time and the parent
stays off JAX; every config that succeeds emits its lines even when
another config fails. `python bench.py <config>` runs one config
in-process (worker mode). A worker exits non-zero when JAX finds no GPU.

Correctness invariants: each path-traced config asserts (a) total rays
traced > 1.2x camera rays — a sky-only mis-render terminates every path
at the primary miss, so its counter lands EXACTLY on primaries — and
(b) the film's accumulated mean lies inside a band. A config failing its
invariant exits with code 3 and emits nothing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

# ---------------------------------------------------------------------------
# Invariants
# ---------------------------------------------------------------------------

# Accumulated-film mean-radiance bands (mean over RGB of film.accum
# after the measured frames): a known-good render's mean with +-40%
# slack — wide enough for estimator noise and deliberate sampling
# changes, narrow enough that a sky-only or geometry-dropping frame (a
# clipped raster frame once read 0.66 against a true 0.88 — a 25%
# collapse) trips it. The centres date from the accelerator this code
# was first written for; re-check each one against the GPU's own
# known-good render (the cornell centre also matches the CPU render).
ACCUM_MEAN_BANDS: dict[str, tuple[float, float]] = {
    "cornell": (0.42, 0.97),       # centre 0.694 (CPU render 0.6944)
    "ggx": (0.41, 0.96),           # centre 0.686
    "envmap": (0.021, 0.050),      # centre 0.0353
    "sponza": (0.09, 0.75),
    "sponza16": (0.09, 0.75),
    "raster": (0.05, 0.60),
    "raster_atrium": (0.37, 0.87),  # centre 0.623
}

# Rays per visibility tile of the 1080p atrium_big configs.
SPONZA_TILE = 1048576

INVARIANT_EXIT = 3
NO_GPU_EXIT = 4


class InvariantError(AssertionError):
    pass


def check_invariants(
    name: str,
    accum_mean: float,
    rays_total: float | None = None,
    primaries: float | None = None,
) -> None:
    """Raise InvariantError if the render looks like a mis-render.

    rays_total EXACTLY equal to the camera-ray count is the signature
    of a no-geometry frame (every path dies at its primary miss); the
    1.2x threshold also catches near-total geometry loss. The mean band
    catches shading/accumulation collapse that keeps ray counts alive.
    """
    if rays_total is not None and primaries is not None:
        if rays_total <= primaries * 1.2:
            raise InvariantError(
                f"{name}: rays_total {rays_total:.0f} <= 1.2x camera rays "
                f"{primaries:.0f} — sky-only / no-geometry frame"
            )
    band = ACCUM_MEAN_BANDS.get(name)
    if band is not None:
        lo, hi = band
        if not (lo <= accum_mean <= hi):
            raise InvariantError(
                f"{name}: film accum mean {accum_mean:.4f} outside "
                f"[{lo}, {hi}] — shading collapse or blow-up"
            )


def _emit(metric, value, unit="Mrays/s"):
    print(
        json.dumps({"metric": metric, "value": value, "unit": unit}),
        flush=True,
    )


# ---------------------------------------------------------------------------
# Workers (one BASELINE config each; run in-process)
# ---------------------------------------------------------------------------


def _film_mean(film):
    """Mean RGB of the accumulated film, fetched as one scalar."""
    import jax
    import jax.numpy as jnp

    return float(jax.jit(lambda a: jnp.mean(a[..., :3]))(film.accum))


def _trace_loop(scene, env, settings, frames, name, staged=False):
    """Pipelined progressive loop (no host sync inside the window).
    Returns (Mrays/s, ms/frame); checks the config's invariants.

    staged=True dispatches each frame through render_frame_staged
    (bit-equal to the megakernel): many small async XLA programs per
    frame instead of one; otherwise the whole window is one
    render_frames program."""
    import jax

    from hala_tpu.models.integrator import (
        Film, Uniforms, render_frame_staged, render_frames,
    )

    uniforms = Uniforms.default()
    film = Film.create(settings.width, settings.height)
    t_cold = time.perf_counter()
    if staged:
        film, rays = render_frame_staged(
            scene, env, uniforms, film, 0, settings
        )
    else:
        # The warmup runs frames 0..frames-1; the measured window runs
        # frames..2*frames-1.
        film, rays = render_frames(
            scene, env, uniforms, film, 0, frames, settings
        )
    float(rays)  # completion: the scalar fetch waits for the frame
    # cold = compile + first frame(s); across fresh processes this line
    # is the pipeline-cache verification (rt_renderer.rs:229-240 role):
    # a warm compile cache must make it collapse toward frame time.
    print(
        f"[bench] {name}: cold compile+first-frame "
        f"{time.perf_counter() - t_cold:.1f}s",
        file=sys.stderr, flush=True,
    )
    import jax.numpy as jnp

    _sum_all = jax.jit(lambda rs: jnp.sum(jnp.stack(rs)))
    if staged:
        rays_acc = []
        t0 = time.perf_counter()
        for f in range(1, 1 + frames):
            film, rays = render_frame_staged(
                scene, env, uniforms, film, f, settings
            )
            rays_acc.append(rays)
        # ONE jitted sum + scalar fetch ends the window: the fetch
        # cannot return before every queued frame finished
        total_rays = float(_sum_all(rays_acc))
        dt = time.perf_counter() - t0
    else:
        t0 = time.perf_counter()
        film, rays = render_frames(
            scene, env, uniforms, film, frames, frames, settings
        )
        total_rays = float(rays)
        dt = time.perf_counter() - t0
    primaries = (
        settings.width * settings.height * max(1, settings.spp) * frames
    )
    mean = _film_mean(film)
    print(f"[bench] {name}: accum mean {mean:.4f}, rays/primary "
          f"{total_rays / primaries:.2f}", file=sys.stderr, flush=True)
    check_invariants(name, mean, total_rays, primaries)
    return total_rays / dt / 1e6, dt / frames * 1e3


def _ggx_settings():
    from hala_tpu.models.integrator import RenderSettings

    return RenderSettings(
        width=512, height=512, max_depth=4, rr_depth=2, tile_size=65536,
    )


def bench_cornell():
    """Config 1: Cornell Box path trace, 512x512, diffuse BSDF."""
    from hala_tpu.scene.loader.uploader import SceneUploader
    from hala_tpu.scene.procedural import cornell_box

    scene = SceneUploader.upload(cornell_box(), use_ray_tracing=False)
    mrays, ms = _trace_loop(scene, None, _ggx_settings(), 16, "cornell")
    _emit("cornell_512_pathtrace_throughput", mrays)


def bench_ggx():
    """Config 2: multi-bounce GGX metallic-roughness + NEE, 4 spp."""
    import numpy as np

    from hala_tpu.scene.cpu.material import Material, MaterialType
    from hala_tpu.scene.loader.uploader import SceneUploader
    from hala_tpu.scene.procedural import cornell_box

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
    # Config 2's own shape (BASELINE "4 spp"): each frame renders 4
    # sample-adjacent spp (settings.spp=4), over the same 16-frame
    # window as Cornell. The metric key's _s4 suffix marks the shape.
    settings = dataclasses.replace(_ggx_settings(), spp=4)
    mrays, _ = _trace_loop(scene, None, settings, 16, "ggx")
    _emit("ggx_4spp_pathtrace_throughput_w16s4", mrays)


def bench_envmap():
    """Config 3: HDR environment lighting through the inverted-CDF
    tables (envmap.rs parity)."""
    import numpy as np

    from hala_tpu.envmap import EnvMap
    from hala_tpu.models.integrator import ENV_MAP, RenderSettings
    from hala_tpu.scene.loader.uploader import SceneUploader
    from hala_tpu.scene.procedural import cornell_box

    rs = np.random.RandomState(7)
    rgb = rs.uniform(0.05, 0.3, (64, 128, 3)).astype(np.float32)
    rgb[20:26, 40:48] = 60.0  # hot "sun" patch: CDF must find it
    env = EnvMap.from_array(rgb)
    # No ceiling light: all illumination arrives via env importance
    # sampling + MIS through the open-top box geometry.
    scene = SceneUploader.upload(
        cornell_box(light_intensity=0.0), use_ray_tracing=False
    )
    settings = RenderSettings(
        width=512, height=512, max_depth=4, rr_depth=2, tile_size=65536,
        env_type=ENV_MAP,
    )
    # 16 pipelined frames: same window as cornell/ggx
    mrays, _ = _trace_loop(scene, env, settings, 16, "envmap")
    _emit("envmap_cdf_pathtrace_throughput", mrays)


def _sponza_scene():
    from hala_tpu.scene.cpu.scene import Scene
    from hala_tpu.scene.loader.uploader import SceneUploader

    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "assets", "atrium_big.glb",
    )
    return SceneUploader.upload(Scene.load(path), use_ray_tracing=False)


def bench_sponza():
    """Config 4 (1 spp shape): Sponza-scale scene loaded from a real
    .glb on disk (assets/atrium_big.glb: 167k triangles, embedded PNG
    textures, quad area lights), brute-force visibility with a split
    any-hit shadow query, 1080p film, staged dispatch."""
    from hala_tpu.models.integrator import RenderSettings

    scene = _sponza_scene()
    settings = RenderSettings(
        width=1920, height=1088, max_depth=4, rr_depth=2,
        tile_size=SPONZA_TILE,
    )
    mrays, ms = _trace_loop(scene, None, settings, 3, "sponza", staged=True)
    _emit("sponza_scale_1080p_pathtrace_throughput", mrays)
    _emit("sponza_scale_1080p_ms_per_frame_1spp", ms, unit="ms")


def bench_sponza16():
    """Config 4's own workload shape (BASELINE.md: "1080p 16 spp"),
    its own subprocess so a fault here cannot cost the 1-spp lines.
    Dispatched through the staged frame (render_frame_staged, bit-equal
    to the megakernel), 16 sample-adjacent rays per pixel in each
    visibility tile."""
    import jax

    from hala_tpu.models.integrator import (
        Film, RenderSettings, Uniforms, render_frame_staged,
    )

    scene = _sponza_scene()
    settings = RenderSettings(
        width=1920, height=1088, max_depth=4, rr_depth=2,
        # at 16 spp one tile is 65536 pixels x 16 sample-adjacent rays
        tile_size=SPONZA_TILE, spp=16,
    )
    uniforms = Uniforms.default()
    film = Film.create(settings.width, settings.height)
    t_cold = time.perf_counter()
    film, rays = render_frame_staged(
        scene, None, uniforms, film, 0, settings
    )
    jax.block_until_ready(film.accum)  # compile + first frame
    print(
        f"[bench] sponza16: cold compile+first-frame "
        f"{time.perf_counter() - t_cold:.1f}s",
        file=sys.stderr, flush=True,
    )
    t0 = time.perf_counter()
    film, rays = render_frame_staged(
        scene, None, uniforms, film, 1, settings
    )
    total_rays = float(rays)  # the scalar fetch waits for the frame
    dt = time.perf_counter() - t0
    primaries = settings.width * settings.height * 16
    check_invariants("sponza16", _film_mean(film), total_rays, primaries)
    _emit("sponza_scale_1080p_16spp_throughput", total_rays / dt / 1e6)


def bench_raster():
    """Config 5: tile-binned rasterizer + compute post pass
    (rz_renderer parity). The headline is the Sponza-scale mesh
    (atrium_big at 1080p); the 36-triangle Cornell line measures fixed
    dispatch and post cost."""
    import jax

    from hala_tpu.models.rz_renderer import RasterizationRenderer
    from hala_tpu.programs.compute_program import (
        ComputeProgram, ComputeProgramDesc,
    )
    from hala_tpu.scene.cpu.scene import Scene
    from hala_tpu.scene.procedural import cornell_box

    post = ComputeProgram(ComputeProgramDesc(
        shader_file_path="hala_tpu.ops.tonemap:tonemap_aces_simple"
    ))

    def time_renderer(r, frames, name):
        import jax.numpy as jnp

        # a scalar host fetch ends each timed window
        _mean = jax.jit(lambda a: jnp.mean(a[..., :3]))
        r.commit()
        t_cold = time.perf_counter()
        r.update()  # compile + first frame
        mean = float(_mean(r.color))
        print(
            f"[bench] {name}: cold compile+first-frame "
            f"{time.perf_counter() - t_cold:.1f}s",
            file=sys.stderr, flush=True,
        )
        t0 = time.perf_counter()
        for _ in range(frames):
            r.update()
        mean = float(_mean(r.color))
        ms = (time.perf_counter() - t0) / frames * 1e3
        check_invariants(name, mean)
        return ms

    ra = RasterizationRenderer(
        "bench_atrium", 1920, 1088, binned=True, tile=64,
        post_program=post,
    )
    ra.set_scene(Scene.load(os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "assets", "atrium_big.glb",
    )))
    ms = time_renderer(ra, 10, "raster_atrium")
    _emit("raster_atrium_big_1080p_ms_per_frame", ms, unit="ms")

    # Secondary: the Cornell config (36 tris — fixed dispatch + post).
    r = RasterizationRenderer(
        "bench", 1920, 1088, binned=True, tile=64, post_program=post,
    )
    r.set_scene(cornell_box())
    ms = time_renderer(r, 30, "raster")
    _emit("raster_binned_post_1080p_ms_per_frame", ms, unit="ms")


WORKERS = {
    "cornell": bench_cornell,
    "ggx": bench_ggx,
    "envmap": bench_envmap,
    "sponza": bench_sponza,
    "sponza16": bench_sponza16,
    "raster": bench_raster,
}

# (config, timeout_s). Orders the output: cornell first.
SCHEDULE = [
    ("cornell", 1500),
    ("ggx", 1500),
    ("envmap", 1500),
    ("sponza", 3000),
    ("sponza16", 3000),
    ("raster", 2400),
]


def run_worker(config: str) -> None:
    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"[bench] {config}: no GPU (jax platform "
              f"{jax.devices()[0].platform!r})", file=sys.stderr)
        sys.exit(NO_GPU_EXIT)
    from hala_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    try:
        WORKERS[config]()
    except InvariantError as e:
        print(f"INVARIANT FAILED [{config}]: {e}", file=sys.stderr)
        sys.exit(INVARIANT_EXIT)


def orchestrate() -> int:
    """Run every config in its own subprocess, one at a time. Worker
    JSON lines stream through, so configs that succeed are never lost
    to a later failure. Returns non-zero if any config failed."""
    failures = []
    for config, limit in SCHEDULE:
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), config],
                capture_output=True, text=True, timeout=limit,
            )
        except subprocess.TimeoutExpired as e:
            print(f"[bench] {config}: timeout {limit}s\n"
                  f"{(e.stderr or '')[-2000:]}", file=sys.stderr, flush=True)
            failures.append(config)
            continue
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
        for line in proc.stderr.splitlines():
            if line.startswith("[bench]"):
                print(line, file=sys.stderr, flush=True)
        if proc.returncode != 0:
            tail = proc.stderr.strip().splitlines()[-12:]
            print(f"[bench] {config}: rc={proc.returncode}\n"
                  + "\n".join(tail), file=sys.stderr, flush=True)
            failures.append(config)
    if failures:
        print(f"[bench] failed configs: {failures}", file=sys.stderr,
              flush=True)
    return 1 if failures else 0


def main() -> None:
    config = sys.argv[1].lstrip("-") if len(sys.argv) > 1 else "all"
    if config == "all":
        sys.exit(orchestrate())
    elif config in WORKERS:
        run_worker(config)
    else:
        print(f"unknown config {config!r}; one of {list(WORKERS)} or 'all'",
              file=sys.stderr)
        sys.exit(2)


if __name__ == "__main__":
    main()
