#!/usr/bin/env python
"""Time each Pallas kernel against the plain XLA version of its query on
one NVIDIA GPU, at the bench's shapes, and sweep the kernels' block
sizes.

    python tools/time_kernels.py [--sections intersect,raster,gather,frame]

intersect: closest-hit and any-hit, Pallas kernel against
  intersect_bruteforce / occluded_bruteforce, on probe rays of the
  512^2 Cornell camera (65,536-ray tile) and of the atrium_big 1080p
  bench camera (the bench's 1,048,576-ray tile), plus a block-size sweep
  of the kernel and one run of the skip-link BVH at the sponza shape;
raster: the exact segment kernel against the full scan at 1080p on
  atrium_big (the band holding the heaviest tile), plus a block sweep;
gather: a shade-row fetch as jnp.take against a HIGHEST-precision
  one-hot matmul at the Cornell tile;
frame: one sponza frame (1920x1088, depth 4, 1 spp, staged dispatch as
  bench.py runs it) with the Pallas kernel against the XLA brute force,
  and the Cornell 16-frame window with each.

Every time is the median of a few runs after a warm-up, measured with
block_until_ready; each line (stdout) carries the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CARD = ""


def emit(msg: str) -> None:
    print(f"{msg} | {CARD}", flush=True)


def timed(fn, *args, reps=5):
    """(compile+first seconds, median warm seconds) of fn(*args)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    cold = time.perf_counter() - t0
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        runs.append(time.perf_counter() - t0)
    return cold, statistics.median(runs)


def section_intersect():
    import functools

    import jax

    import bench
    import chip_smoke
    from hala_tpu.ops.bvh import build_bvh, intersect_bvh
    from hala_tpu.ops.intersect import (
        intersect_bruteforce, occluded_bruteforce,
    )
    from hala_tpu.ops.pallas.intersect_kernel import (
        intersect_pallas, occluded_pallas,
    )
    from hala_tpu.scene.loader.uploader import SceneUploader
    from hala_tpu.scene.procedural import cornell_box

    atrium = SceneUploader.upload(chip_smoke.load_atrium(),
                                  use_ray_tracing=False)
    cornell = SceneUploader.upload(cornell_box(), use_ray_tracing=False)
    for label, scene, w, h, n in (
        ("cornell", cornell, 512, 512, 65536),
        ("atrium_big", atrium, 1920, 1088, bench.SPONZA_TILE),
    ):
        g = scene.geometry
        nr = chip_smoke.num_real(g)
        tris = (g.tri_v0, g.tri_e1, g.tri_e2)
        kern = jax.jit(functools.partial(intersect_pallas, num_real=nr))
        o, d, tf = chip_smoke.probe_rays(
            scene, w, h, n, hit_fn=lambda o, d: kern(o, d, *tris)
        )
        rows = [
            ("xla closest-hit", jax.jit(
                lambda o, d, t, *x: intersect_bruteforce(o, d, *x))),
            ("pallas closest-hit", jax.jit(
                lambda o, d, t, *x: intersect_pallas(
                    o, d, *x, num_real=nr))),
            ("xla any-hit", jax.jit(
                lambda o, d, t, *x: occluded_bruteforce(o, d, t, *x))),
            ("pallas any-hit", jax.jit(
                lambda o, d, t, *x: occluded_pallas(
                    o, d, t, *x, num_real=nr))),
        ]
        for name, fn in rows:
            try:
                cold, warm = timed(fn, o, d, tf, *tris, reps=3)
                emit(f"[intersect] {label} {n} rays x {g.tri_v0.shape[0]} "
                     f"slots {name}: {warm * 1e3:.2f} ms "
                     f"(cold {cold:.1f} s)")
            except Exception as e:  # report and go on: a data point
                emit(f"[intersect] {label} {name}: failed "
                     f"{type(e).__name__}: {str(e)[:200]}")
        sweep_n = min(n, 262144)
        for br, bt, nw in ((64, 32, 4), (128, 32, 4), (64, 64, 4),
                           (128, 16, 4), (32, 32, 2), (128, 64, 8),
                           (256, 16, 8), (64, 16, 2)):
            for any_hit in (False, True):
                fn = functools.partial(
                    occluded_pallas if any_hit else intersect_pallas,
                    num_real=nr, block_rays=br, block_tris=bt,
                    num_warps=nw,
                )
                args = ((o[:sweep_n], d[:sweep_n], tf[:sweep_n]) if any_hit
                        else (o[:sweep_n], d[:sweep_n]))
                try:
                    _, warm = timed(fn, *args, *tris, reps=3)
                    emit(f"[sweep] {label} {sweep_n} rays "
                         f"{'any' if any_hit else 'closest'} br={br} "
                         f"bt={bt} warps={nw}: {warm * 1e3:.2f} ms")
                except Exception as e:
                    emit(f"[sweep] {label} br={br} bt={bt} warps={nw}: "
                         f"failed {type(e).__name__}: {str(e)[:200]}")
        if label == "atrium_big":
            t0 = time.perf_counter()
            bvh = build_bvh(g)
            emit(f"[bvh] host build {time.perf_counter() - t0:.1f} s, "
                 f"{bvh.num_nodes} nodes")
            fn = jax.jit(lambda b, o, d: intersect_bvh(b, g, o, d))
            cold, warm = timed(fn, bvh, o, d, reps=1)
            emit(f"[bvh] atrium_big {n} rays skip-link BVH closest-hit: "
                 f"{warm * 1e3:.2f} ms (cold {cold:.1f} s)")


def section_raster():
    import functools
    import math

    import jax
    import jax.numpy as jnp

    import chip_smoke
    from hala_tpu.models.rz_renderer import RasterizationRenderer
    from hala_tpu.ops.raster import rasterize
    from hala_tpu.ops.raster_kernel import rasterize_tiled_exact

    r = RasterizationRenderer("time_raster", 1920, 1088, binned=True,
                              tile=64)
    r.set_scene(chip_smoke.load_atrium())
    r.commit()
    args = chip_smoke.raster_inputs(r)
    t = args[0].shape[0]
    exact = jax.jit(functools.partial(
        rasterize_tiled_exact, width=1920, height=1088, tile=64))
    cold, warm = timed(exact, *args)
    emit(f"[raster] atrium_big 1920x1088 exact kernel (bin + visibility): "
         f"{warm * 1e3:.2f} ms (cold {cold:.1f} s)")
    pix = jnp.arange(1920 * 1088, dtype=jnp.int32)
    px = (pix % 1920).astype(jnp.float32) + 0.5
    py = (pix // 1920).astype(jnp.float32) + 0.5
    scan = jax.jit(functools.partial(rasterize, chunk=math.gcd(512, t)))
    try:
        cold, warm = timed(scan, *args, px, py, reps=1)
        emit(f"[raster] atrium_big 1920x1088 full XLA scan: "
             f"{warm * 1e3:.2f} ms (cold {cold:.1f} s)")
    except Exception as e:
        emit(f"[raster] full XLA scan failed {type(e).__name__}: "
             f"{str(e)[:200]}")
    for pp, cb, nw in ((256, 8, 4), (512, 8, 4), (256, 16, 4),
                       (128, 16, 4), (512, 16, 8), (1024, 8, 8),
                       (128, 32, 4)):
        fn = jax.jit(functools.partial(
            rasterize_tiled_exact, width=1920, height=1088, tile=64,
            pixels_per_program=pp, cand_block=cb, num_warps=nw))
        try:
            _, warm = timed(fn, *args)
            emit(f"[sweep] raster pp={pp} cb={cb} warps={nw}: "
                 f"{warm * 1e3:.2f} ms")
        except Exception as e:
            emit(f"[sweep] raster pp={pp} cb={cb} warps={nw}: failed "
                 f"{type(e).__name__}: {str(e)[:200]}")


def section_gather():
    import jax
    import jax.numpy as jnp

    from hala_tpu.scene.loader.uploader import SceneUploader
    from hala_tpu.scene.procedural import cornell_box

    table = SceneUploader.upload(
        cornell_box(), use_ray_tracing=False).geometry.shade_table
    idx = jax.random.randint(jax.random.key(0), (65536,), 0,
                             table.shape[0])
    take = jax.jit(lambda t, i: jnp.take(t, i, axis=0))
    onehot = jax.jit(lambda t, i: jnp.dot(
        (i[:, None] == jnp.arange(t.shape[0])[None, :]).astype(t.dtype),
        t, precision=jax.lax.Precision.HIGHEST))
    for name, fn in (("jnp.take", take), ("one-hot HIGHEST", onehot)):
        _, warm = timed(fn, table, idx, reps=20)
        emit(f"[gather] 65536 rows of {table.shape}: {name} "
             f"{warm * 1e6:.1f} us")


def section_frame():
    import dataclasses

    import bench
    from hala_tpu.models.integrator import (
        Film, RenderSettings, Uniforms, render_frame_staged, render_frames,
    )
    from hala_tpu.scene.loader.uploader import SceneUploader
    from hala_tpu.scene.procedural import cornell_box

    scene = bench._sponza_scene()
    for engine in ("pallas", "bruteforce"):
        s = RenderSettings(width=1920, height=1088, max_depth=4, rr_depth=2,
                           tile_size=bench.SPONZA_TILE, intersector=engine)

        def frame(f, s=s):
            film, rays = render_frame_staged(
                scene, None, Uniforms.default(), Film.create(1920, 1088),
                f, s)
            return film.accum, rays

        try:
            cold, warm = timed(frame, 0, reps=1)
            emit(f"[frame] sponza 1920x1088 1 spp depth 4 staged, "
                 f"{engine}: {warm * 1e3:.1f} ms/frame (cold {cold:.1f} s)")
        except Exception as e:
            emit(f"[frame] sponza {engine}: failed {type(e).__name__}: "
                 f"{str(e)[:300]}")
    cornell = SceneUploader.upload(cornell_box(), use_ray_tracing=False)
    for engine in ("pallas", "bruteforce"):
        s = dataclasses.replace(bench._ggx_settings(), intersector=engine)

        def window(f, s=s):
            film, rays = render_frames(
                cornell, None, Uniforms.default(), Film.create(512, 512),
                f, 16, s)
            return film.accum, rays

        cold, warm = timed(window, 0, reps=3)
        emit(f"[frame] cornell 512x512 16 frames fused, {engine}: "
             f"{warm * 1e3 / 16:.2f} ms/frame (cold {cold:.1f} s)")


SECTIONS = {
    "intersect": section_intersect,
    "raster": section_raster,
    "gather": section_gather,
    "frame": section_frame,
}


def main():
    global CARD
    ap = argparse.ArgumentParser()
    ap.add_argument("--sections", default=",".join(SECTIONS))
    args = ap.parse_args()
    import chip_smoke

    chip_smoke.gpu_devices(1)
    from hala_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    CARD = chip_smoke.card_line()
    for name in args.sections.split(","):
        SECTIONS[name]()


if __name__ == "__main__":
    main()
