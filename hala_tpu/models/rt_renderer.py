"""Progressive path-tracing renderer (the flagship).

Parity: reference src/rt_renderer.rs (HalaRenderer, exported as
HalaRayTracingRenderer):

* constructor parameters (rt_renderer.rs:650-660): name, resolution,
  max_depth, rr_depth, enable_tonemap, enable_aces, use_simple_aces,
  max_frames (0 = unlimited, rt_renderer.rs:774);
* `set_scene` uploads with (mesh_shader=False, global_meshlets=False,
  ray_tracing=True) (rt_renderer.rs:1161-1178);
* lighting-environment knobs set_envmap / set_ground_color /
  set_sky_color / set_env_intensity / set_exposure_value
  (rt_renderer.rs:1184-1219);
* `load_blue_noise_texture` (rt_renderer.rs:1117-1156) — stored and
  surfaced; the integrator's PCG4D stream fills the low-discrepancy
  seeding role (see ops/rng.py);
* `update` skips once total_frames exceeds the max_frames progressive
  budget (rt_renderer.rs:393-396) and seeds sampling with the frame
  index (rt_renderer.rs:414);
* `save_images` writes {name}_color/albedo/normal .pfm with the selected
  tonemap operator applied to color only (rt_renderer.rs:1224-1352).

The commit() of the reference (descriptor writes + RT pipeline + SBT,
rt_renderer.rs:136-379) maps to: freeze RenderSettings and jit-compile
the frame function; the XLA compilation cache replaces
./out/pipeline_cache.bin.
"""

from __future__ import annotations

import enum
import logging
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..error import HalaRendererError
from ..envmap import EnvMap
from ..ops.tonemap import apply_tonemap
from ..scene.cpu.scene import Scene
from ..scene.cpu.image_data import ImageData
from ..scene.loader.uploader import SceneUploader
from ..utils.pfm import write_pfm
from .integrator import (
    ENV_MAP,
    ENV_SKY,
    Film,
    KernelHooks,
    RenderSettings,
    Uniforms,
    render_frame,
    render_frame_staged,
)
from .renderer import BaseRenderer

logger = logging.getLogger("hala_tpu.rt")


class EnvType(enum.IntEnum):
    """rt_renderer.rs:23-41."""

    SKY = ENV_SKY
    MAP = ENV_MAP


class RayTracingRenderer(BaseRenderer):
    def __init__(
        self,
        name: str,
        width: int,
        height: int,
        max_depth: int = 4,
        rr_depth: int = 2,
        enable_tonemap: bool = True,
        enable_aces: bool = False,
        use_simple_aces: bool = False,
        max_frames: int = 0,
        tile_size: int = 65536,
        use_bvh: bool = True,
        intersector: str = "auto",
        spp: int = 1,
        staged: bool = False,
    ):
        super().__init__(name, width, height)
        self.max_depth = max_depth
        self.rr_depth = rr_depth
        self.enable_tonemap = enable_tonemap
        self.enable_aces = enable_aces
        self.use_simple_aces = use_simple_aces
        self.max_frames = max_frames if max_frames > 0 else (1 << 62)
        self._tile_size = tile_size
        self._spp = spp
        # Staged frame dispatch: every visibility query in its own jit
        # (integrator.render_frame_staged).
        self._staged = staged
        self._use_bvh = use_bvh
        # "auto" stays symbolic: the scene-aware resolution happens at
        # trace time in integrator._backend (needs the scene size).
        self._intersector = intersector

        self.scene = None          # DeviceScene
        self._host_scene: Scene | None = None
        self.env: EnvMap | None = None
        self.env_type = EnvType.SKY
        self.uniforms = Uniforms.default()
        self.film = Film.create(width, height)
        self.blue_noise: ImageData | None = None
        self.settings: RenderSettings | None = None
        self._frame_index = 0
        self.total_rays = 0.0
        self._last_rays = 0.0

    # -- scene / environment API ----------------------------------------

    def set_scene(self, scene: Scene) -> None:
        """rt_renderer.rs:1161-1178."""
        self._host_scene = scene
        self.scene = SceneUploader.upload(
            scene,
            use_mesh_shader=False,
            use_global_meshlets=False,
            use_ray_tracing=self._use_bvh,
        )

    def set_envmap(self, env: "EnvMap | str", rotation: float = 0.0) -> None:
        """rt_renderer.rs:1184-1192; rotation in degrees, normalized by
        /360 into the uniform (rt_renderer.rs:420)."""
        if isinstance(env, str):
            env = EnvMap.load(env)
        self.env = env
        self.env_type = EnvType.MAP
        self.uniforms.env_rotation = jnp.float32(rotation / 360.0)
        self.settings = None  # env type is compile-time

    def set_ground_color(self, color) -> None:
        self.uniforms.ground_color = jnp.asarray(color, jnp.float32)

    def set_sky_color(self, color) -> None:
        self.uniforms.sky_color = jnp.asarray(color, jnp.float32)

    def set_env_intensity(self, intensity: float) -> None:
        self.uniforms.env_intensity = jnp.float32(intensity)

    def set_exposure_value(self, ev: float) -> None:
        self.uniforms.exposure_value = jnp.float32(ev)

    def set_camera_index(self, index: int) -> None:
        self.uniforms.camera_index = jnp.int32(index)

    # -- kernel push API (shader push parity) -----------------------------

    def push_general_kernel(self, kind: str, fn_or_path) -> None:
        """Register a raygen/miss/callable stage kernel
        (rt_renderer.rs:925-1012 push_general_shader: rejects other
        stages). Kernels land in the process KernelCache under
        rt.<kind>; the built-in integrator stages are the defaults."""
        if kind not in ("raygen", "miss", "callable"):
            raise HalaRendererError(
                f"Only raygen/miss/callable stages accepted, got {kind!r}."
            )
        self._push_kernel(f"rt.{kind}", fn_or_path)

    def push_hit_kernels(
        self, closest_hit, any_hit=None, intersection=None
    ) -> None:
        """Register a hit-group kernel tuple (rt_renderer.rs:1020-1112
        push_hit_shaders; group type TRIANGLES unless an intersection
        kernel is present — the procedural-geometry analog)."""
        self._push_kernel("rt.closest_hit", closest_hit)
        if any_hit is not None:
            self._push_kernel("rt.any_hit", any_hit)
        if intersection is not None:
            self._push_kernel("rt.intersection", intersection)

    def _push_kernel(self, name: str, fn_or_path) -> None:
        from ..programs import KernelCache

        cache = KernelCache.get_instance()
        if isinstance(fn_or_path, str):
            cache.from_memory(name, cache.load(fn_or_path))
        else:
            cache.from_memory(name, fn_or_path)

    def load_blue_noise_texture(self, path: str) -> None:
        """rt_renderer.rs:1117-1156: the texture becomes the per-pixel
        low-discrepancy jitter source for primary rays."""
        img = ImageData.load(path)
        self.blue_noise = jnp.asarray(img.as_float_rgba())

    # -- frame loop ------------------------------------------------------

    def commit(self) -> None:
        """Freeze settings + compile (rt_renderer.rs:136-379 role)."""
        if self.scene is None:
            raise HalaRendererError("commit() before set_scene().")
        # Backend choice is delegated to the platform-aware "auto" logic
        # in integrator._backend; an explicit constructor choice is
        # honored as-is — no silent overrides.
        self.settings = RenderSettings(
            width=self.info.width,
            height=self.info.height,
            max_depth=self.max_depth,
            rr_depth=self.rr_depth,
            env_type=int(self.env_type),
            tile_size=self._tile_size,
            intersector=self._intersector,
            spp=self._spp,
        )
        # Resolve pushed kernels into the frame's dispatch table (the
        # SBT-build step of the reference's commit; stages not pushed
        # keep the built-in integrator behavior). rt.callable maps to
        # the post-shade seam.
        from ..programs import KernelCache

        cache = KernelCache.get_instance()
        hooks = KernelHooks(
            raygen=cache.get("rt.raygen"),
            miss=cache.get("rt.miss"),
            post_shade=cache.get("rt.callable"),
            closest_hit=cache.get("rt.closest_hit"),
            any_hit=cache.get("rt.any_hit"),
            intersection=cache.get("rt.intersection"),
        )
        self.hooks = (
            hooks
            if (hooks.raygen or hooks.miss or hooks.post_shade
                or hooks.closest_hit or hooks.any_hit
                or hooks.intersection)
            else None
        )
        # Staged dispatch needs the split-shadow regime (no alpha
        # materials). Degrade to the megakernel with a warning rather
        # than failing the frame loop — the reference's warn-and-fall-
        # back posture for unsupported modes (e.g. the MAX-caps
        # truncation, gpu_uploader.rs:99-104); the low-level
        # render_frame_staged stays strict for explicit callers.
        if self._staged and self.scene.materials.has_alpha:
            logger.warning(
                "staged dispatch requires a scene without alpha "
                "materials; falling back to the megakernel frame for "
                "this scene."
            )
            self._staged = False

    def update(self, delta_time: float = 0.0, ui_fn=None) -> None:
        """Dispatch one progressive frame (rt_renderer.rs:387-471).

        `ui_fn` is the per-frame UI/overlay callback the reference
        threads through every record path (rt_renderer.rs:430-468:
        ui_fn records UI draws into the swapchain image AFTER scene
        rendering). Here: a jax-traceable
        `(color (H, W, 3)) -> (H, W, 3)` applied to the DISPLAY image —
        after tonemapping, never to the progressive accumulator — in
        `get_final_image`/`save_images`. It runs device-side in one jit
        (no host round trip); pass None to clear."""
        self._ui_fn = ui_fn
        if self.settings is None:
            self.commit()
        self.check_and_restore_device()
        if self._frame_index >= self.max_frames:
            return  # progressive budget reached (rt_renderer.rs:393-396)
        t0 = time.monotonic()
        frame_fn = render_frame_staged if self._staged else render_frame
        self.film, rays = frame_fn(
            self.scene,
            self.env,
            self.uniforms,
            self.film,
            self._frame_index,
            self.settings,
            blue_noise=self.blue_noise,
            hooks=getattr(self, "hooks", None),
        )
        self._pending = (self.film, rays)
        self._last_rays = rays
        self._frame_index += 1
        self._last_cpu_time = time.monotonic() - t0

    def render(self) -> None:
        super().render()
        if self._last_rays is not None and not self.is_device_lost:
            try:
                self.total_rays += float(self._last_rays)
            except (TypeError, ValueError):  # pragma: no cover
                pass
            self._last_rays = 0.0

    def render_loop(
        self, frames: int, pipelined: bool = True,
        frames_per_dispatch: int = 1,
    ) -> None:
        """Convenience progressive loop (the external app's winit loop).

        `pipelined=True` (default) dispatches every frame without host
        synchronization and blocks once at the end — per-frame readbacks
        cost a full device round trip each. `pipelined=False` matches
        the reference's per-frame update/render cadence with live
        statistics.

        `frames_per_dispatch=K` (megakernel mode only) fuses K
        progressive frames into one XLA program via `render_frames` —
        bit-identical accumulation, but ONE dispatch per chunk."""
        if not pipelined:
            for _ in range(frames):
                self.update()
                self.render()
            return
        if frames_per_dispatch > 1 and not self._staged:
            from .integrator import render_frames

            if self.settings is None:
                self.commit()
            self.check_and_restore_device()
            t0 = time.monotonic()
            rays_acc = []
            left = min(frames, self.max_frames - self._frame_index)
            while left > 0:
                k = min(frames_per_dispatch, left)
                self.film, rays = render_frames(
                    self.scene, self.env, self.uniforms, self.film,
                    self._frame_index, k, self.settings,
                    blue_noise=self.blue_noise,
                    hooks=getattr(self, "hooks", None),
                )
                rays_acc.append(rays)
                self._frame_index += k
                left -= k
            self._pending = (self.film, rays_acc[-1] if rays_acc else 0.0)
            self.wait_idle()
            dt = max(time.monotonic() - t0, 1e-9)
            total = sum(float(r) for r in rays_acc)
            self.total_rays += total
            n = max(frames, 1)
            for _ in range(frames):
                self.statistics.record_frame(dt / n, dt / n, total / n)
            self.statistics.last_metrics = {
                "fps": n / dt,
                "gpu_ms": 1000.0 * dt / n,
                "cpu_ms": 1000.0 * dt / n,
                "mrays_per_s": total / dt / 1e6,
                "total_frames": self.statistics.total_frames,
                "synthetic_per_frame": True,
            }
            return
        t0 = time.monotonic()
        rays_acc = []
        for _ in range(frames):
            self.update()
            if self._last_rays is not None:
                rays_acc.append(self._last_rays)
                self._last_rays = 0.0
        self.wait_idle()
        dt = max(time.monotonic() - t0, 1e-9)
        total = float(sum(rays_acc)) if rays_acc else 0.0
        self.total_rays += total
        n = max(len(rays_acc), 1)
        # Per-frame gpu_ms/cpu_ms here are the aggregate wall time spread
        # uniformly over the frames: with no host sync inside the loop
        # there IS no per-frame timing to observe. Aggregate fps and
        # Mrays/s are exact; anything consuming per-frame numbers sees
        # the `synthetic_per_frame` flag.
        for _ in range(len(rays_acc)):
            self.statistics.record_frame(dt / n, dt / n, total / n)
        # aggregate metrics are always available after a pipelined loop
        self.statistics.last_metrics = {
            "fps": n / dt,
            "gpu_ms": 1000.0 * dt / n,
            "cpu_ms": 1000.0 * dt / n,
            "mrays_per_s": total / dt / 1e6,
            "total_frames": self.statistics.total_frames,
            "synthetic_per_frame": True,
        }

    # -- output ----------------------------------------------------------

    def get_final_image(self) -> np.ndarray:
        """Display path: exposure * accum through the tonemap chain,
        then the per-frame ui_fn overlay (rt_renderer.rs ui_fn role —
        drawn on the display image, so the accumulator stays clean)."""
        self.wait_idle()
        color = np.asarray(self.film.accum[..., :3]) * float(
            self.uniforms.exposure_value
        )
        img = apply_tonemap(
            jnp.asarray(color),
            self.enable_tonemap,
            self.enable_aces,
            self.use_simple_aces,
        )
        ui_fn = getattr(self, "_ui_fn", None)
        if ui_fn is not None:
            img = jax.jit(ui_fn)(img)
        return np.asarray(img)

    def save_images(self, path: str) -> None:
        """PFM export (rt_renderer.rs:1224-1352): color gets the tonemap
        operator chain, albedo/normal are raw."""
        if self.is_device_lost:
            logger.warning(
                "The device is lost! Please wait to reset the device and "
                "try again."
            )
            return
        self.wait_idle()
        stem, _ = os.path.splitext(path)
        color = np.asarray(self.film.accum)
        tonemapped = np.array(color)
        tonemapped[..., :3] = np.asarray(
            apply_tonemap(
                jnp.asarray(color[..., :3]),
                self.enable_tonemap,
                self.enable_aces,
                self.use_simple_aces,
            )
        )
        write_pfm(f"{stem}_color.pfm", tonemapped)
        logger.info("Save the color image to file: %s_color.pfm", stem)
        write_pfm(f"{stem}_albedo.pfm", np.asarray(self.film.albedo))
        logger.info("Save the albedo image to file: %s_albedo.pfm", stem)
        write_pfm(f"{stem}_normal.pfm", np.asarray(self.film.normal))
        logger.info("Save the normal image to file: %s_normal.pfm", stem)

    def reset_accumulation(self) -> None:
        """Restart progressive accumulation (fresh film + frame 0).

        Call after a scene edit (`set_node_transform` + `update_scene`)
        invalidates the running mean — the analog of a reference app
        zeroing `total_frames` so the accum image restarts
        (rt_renderer.rs:393-396, 414 frame-seeded sampling)."""
        self.wait_idle()
        self.film = Film.create(self.info.width, self.info.height)
        self._frame_index = 0

    # -- device restore ---------------------------------------------------

    def _restore_device_state(self) -> None:
        """rt_renderer.rs:508-563: recreate storage images + re-upload."""
        self.film = Film.create(self.info.width, self.info.height)
        self._frame_index = 0
        if self._host_scene is not None:
            self.set_scene(self._host_scene)
