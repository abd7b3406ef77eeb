"""Renderer scaffolding: info, statistics, frame-loop base class.

Parity: reference src/renderer.rs:

* `RendererInfo` — name/width/height (renderer.rs:11-33);
* `RendererStatistics` — frame counter + GPU/CPU time accumulators with a
  once-per-second FPS/GPU-Time/CPU-Time/Total-Frames log line
  (renderer.rs:134-207, log at 188-194);
* `BaseRenderer` — the HalaRendererTrait analog (renderer.rs:210-324):
  commit/update/render/wait_idle plus device-restore. The swapchain
  acquire/submit/present machinery has no counterpart here (SURVEY.md
  "explicit non-goals"); its *roles* map to: update() = record+dispatch
  the jitted frame function, render() = block_until_ready + statistics,
  check_and_restore_device() = re-put buffers and re-jit after a device
  restart.

The reference's HalaRendererResources (context + command buffers +
256 MB staging buffer + descriptor pool, renderer.rs:36-113) is the
JAX runtime itself; no analog object is needed.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import jax
import numpy as np

from ..error import HalaRendererError

logger = logging.getLogger("hala_tpu.renderer")


@dataclasses.dataclass
class RendererInfo:
    """renderer.rs:11-33."""

    name: str
    width: int
    height: int


class RendererStatistics:
    """renderer.rs:134-207: totals + 1 Hz FPS log."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.total_frames = 0
        self.total_gpu_frame_time = 0.0  # seconds
        self.total_cpu_frame_time = 0.0
        self._last_log_time = time.monotonic()
        self._frames_since_log = 0
        self._gpu_since_log = 0.0
        self._cpu_since_log = 0.0
        self.last_metrics: dict = {}

    def record_frame(
        self, gpu_time: float, cpu_time: float, rays: float = 0.0
    ) -> None:
        self.total_frames += 1
        self.total_gpu_frame_time += gpu_time
        self.total_cpu_frame_time += cpu_time
        self._frames_since_log += 1
        self._gpu_since_log += gpu_time
        self._cpu_since_log += cpu_time
        self._rays_since_log = getattr(self, "_rays_since_log", 0.0) + rays
        now = time.monotonic()
        if now - self._last_log_time >= 1.0:
            dt = now - self._last_log_time
            fps = self._frames_since_log / dt
            gpu_ms = 1000.0 * self._gpu_since_log / self._frames_since_log
            cpu_ms = 1000.0 * self._cpu_since_log / self._frames_since_log
            mrays = self._rays_since_log / dt / 1e6
            self.last_metrics = {
                "fps": fps, "gpu_ms": gpu_ms, "cpu_ms": cpu_ms,
                "mrays_per_s": mrays, "total_frames": self.total_frames,
            }
            logger.info(
                "FPS: %.2f, GPU Time: %.3fms, CPU Time: %.3fms, "
                "Rays: %.2f Mrays/s, Total Frames: %d",
                fps, gpu_ms, cpu_ms, mrays, self.total_frames,
            )
            self._rays_since_log = 0.0
            self._last_log_time = now
            self._frames_since_log = 0
            self._gpu_since_log = 0.0
            self._cpu_since_log = 0.0


class BaseRenderer:
    """Frame-loop skeleton (HalaRendererTrait, renderer.rs:210-324)."""

    def __init__(self, name: str, width: int, height: int):
        self.info = RendererInfo(name, width, height)
        self.statistics = RendererStatistics()
        self.is_device_lost = False  # HalaRendererData parity (renderer.rs:119)
        self._pending = None  # in-flight device computation
        # animation path (ops/animate.py): staged node -> new world 4x4
        # and the CURRENT world each node's device geometry is baked at
        self._staged_transforms: dict[int, "np.ndarray"] = {}
        self._node_world: dict[int, "np.ndarray"] = {}

    # -- animation / per-frame transforms --------------------------------
    # (role of the reference's per-mesh object uniforms rewritten every
    # frame, rz_renderer.rs:38-53, 690-716, plus the BLAS refit)

    def set_node_transform(self, node_index: int, world) -> None:
        """Stage a new WORLD transform for a mesh node; applied by the
        next update_scene() with no host re-upload and no jit retrace."""
        self._staged_transforms[int(node_index)] = np.asarray(
            world, np.float32
        ).reshape(4, 4)

    def update_scene(self) -> None:
        """Apply staged node transforms on device: delta-retransform the
        node's triangles, re-derive shading attributes, refit cluster
        AABBs and repack the DMA blocks (ops/animate.py). The skip-link
        BVH (debug backend) is invalidated rather than refit."""
        if not self._staged_transforms:
            return
        import dataclasses as _dc

        import numpy as _np

        from ..ops.animate import build_deltas, retransform_geometry

        scene = getattr(self, "scene", None)
        host = getattr(self, "_host_scene", None)
        if scene is None or host is None:
            raise HalaRendererError("update_scene() before set_scene().")
        node_deltas = {}
        for ni, new_w in self._staged_transforms.items():
            cur = self._node_world.get(ni)
            if cur is None:
                cur = _np.asarray(
                    host.nodes[ni].world_transform, _np.float32
                )
            node_deltas[ni] = new_w @ _np.linalg.inv(cur)
            self._node_world[ni] = new_w
        deltas, ndeltas = build_deltas(
            scene.prim_node, node_deltas, len(host.nodes)
        )
        geom = retransform_geometry(scene.geometry, deltas, ndeltas)
        self.scene = _dc.replace(scene, geometry=geom, bvh=None)
        self._staged_transforms.clear()

    # -- trait surface ---------------------------------------------------

    def commit(self) -> None:
        """Build pipelines/descriptors — here: trigger jit compilation."""
        raise NotImplementedError

    def update(self, delta_time: float = 0.0) -> None:
        """Record + dispatch one frame."""
        raise NotImplementedError

    def render(self) -> None:
        """Submit/present analog: wait for the dispatched frame and feed
        statistics (renderer.rs:285-322 incl. device-lost catch)."""
        if self.is_device_lost:
            return
        try:
            t0 = time.monotonic()
            if self._pending is not None:
                jax.block_until_ready(self._pending)
                self._pending = None
            gpu_time = time.monotonic() - t0
            cpu_time = getattr(self, "_last_cpu_time", 0.0)
            rays = 0.0
            lr = getattr(self, "_last_rays", None)
            if lr is not None:
                try:
                    rays = float(lr)
                except (TypeError, ValueError):
                    pass
            self.statistics.record_frame(gpu_time, cpu_time, rays)
        except jax.errors.JaxRuntimeError as err:  # device lost analog
            logger.warning("Device error during render: %s", err)
            self.is_device_lost = True

    def wait_idle(self) -> None:
        """renderer.rs:251-256."""
        if self._pending is not None:
            jax.block_until_ready(self._pending)
            self._pending = None

    def check_and_restore_device(self) -> bool:
        """renderer.rs:234-247 / rt_renderer.rs:508-563 analog: drop
        compiled executables + re-upload state after a device restart.
        Returns True if a restore happened."""
        if not self.is_device_lost:
            return False
        logger.warning("Restoring device: clearing jit caches and state.")
        jax.clear_caches()
        self._restore_device_state()
        self.statistics.reset()
        self.is_device_lost = False
        return True

    def _restore_device_state(self) -> None:
        """Subclass hook: re-create device-resident images/buffers."""
