"""Ray-tracing program: JSON desc -> configured integrator.

Parity: reference src/raytracing_program.rs (HalaRayTracingProgram{Desc}):
desc with raygen/miss/hit/callable shader path lists + ray_recursion_depth
(default 1, raytracing_program.rs:49-57), building a pipeline + SBT with
bind/trace_rays. JAX mapping: the shader stages name kernels in the
KernelCache (defaults are the built-in integrator stages — camera raygen,
environment miss, surface shading); `trace_rays(width, height)` runs one
progressive frame of `models.integrator.render_frame` with
max_depth = ray_recursion_depth. The SBT's role (stage dispatch table)
is the desc itself.
"""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp

from ..models.integrator import (
    ENV_SKY,
    Film,
    RenderSettings,
    Uniforms,
    render_frame,
)


@dataclasses.dataclass
class RayTracingProgramDesc:
    """raytracing_program.rs:25-47 JSON shape (serde defaults kept)."""

    ray_gen_shader_file_path: str = "builtin:raygen"
    miss_shader_file_paths: list[str] = dataclasses.field(
        default_factory=lambda: ["builtin:miss_env"]
    )
    hit_shader_file_paths: list[str] = dataclasses.field(
        default_factory=lambda: ["builtin:closest_hit"]
    )
    callable_shader_file_paths: list[str] = dataclasses.field(
        default_factory=lambda: ["builtin:bsdf"]
    )
    push_constant_size: int = 0
    ray_recursion_depth: int = 1   # serde default (raytracing_program.rs:49-57)
    rr_depth: int = 2
    env_type: int = ENV_SKY

    @staticmethod
    def from_json(text: str) -> "RayTracingProgramDesc":
        d = json.loads(text)
        out = RayTracingProgramDesc()
        for f in dataclasses.fields(out):
            if f.name in d:
                setattr(out, f.name, d[f.name])
        return out

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


class RayTracingProgram:
    def __init__(self, desc: RayTracingProgramDesc, scene, env=None):
        self.desc = desc
        self.scene = scene
        self.env = env

    def trace_rays(
        self,
        film: Film,
        width: int,
        height: int,
        frame_index=0,
        uniforms: Uniforms | None = None,
    ):
        """raytracing_program.rs:330-340 trace_rays: one frame dispatch."""
        settings = RenderSettings(
            width=width,
            height=height,
            max_depth=self.desc.ray_recursion_depth,
            rr_depth=self.desc.rr_depth,
            env_type=self.desc.env_type,
        )
        return render_frame(
            self.scene,
            self.env,
            uniforms or Uniforms.default(),
            film,
            jnp.asarray(frame_index, jnp.uint32),
            settings,
            hooks=self._resolve_hooks(),
        )

    def trace_rays_indirect(
        self,
        film: Film,
        pixel_count,
        width: int,
        height: int,
        frame_index=0,
        uniforms: Uniforms | None = None,
    ):
        """raytracing_program.rs:330-340 trace_rays_indirect: the trace
        dimensions are read from a DEVICE buffer (the reference's
        VkTraceRaysIndirectCommand). JAX analog: shapes must be static
        under XLA, so the full static grid is traced and `pixel_count`
        — a device-computed i32, never host-synced — masks which pixels
        commit to the film (row-major prefix, the exact set a
        {width, count/width} command would cover)."""
        import jax.numpy as _jnp

        new_film, rays = self.trace_rays(
            Film(
                accum=film.accum + 0.0,
                albedo=film.albedo + 0.0,
                normal=film.normal + 0.0,
            ),
            width, height, frame_index, uniforms,
        )
        pid = _jnp.arange(height * width, dtype=_jnp.int32).reshape(
            height, width, 1
        )
        keep = pid < _jnp.asarray(pixel_count, _jnp.int32)
        merged = Film(
            accum=_jnp.where(keep, new_film.accum, film.accum),
            albedo=_jnp.where(keep, new_film.albedo, film.albedo),
            normal=_jnp.where(keep, new_film.normal, film.normal),
        )
        return merged, rays

    def _resolve_hooks(self):
        """Resolve the desc's shader paths into the frame dispatch table
        (the SBT role): `builtin:*` keeps the built-in integrator stage,
        anything else loads through the KernelCache by import path.
        raygen -> sample-jitter seam, first miss path -> escape-radiance
        seam, first callable -> post-shade seam."""
        from ..models.integrator import KernelHooks
        from .shader_cache import KernelCache

        cache = KernelCache.get_instance()

        def resolve(path):
            if not path or path.startswith("builtin:"):
                return None
            return cache.load(path)

        miss = self.desc.miss_shader_file_paths
        call = self.desc.callable_shader_file_paths
        # Hit group tuple order follows the reference's push_hit_shaders
        # (rt_renderer.rs:1020-1112): [closest_hit, any_hit,
        # intersection]; trailing entries optional.
        hit = self.desc.hit_shader_file_paths
        hooks = KernelHooks(
            raygen=resolve(self.desc.ray_gen_shader_file_path),
            miss=resolve(miss[0]) if miss else None,
            post_shade=resolve(call[0]) if call else None,
            closest_hit=resolve(hit[0]) if len(hit) > 0 else None,
            any_hit=resolve(hit[1]) if len(hit) > 1 else None,
            intersection=resolve(hit[2]) if len(hit) > 2 else None,
        )
        if (hooks.raygen or hooks.miss or hooks.post_shade
                or hooks.closest_hit or hooks.any_hit
                or hooks.intersection):
            return hooks
        return None
