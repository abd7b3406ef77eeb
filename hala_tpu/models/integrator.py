"""Path-tracing integrator core: the JAX replacement for the reference's
raygen/closest-hit/miss/callable SPIR-V shader set.

The algorithm parameters surfaced by the reference renderer are all
honored (SURVEY.md section 2.2): max bounce depth + Russian-roulette
start depth (rt_renderer.rs:572-573), frame-index-seeded progressive
accumulation (rt_renderer.rs:408-427), NEE over the analytic light list
with MIS, envmap CDF importance sampling, DOF camera, two-sided shading
with Oren-Nayar/Disney BSDF dispatch, and albedo/normal AOVs on first
hit.

Shape discipline: rays are flat (N,) SoA batches; the film is updated in
static-size tiles via lax.scan, keeping peak memory at
O(tile x triangle-chunk) while staying a single jitted computation.
"""

from __future__ import annotations

import dataclasses
from functools import partial
import jax
import jax.numpy as jnp

from ..error import HalaRendererError
from ..ops import rng
from ..ops.bsdf import bsdf_eval, bsdf_sample, gather_materials
from ..ops.bvh import intersect_bvh, occluded_bvh
from ..ops.camera import generate_rays
from ..ops.env import env_eval, env_radiance, env_sample, sky_radiance
from ..ops.intersect import (
    T_MAX,
    intersect_bruteforce,
    occluded_bruteforce,
)
from ..ops.lights import intersect_lights, sample_one_light
from ..ops.sampling import (
    build_basis,
    dot,
    normalize,
    power_heuristic,
    to_local,
    to_world,
)
from ..ops.texture import sample_texture

ENV_SKY = 0  # rt_renderer.rs:23-41 HalaEnvType
ENV_MAP = 1

_RAY_EPS = 1e-4

@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static (compile-time) integrator configuration.

    `intersector` selects the visibility backend. The default "auto"
    resolves from the jax platform (see auto_intersector): the Pallas
    brute-force kernel through Triton on a GPU, the plain XLA brute
    force on the CPU. Explicit values:
      - "pallas": ops/pallas/intersect_kernel.py (GPU; on the CPU only
        with `interpret_pallas=True`, the test switch)
      - "bruteforce": chunked jnp scan (any backend; the ground truth)
      - "bvh": skip-link BVH traversal (ops/bvh.py; needs scene.bvh)
    """

    width: int
    height: int
    max_depth: int = 4
    rr_depth: int = 2
    env_type: int = ENV_SKY
    tile_size: int = 65536
    chunk: int = 2048  # brute-force triangle chunk
    intersector: str = "auto"
    interpret_pallas: bool = False
    # Max alpha-tested surfaces a shadow ray may stochastically pass
    # through (any-hit-shader parity: the reference's hit shaders can
    # continue through stacked transparent surfaces). 1 = legacy
    # single-blocker test; extra surfaces each cost one more batched
    # visibility dispatch per bounce and only compile in when the scene
    # has alpha materials.
    shadow_surfaces: int = 3
    # Samples per progressive frame, dispatched sample-adjacent: all S
    # samples of a pixel sit in consecutive lanes. Sample s of frame f
    # uses virtual RNG frame f*spp+s, so a spp=S frame equals S
    # sequential spp=1 frames up to accumulation rounding.
    spp: int = 1
    # Geometry-sharded (tensor-parallel) rendering: the mesh-axis name
    # the scene's triangle arrays + shade rows are sharded over
    # (parallel/scene_shard.py). Visibility queries all-gather the rays
    # over the axis, intersect the LOCAL triangle shard, and merge the
    # per-shard hits with a lexicographic-(t, tri) min — bit-identical
    # to the unsharded render by construction (the min over a partition
    # of the triangle set is the global min). Winner shade rows come
    # back through one owner-masked psum per bounce. None = replicated
    # scene (the default film-tiling mode).
    scene_axis: str | None = None


@dataclasses.dataclass(frozen=True)
class KernelHooks:
    """Pushed-kernel dispatch table — the JAX analog of the reference's
    shader-push / SBT stage binding (rt_renderer.rs:925-1112,
    raytracing_program.rs:330-340), where the pushed SPIR-V stages are
    the ONLY way an app supplies behavior. Here the built-in integrator
    stages are the defaults and a pushed kernel overrides its seam:

    - raygen(gpix, frame_index, r_jit) -> (N, 4): override the per-pixel
      sample jitter (pixel xy in [:, :2], lens uv in [:, 2:]) before
      camera ray generation — the raygen-shader seam.
    - miss(d, uniforms, default_radiance) -> (N, 3): radiance for rays
      that leave the scene — the miss-shader seam (the default is the
      sky gradient / environment map).
    - post_shade(radiance, albedo, normal) -> same triple: transform a
      traced tile's outputs before film accumulation — the
      callable-shader seam.
    - closest_hit(ctx, mp) -> mp: override the resolved material
      parameters at the shading point (ctx: dict with p/ns/ng/uv/wo/t/
      tri/mat/on_surface arrays) — the closest-hit-shader seam, run
      after texture fetch and before every BSDF/NEE consumer
      (rt_renderer.rs:1016-1112 push_hit_shaders, TRIANGLES group).
    - any_hit(ctx, mp, r, default_pass) -> bool (N,): decide stochastic
      pass-through (True = ignore the hit and continue the ray) given
      the per-lane RNG draw `r` and the built-in alpha-test decision —
      the any-hit-shader seam (alpha/shadow pass-through role).
    - intersection(o, d, lhit) -> lhit: intersect custom procedural
      primitives and merge them into the analytic light-set hit
      (LightHit fields t/radiance/pdf) — the intersection-shader seam.
      The reference's only in-repo hit group with an intersection
      shader is the procedural LIGHT group at SBT offset 1
      (gpu_uploader.rs:877-885); this seam covers exactly that role:
      closer procedural hits terminate the path with their radiance.

    Hooks are traced into the frame jit (static identity), so pushing a
    different kernel recompiles, exactly like swapping a pipeline.
    """

    raygen: object = None
    miss: object = None
    post_shade: object = None
    closest_hit: object = None
    any_hit: object = None
    intersection: object = None


def _register(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(
        cls, data_fields=tuple(fields), meta_fields=()
    )
    return cls


@_register
@dataclasses.dataclass
class Uniforms:
    """Dynamic per-frame values (HalaGlobalUniform parity,
    rt_renderer.rs:44-65). env_rotation is pre-normalized by /360
    (rt_renderer.rs:420)."""

    ground_color: jax.Array   # (3,)
    sky_color: jax.Array      # (3,)
    env_intensity: jax.Array  # ()
    env_rotation: jax.Array   # ()
    exposure_value: jax.Array  # ()
    camera_index: jax.Array   # () i32

    @staticmethod
    def default() -> "Uniforms":
        return Uniforms(
            ground_color=jnp.asarray([0.5, 0.5, 0.5]),
            sky_color=jnp.asarray([0.5, 0.7, 0.9]),
            env_intensity=jnp.float32(1.0),
            env_rotation=jnp.float32(0.0),
            exposure_value=jnp.float32(1.0),
            camera_index=jnp.int32(0),
        )


@_register
@dataclasses.dataclass
class Film:
    """Accumulation + AOV images (the 4 storage images of
    rt_renderer.rs:818-917; `final` is derived on demand)."""

    accum: jax.Array   # (H, W, 4) running mean radiance
    albedo: jax.Array  # (H, W, 4)
    normal: jax.Array  # (H, W, 4)

    @staticmethod
    def create(width: int, height: int) -> "Film":
        # Three distinct buffers: the frame function donates the film, and
        # XLA rejects donating one buffer through multiple arguments.
        z = lambda: jnp.zeros((height, width, 4), jnp.float32)
        return Film(accum=z(), albedo=z(), normal=z())


_BACKENDS = ("auto", "pallas", "bruteforce", "bvh")


def auto_intersector(platform: str) -> str:
    """The visibility engine "auto" resolves to on a jax platform: the
    Pallas kernel through Triton on a GPU, the XLA reference on the
    CPU. Any other platform has no engine here and raises."""
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "bruteforce"
    raise HalaRendererError(
        f"no visibility engine for jax platform {platform!r} "
        "(supported: gpu, cpu)"
    )


def _backend(settings: RenderSettings, scene) -> str:
    """Resolve the visibility backend (trace-time: scene shapes and the
    jax platform are static)."""
    sel = settings.intersector
    if sel not in _BACKENDS:
        raise ValueError(
            f"Unknown intersector {sel!r}; expected one of {_BACKENDS}"
        )
    if sel == "auto":
        sel = auto_intersector(jax.default_backend())
    if sel == "bvh" and (
        scene.bvh is None or settings.scene_axis is not None
    ):
        # the BVH's global slot ids assume the unsharded layout (the
        # node table is replicated while tri_v0 is the local 1/n shard)
        return "bruteforce"
    return sel


def _owner_sum(x, own, ax):
    """Reduce-scatter of values only their owner holds (`own` masks the
    rows), bit-exact: float rows travel as int32 bit patterns, so the
    other shards' zeros cannot turn the owner's -0.0 into +0.0 (a float
    sum would). Each shard gets its own segment of the rows."""
    is_float = jnp.issubdtype(x.dtype, jnp.floating)
    bits = jax.lax.bitcast_convert_type(x, jnp.int32) if is_float else x
    mask = own if own.ndim == bits.ndim else own[:, None]
    out = jax.lax.psum_scatter(
        jnp.where(mask, bits, 0), ax, scatter_dimension=0, tiled=True
    )
    return jax.lax.bitcast_convert_type(out, x.dtype) if is_float else out


def _rows_sharded(table, idx, ax):
    """Owner-masked fetch from a row-sharded table — the tensor-parallel
    embedding-lookup pattern. Every shard's ray batch may need rows
    owned by any shard, so the GLOBAL row ids are all-gathered first;
    each shard serves the gathered queries it owns (clamped local take),
    one psum returns the owners' rows everywhere, and each shard keeps
    its own segment. `idx` must be pre-clamped >= 0."""
    n = idx.shape[0]
    idx_g = jax.lax.all_gather(idx, ax, axis=0, tiled=True)
    rows_local = table.shape[0]
    me = jax.lax.axis_index(ax).astype(jnp.int32)
    lid = jnp.clip(idx_g - me * rows_local, 0, rows_local - 1)
    own = (idx_g // rows_local) == me
    # reduce-scatter, not psum+slice: each shard only needs its own
    # ray segment, so the interconnect payload drops by the axis size
    return _owner_sum(jnp.take(table, lid, axis=0), own, ax)


def _merge_proc(scene, o, d, hit, t_max):
    """Fold procedural sphere hits into the triangle Hit (the
    PROCEDURAL hit-group merge, rt_renderer.rs:1016-1112 role).
    Procedural ids live at tri >= PROC_BASE, above every triangle slot
    id including sharded global ids, so all downstream Hit plumbing is
    unchanged. Spheres are replicated across shards (tiny table), so
    the per-shard merge is deterministic and identical everywhere."""
    if scene.procedural is None:
        return hit
    from ..ops.prims import merge_procedural

    return merge_procedural(scene.procedural, o, d, hit, t_max)


def _intersect(scene, o, d, settings: RenderSettings, t_max=None):
    """Closest-hit dispatch; with settings.scene_axis set, the
    geometry-sharded merge wraps the local backend query."""
    if settings.scene_axis is None:
        return _merge_proc(
            scene, o, d, _intersect_local(scene, o, d, settings, t_max)[0],
            t_max,
        )
    ax = settings.scene_axis
    n = o.shape[0]
    og = jax.lax.all_gather(o, ax, axis=0, tiled=True)
    dg = jax.lax.all_gather(d, ax, axis=0, tiled=True)
    tg = None
    if t_max is not None:
        tm = jnp.broadcast_to(t_max, (n,)).astype(jnp.float32)
        tg = jax.lax.all_gather(tm, ax, axis=0, tiled=True)
    hit, t_rank = _intersect_local(scene, og, dg, settings, tg)
    # globalize the shard-local triangle ids (slot arrays are sliced in
    # cluster-block order, so global id = local id + shard slot offset)
    slots = scene.geometry.tri_v0.shape[0]
    me = jax.lax.axis_index(ax).astype(jnp.int32)
    tri_g = jnp.where(
        hit.tri >= 0, hit.tri + me * jnp.int32(slots), jnp.int32(-1)
    )
    # lexicographic (t_rank, tri) min across shards: t_rank is the t
    # the engine ranked triangles by, a function of (ray, triangle)
    # alone, so the cross-shard min picks the single-device winner
    # (ties break to the smaller global tri, the single-device tie
    # order)
    imax = jnp.int32(2**31 - 1)
    t_min = jax.lax.pmin(t_rank, ax)
    cand = (t_rank == t_min) & (tri_g >= 0)
    tri_w = jax.lax.pmin(jnp.where(cand, tri_g, imax), ax)
    win = cand & (tri_g == tri_w)
    # the winner's (t, u, v) ride a reduce-scatter (each shard needs
    # only its segment); tri needs the full pmin (no min-scatter
    # collective exists) and is sliced after, and so is t for rays no
    # shard hit
    tuv = _owner_sum(jnp.stack([hit.t, hit.u, hit.v], axis=-1), win, ax)
    tri_f = jnp.where(tri_w == imax, jnp.int32(-1), tri_w)
    i0 = jax.lax.axis_index(ax) * n
    sl = lambda x: jax.lax.dynamic_slice_in_dim(x, i0, n, 0)
    tri_s = sl(tri_f)
    from ..ops.intersect import Hit as _H

    return _merge_proc(
        scene, o, d,
        _H(t=jnp.where(tri_s >= 0, tuv[:, 0], sl(t_min)), tri=tri_s,
           u=tuv[:, 1], v=tuv[:, 2]),
        t_max,
    )


def _num_real(g, settings: RenderSettings) -> int:
    """Triangle slots the kernel must scan: the real prefix of the
    Morton tail-padded layout, every slot otherwise (the binned-SAH
    layout scatters real triangles past num_triangles, and a scene shard
    holds its own slice of the slot arrays)."""
    if g.prefix_layout and settings.scene_axis is None:
        return g.num_triangles
    return g.tri_v0.shape[0]


def _intersect_local(scene, o, d, settings: RenderSettings, t_max=None):
    """Closest hit on this device's triangles: (hit, t_rank), where
    t_rank is the t the engine ranked triangles by (the cross-shard
    merge key)."""
    g = scene.geometry
    backend = _backend(settings, scene)
    if backend == "pallas":
        from ..ops.pallas.intersect_kernel import intersect_pallas_ranked

        return intersect_pallas_ranked(
            o, d, g.tri_v0, g.tri_e1, g.tri_e2, t_max=t_max,
            interpret=settings.interpret_pallas,
            num_real=_num_real(g, settings),
        )
    if backend == "bvh":
        hit = intersect_bvh(scene.bvh, g, o, d, t_max=t_max)
    else:
        hit = intersect_bruteforce(
            o, d, g.tri_v0, g.tri_e1, g.tri_e2, t_max=t_max,
            chunk=settings.chunk,
        )
    return hit, hit.t


def _occluded(scene, o, d, t_far, settings: RenderSettings):
    """Any-hit dispatch; with settings.scene_axis set, per-shard
    occlusion ORs across the scene axis (a blocker on ANY shard
    occludes). Procedural spheres join as one more any-hit OR (the
    PROCEDURAL hit-group's any-hit role) on the caller-shaped rays —
    in sharded mode the table is replicated, so testing the local rays
    once is exact."""
    if settings.scene_axis is None:
        occ = _occluded_local(scene, o, d, t_far, settings)
    else:
        ax = settings.scene_axis
        n = o.shape[0]
        og = jax.lax.all_gather(o, ax, axis=0, tiled=True)
        dg = jax.lax.all_gather(d, ax, axis=0, tiled=True)
        tfg = jax.lax.all_gather(
            jnp.broadcast_to(t_far, (n,)).astype(jnp.float32),
            ax, axis=0, tiled=True,
        )
        occ = _occluded_local(scene, og, dg, tfg, settings)
        # OR across shards via a reduce-scatter of the int mask
        occ = jax.lax.psum_scatter(
            occ.astype(jnp.int32), ax, scatter_dimension=0, tiled=True
        ) > 0
    if scene.procedural is not None:
        from ..ops.prims import occluded_spheres

        occ = occ | occluded_spheres(scene.procedural, o, d, t_far)
    return occ


def _occluded_local(scene, o, d, t_far, settings: RenderSettings):
    g = scene.geometry
    backend = _backend(settings, scene)
    if backend == "pallas":
        from ..ops.pallas.intersect_kernel import occluded_pallas

        return occluded_pallas(
            o, d, t_far, g.tri_v0, g.tri_e1, g.tri_e2,
            interpret=settings.interpret_pallas,
            num_real=_num_real(g, settings),
        )
    if backend == "bvh":
        return occluded_bvh(scene.bvh, g, o, d, t_far)
    return occluded_bruteforce(
        o, d, t_far, g.tri_v0, g.tri_e1, g.tri_e2, chunk=settings.chunk
    )


def _env_miss_radiance(env, uniforms: Uniforms, d, settings: RenderSettings):
    if settings.env_type == ENV_MAP and env is not None:
        return env_radiance(env, d, uniforms.env_rotation, uniforms.env_intensity)
    return (
        sky_radiance(d, uniforms.ground_color[None, :], uniforms.sky_color[None, :])
        * uniforms.env_intensity
    )


def _path_context(
    scene,
    env,
    uniforms: Uniforms,
    pixel_idx: jnp.ndarray,
    frame_index,
    settings: RenderSettings,
    full_height: int | None = None,
    hooks: KernelHooks | None = None,
    blue_noise=None,
):
    """Build the per-trace path-tracing closures.

    Returns (init_state, bounce_pre, bounce_post, bounce_body):
    `bounce_body` is the fused fori_loop body `trace_paths` runs inside
    ONE jit (the megakernel frame), while (bounce_pre, bounce_post)
    expose the same bounce split at the visibility-query seam so
    `render_frame_staged` can dispatch each visibility query as its own
    small jit. Splitting `bounce_body = bounce_post . queries .
    bounce_pre` keeps both paths byte-identical in math and RNG order.
    """
    from ..ops.intersect import varying_like

    geom = scene.geometry
    has_env_map = settings.env_type == ENV_MAP and env is not None

    if blue_noise is None:
        def s4(bounce, seed):
            return rng.sample4(pixel_idx, frame_index, bounce, seed=seed)
    else:
        # Blue-noise low-discrepancy sampling for EVERY dimension
        # (rt_renderer.rs:1117-1156 binding-5 parity): per-pixel texel +
        # per-(frame, bounce, stream) Cranley-Patterson rotation. Screen
        # coords derive from the GLOBAL pixel id, so the multi-chip
        # bit-identity invariant holds with blue noise enabled.
        bn_px = pixel_idx % settings.width
        bn_py = pixel_idx // settings.width

        def s4(bounce, seed):
            return rng.bn_sample4(
                blue_noise, bn_px, bn_py, frame_index, bounce, seed
            )
    # Scene capability specialization (cpu/scene.rs probe analog): BSDF
    # lobes unused by every material compile out of the megakernel.
    w_disney = bool(scene.materials.has_disney)
    w_trans = bool(scene.materials.has_transmission)
    w_scatter = bool(getattr(scene.materials, "has_scatter_medium", False))
    # Static per scene: without alpha materials (no stochastic
    # pass-through) shadow rays go to an ANY-HIT query of their own,
    # whose ray blocks retire on the first blocker; with them, shadow
    # rays ride the closest-hit batch so `transmit` can walk the
    # blockers' opacities.
    split_shadow = not scene.materials.has_alpha

    # Per-pixel cone angle for mip LOD (texture footprint ~ dist * angle).
    cam_yfov = scene.cameras.yfov[uniforms.camera_index]
    fh = full_height if full_height is not None else settings.height
    pixel_angle = 2.0 * jnp.tan(0.5 * jnp.maximum(cam_yfov, 1e-3)) / fh

    from ..ops.intersect import Hit as _Hit

    def init_state(o, d, hit0):
        # Carries derived from `o` so their varying-axes type survives
        # shard_map (see ops/intersect.varying_like).
        zeros3 = varying_like(o, 0.0)
        zeros = zeros3[:, 0]
        return dict(
            o=o,
            d=d,
            hit_t=hit0.t,
            hit_tri=hit0.tri,
            hit_u=hit0.u,
            hit_v=hit0.v,
            throughput=zeros3 + 1.0,
            radiance=zeros3,
            active=zeros < 1.0,
            prev_pdf=zeros,  # 0 => previous bounce was camera/delta
            albedo=zeros3,
            normal=zeros3,
            rays=zeros + 1.0,  # the primary ray
            path_dist=zeros,   # accumulated path length (mip LOD cone)
            med_density=zeros,     # >0 while inside a SCATTER medium
            med_g=zeros,           # phase anisotropy of the current medium
            med_color=zeros3,      # single-scatter albedo
        )

    def bounce_pre(bounce, st):
        o, d = st["o"], st["d"]
        n = o.shape[0]
        zeros3 = varying_like(o, 0.0)
        zeros = zeros3[:, 0]
        active = st["active"]
        throughput = st["throughput"]
        radiance = st["radiance"]
        prev_pdf = st["prev_pdf"]
        rays = st["rays"]

        hit = _Hit(t=st["hit_t"], tri=st["hit_tri"], u=st["hit_u"], v=st["hit_v"])
        lhit = intersect_lights(scene.lights, o, d)
        if hooks is not None and hooks.intersection is not None:
            # intersection-shader seam: custom procedural primitives
            # merge into the analytic light-set hit (the reference's
            # procedural light hit group at SBT offset 1,
            # gpu_uploader.rs:877-885).
            lhit = hooks.intersection(o, d, lhit)

        # --- SCATTER media: free-flight distance sampling ----------------
        # Rays inside a scattering medium may scatter before reaching the
        # surface hit; the surviving-to-surface case needs no weight (the
        # transmittance cancels against the sampling pdf). Single-scatter
        # v1: no NEE from the scatter point (area/env lights are reached
        # via phase-sampled continuation + MIS).
        if w_scatter:
            r_med = s4(bounce, 29)
            med_density = st["med_density"]
            t_free = -jnp.log(jnp.maximum(1.0 - r_med[:, 0], 1e-7)) / (
                jnp.maximum(med_density, 1e-7)
            )
            scatter = active & (med_density > 0.0) & (t_free < hit.t)
            effective_t = jnp.where(scatter, t_free, hit.t)
        else:
            scatter = zeros > 1.0
            effective_t = hit.t

        light_first = lhit.t < effective_t
        # --- emissive light hit (MIS vs the NEE strategy) ---------------
        w_light = jnp.where(
            prev_pdf > 0.0, power_heuristic(prev_pdf, lhit.pdf), 1.0
        )
        radiance = radiance + jnp.where(
            (active & light_first)[:, None],
            throughput * lhit.radiance * w_light[:, None],
            0.0,
        )

        # --- miss: environment (not if the ray scattered first) ----------
        miss = (hit.tri < 0) & ~scatter
        if has_env_map:
            # fused: one dir->equirect transform for radiance AND pdf
            env_rad, pdf_e = env_eval(
                env, d, uniforms.env_rotation, uniforms.env_intensity
            )
            w_env = jnp.where(
                prev_pdf > 0.0, power_heuristic(prev_pdf, pdf_e), 1.0
            )
        else:
            env_rad = _env_miss_radiance(env, uniforms, d, settings)
            w_env = jnp.ones((n,))
        if hooks is not None and hooks.miss is not None:
            # pushed miss kernel overrides the escape radiance
            env_rad = hooks.miss(d, uniforms, env_rad)
        radiance = radiance + jnp.where(
            (active & miss & ~light_first)[:, None],
            throughput * env_rad * w_env[:, None],
            0.0,
        )

        active = active & ~miss & ~light_first
        on_surface = active & ~scatter

        # --- shading point ----------------------------------------------
        # One row-gather of the packed shade table per hit (shade_table
        # layout documented in scene/gpu/scene.py) — keeps the gather
        # count per bounce O(1), which the frame profile demands.
        tid = jnp.maximum(hit.tri, 0)
        u, v = hit.u, hit.v
        w0 = 1.0 - u - v
        rows = (
            jnp.take(geom.shade_table, tid, axis=0)  # (N, 32)
            if settings.scene_axis is None
            else _rows_sharded(geom.shade_table, tid, settings.scene_axis)
        )
        ns = normalize(
            w0[:, None] * rows[:, 0:3]
            + u[:, None] * rows[:, 3:6]
            + v[:, None] * rows[:, 6:9]
        )
        uv = (
            w0[:, None] * rows[:, 9:11]
            + u[:, None] * rows[:, 11:13]
            + v[:, None] * rows[:, 13:15]
        )
        ng = rows[:, 15:18]
        # orient geometric normal along shading normal
        ng = jnp.where(dot(ng, ns)[:, None] < 0, -ng, ng)
        hit_p = o + hit.t[:, None] * d

        mat_idx = rows[:, 18].astype(jnp.int32)
        # Procedural sphere hits (tri >= PROC_BASE, ops/prims.py): the
        # triangle-derived attributes above came from a clipped garbage
        # row — override them with the analytic sphere attributes (the
        # intersection-shader's hit-attribute write, then the standard
        # closest-hit shading path: full material/texture/media system
        # applies). hit.u/v already carry the spherical uv.
        if scene.procedural is not None:
            from ..ops.prims import PROC_BASE

            proc_t = scene.procedural
            is_proc = hit.tri >= PROC_BASE
            pid = jnp.clip(
                hit.tri - PROC_BASE, 0, proc_t.center.shape[0] - 1
            )
            prow = jnp.take(proc_t.packed, pid, axis=0)  # (N, 8)
            ns_p = normalize(hit_p - prow[:, 0:3])
            ns = jnp.where(is_proc[:, None], ns_p, ns)
            ng = jnp.where(is_proc[:, None], ns_p, ng)
            uv = jnp.where(
                is_proc[:, None], jnp.stack([u, v], axis=1), uv
            )
            mat_idx = jnp.where(
                is_proc, prow[:, 4].astype(jnp.int32), mat_idx
            )
        else:
            is_proc = None
        mp = gather_materials(scene.materials, mat_idx)
        # Vertex colors (COLOR_0): present iff the uploader widened the
        # shade row (static shape -> compiles out otherwise); glTF
        # multiplies them into base color.
        if rows.shape[1] > 32:
            vcol = (
                w0[:, None] * rows[:, 32:35]
                + u[:, None] * rows[:, 35:38]
                + v[:, None] * rows[:, 38:41]
            )
            if is_proc is not None:
                vcol = jnp.where(is_proc[:, None], 1.0, vcol)
            mp = mp._replace(base_color=mp.base_color * vcol)
        # KHR_texture_transform: uv' = offset + R(rot) @ (scale * uv)
        # (spec order T*R*S), from the material's baseColorTexture
        # binding, applied to every map (single UV set).
        if getattr(scene.materials, "has_uv_transform", False):
            uvt = jnp.take(
                scene.materials.uv_transform, jnp.maximum(mat_idx, 0), axis=0)
            su = uv[:, 0] * uvt[:, 3]
            sv = uv[:, 1] * uvt[:, 4]
            cr = jnp.cos(uvt[:, 2])
            sr = jnp.sin(uvt[:, 2])
            uv = jnp.stack(
                [
                    uvt[:, 0] + cr * su + sr * sv,
                    uvt[:, 1] - sr * su + cr * sv,
                ],
                axis=1,
            )
        path_dist = st["path_dist"] + effective_t * active.astype(jnp.float32)

        # Interpolated tangent, Gram-Schmidt-orthonormalized against ns:
        # the UV-aligned shading frame (anisotropy + normal mapping).
        tan_raw = (
            w0[:, None] * rows[:, 20:23]
            + u[:, None] * rows[:, 23:26]
            + v[:, None] * rows[:, 26:29]
        )
        if is_proc is not None:
            # spheres carry no authored tangents: zero forces the
            # branchless fallback basis below
            tan_raw = jnp.where(is_proc[:, None], 0.0, tan_raw)
        tan_proj = tan_raw - ns * dot(tan_raw, ns)[:, None]
        tan_len = jnp.sqrt(jnp.sum(tan_proj * tan_proj, axis=-1, keepdims=True))
        has_tan = tan_len[:, 0] > 1e-4

        # ONE packed texel gather for ALL material maps of the bounce:
        # base/mr/emission at the trilinear lod plus (when present) the
        # normal map at level 0 — per-map lods, one big take (the
        # per-row take law: each separate take pays the same per-row
        # cost again; ops/texture.py sample_textures_packed). Only the
        # integer corner addresses concatenate; every float expression
        # keeps its per-map shape, so outputs stay bit-identical to
        # separate calls and the film-tiling invariant holds.
        base_t = mr_t = em_t = n_tex = None
        if scene.textures is not None:
            uv_dens = rows[:, 29]
            if is_proc is not None:
                # uv density of the spherical parameterization:
                # ~1/(2*pi*r) texels-per-world-unit at the equator
                uv_dens = jnp.where(
                    is_proc,
                    1.0 / jnp.maximum(
                        2.0 * jnp.pi * jnp.take(
                            scene.procedural.packed, pid, axis=0)[:, 3],
                        1e-6,
                    ),
                    uv_dens,
                )
            # mip LOD: log2(path cone footprint x per-tri uv density)
            lod_uv = jnp.log2(
                jnp.clip(path_dist * pixel_angle * uv_dens, 1e-6, 1e6)
            )
            from ..ops.texture import sample_textures_packed

            maps = [
                mp.base_color_map, mp.metallic_roughness_map,
                mp.emission_map,
            ]
            map_lods = [lod_uv, lod_uv, lod_uv]
            if scene.materials.has_normal_map:
                maps.append(mp.normal_map)
                map_lods.append(None)  # level-0 bilinear, as before
            fetched = sample_textures_packed(
                scene.textures, maps, uv, lods=map_lods
            )
            base_t, mr_t, em_t = fetched[:3]
            if scene.materials.has_normal_map:
                n_tex = fetched[3]

        # Normal mapping (material normal_map, tangent-space +Z up).
        if scene.textures is not None and scene.materials.has_normal_map:
            n_t = n_tex[:, :3]
            n_ts = normalize(n_t * 2.0 - 1.0)
            tb0 = jnp.where(
                has_tan[:, None], tan_proj / jnp.maximum(tan_len, 1e-12), 0.0
            )
            bt0 = jnp.cross(ns, tb0)
            mapped = normalize(
                n_ts[:, 0:1] * tb0 + n_ts[:, 1:2] * bt0 + n_ts[:, 2:3] * ns
            )
            use_map = has_tan & (mp.normal_map >= 0)
            ns = jnp.where(use_map[:, None], mapped, ns)

        entering = dot(ns, -d) >= 0.0
        ns_f = jnp.where(entering[:, None], ns, -ns)  # two-sided frame
        ng_f = jnp.where(entering[:, None], ng, -ng)
        # UV-aligned tangent frame where a valid tangent exists (so
        # anisotropic ax/ay align with the surface parameterization);
        # branchless fallback basis otherwise.
        t_fb, b_fb = build_basis(ns_f)
        tan_f = tan_raw - ns_f * dot(tan_raw, ns_f)[:, None]
        tan_fl = jnp.sqrt(jnp.sum(tan_f * tan_f, axis=-1, keepdims=True))
        has_tan_f = tan_fl[:, 0] > 1e-4
        t_b = jnp.where(
            has_tan_f[:, None], tan_f / jnp.maximum(tan_fl, 1e-12), t_fb
        )
        b_b = jnp.where(
            has_tan_f[:, None], jnp.cross(ns_f, t_b), b_fb
        )
        wo_l = to_local(-d, t_b, b_b, ns_f)
        wo_l = wo_l.at[:, 2].set(jnp.maximum(wo_l[:, 2], 1e-5))
        if scene.textures is not None:
            mr_map = mp.metallic_roughness_map
            # base_t/mr_t/em_t were fetched in the single packed take
            # above (with the normal map when present)
            new_rough_raw = mr_t[:, 1]  # glTF: G=roughness, B=metallic
            new_metal = mp.metallic * mr_t[:, 2]
            # re-apply the Disney alpha precompute for textured roughness
            has_mr = mr_map >= 0
            alpha = jnp.clip((new_rough_raw) ** 2, 1e-4, 1.0)
            mp = mp._replace(
                base_color=mp.base_color * base_t[:, :3],
                emission=mp.emission * em_t[:, :3],
                metallic=jnp.where(has_mr, new_metal, mp.metallic),
                roughness=jnp.where(has_mr, alpha, mp.roughness),
                ax=jnp.where(has_mr, jnp.maximum(alpha, 1e-3), mp.ax),
                ay=jnp.where(has_mr, jnp.maximum(alpha, 1e-3), mp.ay),
            )
        # refraction relative ior: entering -> ior, exiting -> 1/ior
        mp = mp._replace(
            ior=jnp.where(entering, mp.ior, 1.0 / jnp.maximum(mp.ior, 1e-3))
        )

        hit_ctx = None
        if hooks is not None and (
            hooks.closest_hit is not None or hooks.any_hit is not None
        ):
            hit_ctx = dict(
                p=hit_p, ns=ns_f, ng=ng_f, uv=uv,
                wo=-d, t=hit.t, tri=hit.tri, mat=mat_idx,
                on_surface=on_surface,
            )
        if hooks is not None and hooks.closest_hit is not None:
            # closest-hit-shader seam: the pushed kernel sees the fully
            # resolved shading context and returns (possibly rewritten)
            # material params consumed by every BSDF/NEE site below.
            mp = hooks.closest_hit(hit_ctx, mp)

        # Beer-Lambert absorption (cpu/material.rs ABSORB medium): a
        # backface hit means the segment just traversed was interior.
        if scene.materials.has_absorb_medium:
            interior = (~entering) & on_surface
            atten = jnp.exp(-mp.medium_sigma * hit.t[:, None])
            throughput = jnp.where(
                interior[:, None], throughput * atten, throughput
            )

        # EMISSIVE medium (HalaMediumType::EMISSIVE,
        # /root/reference/src/scene/cpu/material.rs:57): volumetric
        # emission accumulated along interior segments,
        # L += throughput * color * density * segment_length (the
        # GLSL-PathTracer-family transport this material model follows;
        # optically thin, no self-absorption). Stateless like ABSORB: a
        # backface hit means the traversed segment was interior.
        if scene.materials.has_emissive_medium:
            safe_mat = jnp.maximum(mat_idx, 0)
            em_medium = (
                jnp.take(scene.materials.medium_type, safe_mat) == 3
            )
            em_color = jnp.take(
                scene.materials.medium_color, safe_mat, axis=0
            )
            em_density = jnp.take(scene.materials.medium_density, safe_mat)
            interior_e = (~entering) & on_surface & em_medium
            radiance = radiance + jnp.where(
                interior_e[:, None],
                throughput * em_color * (em_density * hit.t)[:, None],
                0.0,
            )

        # --- AOVs on first hit ------------------------------------------
        first = bounce == 0
        st_albedo = jnp.where(
            (first & on_surface)[:, None], mp.base_color, st["albedo"]
        )
        st_normal = jnp.where((first & on_surface)[:, None], ns, st["normal"])

        # --- surface emission (no NEE over emissive triangles) ----------
        radiance = radiance + jnp.where(
            on_surface[:, None], throughput * mp.emission, 0.0
        )

        # --- opacity stochastic pass-through ----------------------------
        # One RNG call serves both the alpha test ([0]) and Russian
        # roulette ([1]) — pcg4d calls are per-bounce fixed cost.
        r_alpha = s4(bounce, 11)
        default_pass = r_alpha[:, 0] > mp.opacity
        if hooks is not None and hooks.any_hit is not None:
            # any-hit-shader seam: override the stochastic pass-through
            # decision (True = ignore this hit, continue the ray).
            default_pass = hooks.any_hit(
                hit_ctx, mp, r_alpha[:, 0], default_pass
            )
        pass_through = on_surface & default_pass

        # --- NEE: analytic lights (occlusion deferred to the batched
        # visibility query below) -----------------------------------------
        r_nee = s4(bounce, 13)
        shadow_o = hit_p + ng_f * _RAY_EPS
        if scene.lights.num_lights > 0:
            ls = sample_one_light(scene.lights, hit_p, r_nee[:, :3])
            wi_l = to_local(ls.wi, t_b, b_b, ns_f)
            f_l, pdf_b = bsdf_eval(mp, wo_l, wi_l, w_disney, w_trans)
            cos_l = jnp.abs(wi_l[:, 2])
            candidate = on_surface & ~pass_through & (ls.pdf > 0) & (cos_l > 1e-6)
            w_mis = jnp.where(
                ls.is_delta, 1.0, power_heuristic(ls.pdf, pdf_b)
            )
            nee_contrib = (
                throughput
                * f_l
                * (cos_l / jnp.maximum(ls.pdf, 1e-12) * w_mis)[:, None]
                * ls.radiance
            )
            nee_dir = ls.wi
            nee_tmax = jnp.where(candidate, ls.dist * (1.0 - 1e-4), 0.0)
        else:
            candidate = zeros > 1.0
            nee_contrib = zeros3
            nee_dir = ns_f
            nee_tmax = zeros

        # --- NEE: environment map (occlusion deferred likewise) ---------
        if has_env_map:
            r_env = s4(bounce, 17)
            wi_e, rad_e, pdf_e = env_sample(
                env, r_env[:, :2], uniforms.env_rotation, uniforms.env_intensity
            )
            wi_el = to_local(wi_e, t_b, b_b, ns_f)
            f_e, pdf_be = bsdf_eval(mp, wo_l, wi_el, w_disney, w_trans)
            cos_e = jnp.abs(wi_el[:, 2])
            cand_e = on_surface & ~pass_through & (pdf_e > 0) & (cos_e > 1e-6)
            w_mis_e = power_heuristic(pdf_e, pdf_be)
            env_contrib = (
                throughput
                * f_e
                * (cos_e / jnp.maximum(pdf_e, 1e-12) * w_mis_e)[:, None]
                * rad_e
            )
            env_tmax = jnp.where(cand_e, 1.0e7, 0.0)

        # --- BSDF sampling / continuation -------------------------------
        r_bsdf = s4(bounce, 19)
        wi_s, f_s, pdf_s = bsdf_sample(mp, wo_l, r_bsdf, w_disney, w_trans)
        wi_w = to_world(wi_s, t_b, b_b, ns_f)
        cos_s = jnp.abs(wi_s[:, 2])
        valid_s = pdf_s > 1e-9
        new_tp = throughput * f_s * (cos_s / jnp.maximum(pdf_s, 1e-9))[:, None]

        # pass-through overrides the BSDF continuation
        next_d = jnp.where(pass_through[:, None], d, wi_w)
        offset_n = jnp.where(
            dot(next_d, ng_f)[:, None] >= 0, ng_f, -ng_f
        )
        next_o = hit_p + offset_n * _RAY_EPS + next_d * _RAY_EPS
        next_tp = jnp.where(pass_through[:, None], throughput, new_tp)
        next_pdf = jnp.where(pass_through, jnp.zeros_like(pdf_s), pdf_s)
        active = active & (pass_through | valid_s | scatter)

        # --- SCATTER continuation + medium boundary tracking -------------
        if w_scatter:
            from ..ops.sampling import sample_henyey_greenstein

            med_g = st["med_g"]
            med_color = st["med_color"]
            wi_hg, pdf_hg = sample_henyey_greenstein(
                d, med_g, r_med[:, 1], r_med[:, 2]
            )
            scat_o = o + effective_t[:, None] * d + wi_hg * _RAY_EPS
            next_d = jnp.where(scatter[:, None], wi_hg, next_d)
            next_o = jnp.where(scatter[:, None], scat_o, next_o)
            next_tp = jnp.where(
                scatter[:, None], throughput * med_color, next_tp
            )
            # No NEE is performed from scatter vertices, so the emissive
            # hit after a phase bounce must carry FULL weight — a pdf of
            # 0 marks "previous bounce was delta/unmatched" for the MIS
            # power heuristic (otherwise volumes near lights go dark:
            # the NEE share of the energy would be discarded unsampled).
            del pdf_hg
            next_pdf = jnp.where(scatter, 0.0, next_pdf)

            # Medium boundary crossings: a transmitted surface ray enters
            # (or exits) the hit material's medium.
            mm_type = jnp.take(
                scene.materials.medium_type, jnp.maximum(mat_idx, 0)
            )
            mm_density = jnp.take(
                scene.materials.medium_density, jnp.maximum(mat_idx, 0)
            )
            mm_g = jnp.take(
                scene.materials.medium_anisotropy, jnp.maximum(mat_idx, 0)
            )
            mm_color = jnp.take(
                scene.materials.medium_color, jnp.maximum(mat_idx, 0), axis=0
            )
            crossed = on_surface & ~pass_through & (dot(next_d, ng_f) < 0)
            enter_med = crossed & entering & (mm_type == 2) & (mm_density > 0)
            exit_med = crossed & ~entering
            new_density = jnp.where(
                enter_med, mm_density,
                jnp.where(exit_med, 0.0, st["med_density"]),
            )
            new_g = jnp.where(
                enter_med, mm_g, jnp.where(exit_med, 0.0, st["med_g"])
            )
            new_color = jnp.where(
                enter_med[:, None], mm_color,
                jnp.where(exit_med[:, None], 0.0, st["med_color"]),
            )
        else:
            new_density = st["med_density"]
            new_g = st["med_g"]
            new_color = st["med_color"]

        # --- Russian roulette (from rr_depth, rt_renderer.rs:572-573) ---
        q = jnp.clip(jnp.max(next_tp, axis=-1), 0.05, 0.95)
        do_rr = bounce >= settings.rr_depth
        survive = jnp.where(do_rr, r_alpha[:, 1] < q, True)
        next_tp = jnp.where(do_rr, next_tp / q[:, None], next_tp)
        active = active & survive

        # --- batched visibility seam: the queries themselves run in
        # bounce_body (inline megakernel) or in render_frame_staged's
        # own jit dispatches; everything the post-query half needs
        # crosses in this carry. Without alpha materials the shadow
        # class is its own ANY-HIT query (split_shadow); with them every
        # query folds into ONE closest-hit batch that `transmit` walks.
        ext_tmax = jnp.where(active, jnp.float32(T_MAX), 0.0)
        carry = dict(
            next_o=next_o, next_d=next_d, ext_tmax=ext_tmax,
            radiance=radiance, active=active, next_tp=next_tp,
            next_pdf=next_pdf, st_albedo=st_albedo, st_normal=st_normal,
            rays=rays, path_dist=path_dist, new_density=new_density,
            new_g=new_g, new_color=new_color,
            candidate=candidate, nee_contrib=nee_contrib,
            shadow_o=shadow_o, nee_dir=nee_dir, nee_tmax=nee_tmax,
        )
        if has_env_map:
            carry.update(
                cand_e=cand_e, env_contrib=env_contrib, wi_e=wi_e,
                env_tmax=env_tmax,
            )
        if not split_shadow:
            carry["r_alpha"] = r_alpha
        return carry

    def shadow_queries(c):
        """The (o, d, t_max) any-hit batch for a bounce carry."""
        if has_env_map:
            return (
                jnp.concatenate([c["shadow_o"], c["shadow_o"]]),
                jnp.concatenate([c["nee_dir"], c["wi_e"]]),
                jnp.concatenate([c["nee_tmax"], c["env_tmax"]]),
            )
        return c["shadow_o"], c["nee_dir"], c["nee_tmax"]

    def bounce_post(bounce, c, qhit, blocked, blocked_e):
        n = c["active"].shape[0]
        active = c["active"]
        radiance = c["radiance"] + jnp.where(
            (c["candidate"] & ~blocked)[:, None], c["nee_contrib"], 0.0
        )
        rays = c["rays"] + c["candidate"].astype(jnp.float32)
        if has_env_map:
            radiance = radiance + jnp.where(
                (c["cand_e"] & ~blocked_e)[:, None], c["env_contrib"], 0.0
            )
            rays = rays + c["cand_e"].astype(jnp.float32)
        return dict(
            o=c["next_o"],
            d=c["next_d"],
            hit_t=qhit.t[:n],
            hit_tri=jnp.where(active, qhit.tri[:n], -1),
            hit_u=qhit.u[:n],
            hit_v=qhit.v[:n],
            throughput=c["next_tp"],
            radiance=radiance,
            active=active,
            prev_pdf=c["next_pdf"],
            albedo=c["st_albedo"],
            normal=c["st_normal"],
            rays=rays + active.astype(jnp.float32),
            path_dist=c["path_dist"],
            med_density=c["new_density"],
            med_g=c["new_g"],
            med_color=c["new_color"],
        )

    def bounce_body(bounce, st):
        c = bounce_pre(bounce, st)
        n = c["active"].shape[0]
        shadow_o = c["shadow_o"]
        if split_shadow:
            qhit = _intersect(
                scene, c["next_o"], c["next_d"], settings,
                t_max=c["ext_tmax"],
            )
            occ = _occluded(scene, *shadow_queries(c), settings)
            blocked = occ[:n]
            blocked_e = occ[n:2 * n] if has_env_map else None
            return bounce_post(bounce, c, qhit, blocked, blocked_e)

        q_o = [c["next_o"], c["shadow_o"]]
        q_d = [c["next_d"], c["nee_dir"]]
        q_t = [c["ext_tmax"], c["nee_tmax"]]
        if has_env_map:
            q_o.append(c["shadow_o"])
            q_d.append(c["wi_e"])
            q_t.append(c["env_tmax"])
        qhit = _intersect(
            scene,
            jnp.concatenate(q_o),
            jnp.concatenate(q_d),
            settings,
            t_max=jnp.concatenate(q_t),
        )
        r_alpha = c["r_alpha"]

        def transmit(tri0, t0, dir_s, tmax_s, r_first, seed0):
            """Stochastic transparent shadow transmittance: pass each
            alpha-tested blocker with probability 1 - opacity, continuing
            past up to settings.shadow_surfaces stacked surfaces (the
            reference's any-hit shaders re-arm after transparent hits;
            here each continuation is one more batched closest-hit with
            t_max=0 for settled lanes). Returns the final blocked mask. A blocker
            passed on the LAST budgeted surface is treated as visible
            (legacy single-blocker semantics at shadow_surfaces=1);
            light can only leak past shadow_surfaces stacked alpha
            surfaces."""
            blocked0 = tri0 >= 0
            if not scene.materials.has_alpha:
                return blocked0

            def opacity_of(tri):
                m = (
                    jnp.take(geom.tri_mat, jnp.maximum(tri, 0))
                    if settings.scene_axis is None
                    else _rows_sharded(
                        geom.tri_mat, jnp.maximum(tri, 0),
                        settings.scene_axis,
                    )
                )
                if scene.procedural is not None:
                    # procedural blockers resolve through their own
                    # material row (ids >= PROC_BASE clip to a garbage
                    # slot in the triangle take above)
                    from ..ops.prims import PROC_BASE

                    isp = tri >= PROC_BASE
                    pidk = jnp.clip(
                        tri - PROC_BASE, 0,
                        scene.procedural.center.shape[0] - 1,
                    )
                    pmat = jnp.take(scene.procedural.packed, pidk, axis=0)[
                        :, 4
                    ].astype(jnp.int32)
                    m = jnp.where(isp, pmat, m)
                return jnp.take(
                    scene.materials.packed[:, 3], jnp.maximum(m, 0)
                )

            passed = blocked0 & (r_first >= opacity_of(tri0))
            blocked_acc = blocked0 & ~passed
            t_base = t0
            for k in range(settings.shadow_surfaces - 1):
                o_k = shadow_o + dir_s * (t_base + _RAY_EPS)[:, None]
                tm_k = jnp.where(
                    passed, jnp.maximum(tmax_s - t_base - _RAY_EPS, 0.0), 0.0
                )
                qh_k = _intersect(scene, o_k, dir_s, settings, t_max=tm_k)
                hit_k = passed & (qh_k.tri >= 0)
                r_k = s4(bounce, seed0 + k)[:, 0]
                pass_k = hit_k & (r_k >= opacity_of(qh_k.tri))
                blocked_acc = blocked_acc | (hit_k & ~pass_k)
                t_base = t_base + jnp.where(passed, qh_k.t + _RAY_EPS, 0.0)
                passed = pass_k
            return blocked_acc

        blocked = transmit(
            qhit.tri[n : 2 * n], qhit.t[n : 2 * n], c["nee_dir"],
            c["nee_tmax"], r_alpha[:, 2], 37,
        )
        blocked_e = (
            transmit(
                qhit.tri[2 * n : 3 * n], qhit.t[2 * n : 3 * n],
                c["wi_e"], c["env_tmax"], r_alpha[:, 3], 53,
            )
            if has_env_map
            else None
        )
        return bounce_post(bounce, c, qhit, blocked, blocked_e)

    return (
        init_state, bounce_pre, bounce_post, bounce_body,
        shadow_queries, split_shadow,
    )


def trace_paths(
    scene,
    env,
    uniforms: Uniforms,
    o: jnp.ndarray,
    d: jnp.ndarray,
    pixel_idx: jnp.ndarray,
    frame_index,
    settings: RenderSettings,
    full_height: int | None = None,
    hooks: KernelHooks | None = None,
    blue_noise=None,
):
    """Trace full paths for a flat ray batch.

    `full_height` is the height of the WHOLE film; under multi-chip film
    tiling `settings.height` is the per-shard row count, and the mip-LOD
    pixel cone angle must use the global height or textured shards pick
    different mip levels per device count (breaking bit-identity).

    Returns (radiance (N,3), albedo_aov (N,3), normal_aov (N,3),
    rays_traced (N,) f32 — counting extension + shadow rays for the
    Mrays/s statistic).
    """
    init_state, _, _, bounce_body, _, _ = _path_context(
        scene, env, uniforms, pixel_idx, frame_index, settings,
        full_height, hooks, blue_noise,
    )
    # Prologue: closest hit for the camera rays. Every later bounce folds
    # its extension ray into the batched end-of-bounce visibility query,
    # so the whole path costs 1 + max_depth kernel dispatches instead of
    # up to 3 per bounce (dispatch overhead showed up as ~25% of frame
    # time in the stage ablation).
    hit0 = _intersect(scene, o, d, settings)
    state = jax.lax.fori_loop(
        0, settings.max_depth, bounce_body, init_state(o, d, hit0)
    )

    # Terminal environment lookup for rays still active after the last
    # bounce is intentionally skipped (depth cap, rt_renderer parity).
    return state["radiance"], state["albedo"], state["normal"], state["rays"]


def _tile_raygen(
    scene, uniforms, blue_noise, hooks, fidx, start,
    w, cam_h, row_offset, spp, tile, swizzle,
):
    """Camera rays for one film tile (shared by the megakernel frame and
    the staged dispatcher so both produce identical ray populations).

    Returns (o, d, gpix, fidx_r): ray r of the tile is sample r % spp of
    pixel start + r // spp, running as virtual RNG frame fidx*spp + s.
    """
    ridx = jnp.arange(tile, dtype=jnp.int32)
    pix = start + ridx // spp
    if spp == 1:
        fidx_r = fidx
    else:
        fidx_r = fidx * jnp.uint32(spp) + (ridx % spp).astype(jnp.uint32)
    if swizzle:
        # blocked index -> pixel coords (32x32 blocks, row-major)
        blk = pix // 1024
        within = pix % 1024
        bx = blk % (w // 32)
        by = blk // (w // 32)
        px_i = bx * 32 + within % 32
        py_i = by * 32 + within // 32
    else:
        px_i = pix % w
        py_i = pix // w
    py_i = py_i + row_offset
    gpix = py_i * w + px_i  # globally unique pixel id
    px = px_i.astype(jnp.float32)
    py = py_i.astype(jnp.float32)
    if blue_noise is not None:
        # Blue-noise sample for the camera dimensions — pixel jitter +
        # lens DOF — through the same Cranley-Patterson construction the
        # path context uses for bounce/NEE/env sampling
        # (rng.bn_sample4; rt_renderer.rs:1117-1156 binding-5 role).
        r_jit = rng.bn_sample4(
            blue_noise, gpix % w, gpix // w, fidx_r, 0, seed=1
        )
    else:
        r_jit = rng.sample4(gpix, fidx_r, 0, seed=1)
    if hooks is not None and hooks.raygen is not None:
        # pushed raygen kernel overrides the sample jitter
        r_jit = hooks.raygen(gpix, fidx_r, r_jit)
    o, d = generate_rays(
        scene.cameras, uniforms.camera_index, px, py, w, cam_h,
        r_jit[:, :2], r_jit[:, 2:],
    )
    return o, d, gpix, fidx_r


def _render_frame_impl(
    scene,
    env,
    uniforms: Uniforms,
    film: Film,
    frame_index,
    settings: RenderSettings,
    row_offset=0,
    full_height: int | None = None,
    blue_noise=None,
    hooks: KernelHooks | None = None,
):
    """One progressive frame (settings.spp samples/pixel):
    rt_renderer.rs update() parity. (Traced body; the public jits are
    `render_frame` — one frame per XLA program — and `render_frames`
    — K frames fused into one program via a fori_loop film carry.)

    Returns (film, rays_traced_scalar). The film accumulates a running
    mean like the reference's accum image + frame_index uniform. With
    spp=S the frame dispatches S sample-adjacent rays per pixel under
    virtual RNG frames f*S..f*S+S-1 and accumulates their mean — the
    image converges to the same estimator as S sequential 1-spp frames
    (bitwise up to summation order), while same-pixel bounce rays stay
    adjacent for the large-scene traversal's coherence sort.

    Multi-chip film tiling (SURVEY.md sections 2.11/5.8): when the film is
    sharded by rows across a device mesh, each shard passes its global
    `row_offset` and the `full_height` of the whole film so camera NDC
    and RNG streams stay globally consistent; results then need no
    cross-device exchange at all until readback (fixed per-tile
    ownership also keeps accumulation deterministic).
    """
    h, w = settings.height, settings.width
    cam_h = full_height if full_height is not None else h
    row_offset = jnp.asarray(row_offset, jnp.int32)
    spp = max(1, settings.spp)

    def to_blocked(a):
        return (
            a.reshape(h // 32, 32, w // 32, 32, a.shape[-1])
            .transpose(0, 2, 1, 3, 4)
            .reshape(h * w, a.shape[-1])
        )

    def from_blocked(a):
        return (
            a.reshape(h // 32, w // 32, 32, 32, a.shape[-1])
            .transpose(0, 2, 1, 3, 4)
            .reshape(h * w, a.shape[-1])
        )
    n_pix = h * w
    n_rays = n_pix * spp
    tile = min(settings.tile_size, n_rays)
    tile = max(spp, tile - tile % spp)  # whole pixels per ray tile
    pp = tile // spp                    # pixels per tile
    n_tiles = -(-n_rays // tile)
    n_pad = n_tiles * pp
    # 32x32 pixel swizzle: consecutive 1024-ray groups cover square pixel
    # blocks instead of 2-row strips, so a kernel's ray block holds
    # coherent rays. Pure layout transform; the RNG stays keyed on the
    # global pixel id, so output is identical.
    swizzle = h % 32 == 0 and w % 32 == 0 and pp % 1024 == 0

    accum = film.accum.reshape(-1, 4)
    albedo = film.albedo.reshape(-1, 4)
    normal = film.normal.reshape(-1, 4)
    if swizzle:
        accum, albedo, normal = (
            to_blocked(accum), to_blocked(albedo), to_blocked(normal)
        )
    if n_pad != n_pix:
        pad = ((0, n_pad - n_pix), (0, 0))
        accum = jnp.pad(accum, pad)
        albedo = jnp.pad(albedo, pad)
        normal = jnp.pad(normal, pad)

    fidx = jnp.asarray(frame_index, jnp.uint32)
    inv_n1 = 1.0 / (jnp.asarray(frame_index, jnp.float32) + 1.0)

    def tile_body(carry, t):
        accum, albedo, normal, rays_total = carry
        start = t * pp
        o, d, gpix, fidx_r = _tile_raygen(
            scene, uniforms, blue_noise, hooks, fidx, start,
            w, cam_h, row_offset, spp, tile, swizzle,
        )
        L, alb, nrm, rays = trace_paths(
            scene, env, uniforms, o, d, gpix, fidx_r, settings,
            full_height=cam_h, hooks=hooks, blue_noise=blue_noise,
        )
        if hooks is not None and hooks.post_shade is not None:
            L, alb, nrm = hooks.post_shade(L, alb, nrm)
        L = jnp.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
        if spp > 1:
            # Pixel mean over the sample-adjacent lanes: one spp=S frame
            # accumulates exactly like S spp=1 frames (same 1/(f+1)
            # progressive weight against the batch mean).
            L = L.reshape(pp, spp, 3).mean(axis=1)
            alb = alb.reshape(pp, spp, 3).mean(axis=1)
            nrm = nrm.reshape(pp, spp, 3).mean(axis=1)
        old = jax.lax.dynamic_slice_in_dim(accum, start, pp)
        new = old + (jnp.concatenate([L, jnp.ones((pp, 1))], -1) - old) * inv_n1
        accum = jax.lax.dynamic_update_slice_in_dim(accum, new, start, 0)
        alb4 = jnp.concatenate([alb, jnp.ones((pp, 1))], -1)
        nrm4 = jnp.concatenate([nrm, jnp.ones((pp, 1))], -1)
        old_a = jax.lax.dynamic_slice_in_dim(albedo, start, pp)
        old_n = jax.lax.dynamic_slice_in_dim(normal, start, pp)
        albedo = jax.lax.dynamic_update_slice_in_dim(
            albedo, old_a + (alb4 - old_a) * inv_n1, start, 0
        )
        normal = jax.lax.dynamic_update_slice_in_dim(
            normal, old_n + (nrm4 - old_n) * inv_n1, start, 0
        )
        return (accum, albedo, normal, rays_total + jnp.sum(rays)), None

    (accum, albedo, normal, rays_total), _ = jax.lax.scan(
        tile_body,
        (accum, albedo, normal, accum[0, 0] * 0.0),  # varying-typed zero
        jnp.arange(n_tiles, dtype=jnp.int32),
    )

    accum, albedo, normal = accum[:n_pix], albedo[:n_pix], normal[:n_pix]
    if swizzle:
        accum, albedo, normal = (
            from_blocked(accum), from_blocked(albedo), from_blocked(normal)
        )
    new_film = Film(
        accum=accum.reshape(h, w, 4),
        albedo=albedo.reshape(h, w, 4),
        normal=normal.reshape(h, w, 4),
    )
    return new_film, rays_total


render_frame = partial(
    jax.jit,
    static_argnames=("settings", "full_height", "hooks"),
    donate_argnums=(3,),
)(_render_frame_impl)


@partial(
    jax.jit,
    static_argnames=("k_frames", "settings", "full_height", "hooks"),
    donate_argnums=(3,),
)
def render_frames(
    scene,
    env,
    uniforms: Uniforms,
    film: Film,
    frame_index,
    k_frames: int,
    settings: RenderSettings,
    row_offset=0,
    full_height: int | None = None,
    blue_noise=None,
    hooks: KernelHooks | None = None,
):
    """K progressive frames fused into ONE XLA program.

    Bit-identical to K sequential `render_frame` dispatches (same
    per-frame RNG streams keyed on the absolute frame index, same
    1/(f+1) running-mean accumulation, same op order — the loop body IS
    `_render_frame_impl`), but the host pays ONE dispatch + fetch
    instead of K.

    Returns (film, total_rays) like render_frame, with total_rays
    summed over the K frames.
    """

    def body(i, carry):
        film, rays = carry
        film, r = _render_frame_impl(
            scene, env, uniforms, film,
            jnp.asarray(frame_index, jnp.uint32) + jnp.uint32(i),
            settings, row_offset, full_height, blue_noise, hooks,
        )
        return (film, rays + r)

    zero = film.accum[0, 0, 0] * 0.0  # varying-typed under shard_map
    film, rays = jax.lax.fori_loop(
        0, k_frames, body, (film, zero)
    )
    return film, rays


# ---------------------------------------------------------------------------
# Staged frame dispatcher: each visibility query runs in its OWN small jit.
#
# The megakernel render_frame traces a whole frame (every tile, every
# bounce) into one XLA program. Staging dispatches the same frame as a
# sequence of small async programs (no host sync anywhere in the frame),
# bit-identical to the megakernel by construction: both compose the SAME
# _path_context closures and the SAME _tile_raygen, only the jit
# boundaries differ.
# ---------------------------------------------------------------------------

_BOUNCE_CONST: dict = {}


def _bounce_const(b: int):
    """Cached device scalar for the bounce index (traced arg, so the
    pre/post stages compile ONCE and are reused for every bounce)."""
    if b not in _BOUNCE_CONST:
        _BOUNCE_CONST[b] = jnp.int32(b)
    return _BOUNCE_CONST[b]


@partial(jax.jit, static_argnames=("settings",))
def _stage_primary(scene, o, d, settings: RenderSettings):
    return _intersect(scene, o, d, settings)


@partial(jax.jit, static_argnames=("settings",))
def _stage_extend(scene, o, d, t_max, settings: RenderSettings):
    return _intersect(scene, o, d, settings, t_max=t_max)


@partial(jax.jit, static_argnames=("settings",))
def _stage_occlude(scene, o, d, t_far, settings: RenderSettings):
    return _occluded(scene, o, d, t_far, settings)


@partial(jax.jit, static_argnames=("settings", "full_height", "hooks"))
def _stage_init(
    scene, env, uniforms, pixel_idx, frame_index, o, d, hit0,
    settings: RenderSettings, full_height=None, hooks=None,
    blue_noise=None,
):
    init_state, _, _, _, _, _ = _path_context(
        scene, env, uniforms, pixel_idx, frame_index, settings,
        full_height, hooks, blue_noise,
    )
    return init_state(o, d, hit0)


@partial(jax.jit, static_argnames=("settings", "full_height", "hooks"))
def _stage_pre(
    scene, env, uniforms, pixel_idx, frame_index, bounce, st,
    settings: RenderSettings, full_height=None, hooks=None,
    blue_noise=None,
):
    _, bounce_pre, _, _, shadow_queries, _ = _path_context(
        scene, env, uniforms, pixel_idx, frame_index, settings,
        full_height, hooks, blue_noise,
    )
    c = bounce_pre(bounce, st)
    sh_o, sh_d, sh_t = shadow_queries(c)
    return c, sh_o, sh_d, sh_t


@partial(jax.jit, static_argnames=("settings", "full_height", "hooks"))
def _stage_post(
    scene, env, uniforms, pixel_idx, frame_index, bounce, c, qhit, occ,
    settings: RenderSettings, full_height=None, hooks=None,
    blue_noise=None,
):
    _, _, bounce_post, _, _, _ = _path_context(
        scene, env, uniforms, pixel_idx, frame_index, settings,
        full_height, hooks, blue_noise,
    )
    n = c["active"].shape[0]
    has_env = settings.env_type == ENV_MAP and env is not None
    blocked = occ[:n]
    blocked_e = occ[n:2 * n] if has_env else None
    return bounce_post(bounce, c, qhit, blocked, blocked_e)


@partial(
    jax.jit,
    static_argnames=("settings", "cam_h", "spp", "tile", "swizzle", "hooks"),
)
def _stage_raygen(
    scene, uniforms, blue_noise, fidx, row_offset, start,
    settings: RenderSettings, cam_h, spp, tile, swizzle, hooks=None,
):
    return _tile_raygen(
        scene, uniforms, blue_noise, hooks, fidx, start,
        settings.width, cam_h, row_offset, spp, tile, swizzle,
    )


@partial(
    jax.jit,
    static_argnames=("settings", "pp", "spp", "hooks"),
    donate_argnums=(0, 1, 2),
)
def _stage_accum(
    accum, albedo, normal, rays_total, L, alb, nrm, rays, inv_n1,
    start, settings: RenderSettings, pp, spp, hooks=None,
):
    if hooks is not None and hooks.post_shade is not None:
        L, alb, nrm = hooks.post_shade(L, alb, nrm)
    L = jnp.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
    if spp > 1:
        L = L.reshape(pp, spp, 3).mean(axis=1)
        alb = alb.reshape(pp, spp, 3).mean(axis=1)
        nrm = nrm.reshape(pp, spp, 3).mean(axis=1)
    old = jax.lax.dynamic_slice_in_dim(accum, start, pp)
    new = old + (jnp.concatenate([L, jnp.ones((pp, 1))], -1) - old) * inv_n1
    accum = jax.lax.dynamic_update_slice_in_dim(accum, new, start, 0)
    alb4 = jnp.concatenate([alb, jnp.ones((pp, 1))], -1)
    nrm4 = jnp.concatenate([nrm, jnp.ones((pp, 1))], -1)
    old_a = jax.lax.dynamic_slice_in_dim(albedo, start, pp)
    old_n = jax.lax.dynamic_slice_in_dim(normal, start, pp)
    albedo = jax.lax.dynamic_update_slice_in_dim(
        albedo, old_a + (alb4 - old_a) * inv_n1, start, 0
    )
    normal = jax.lax.dynamic_update_slice_in_dim(
        normal, old_n + (nrm4 - old_n) * inv_n1, start, 0
    )
    return accum, albedo, normal, rays_total + jnp.sum(rays)


@partial(jax.jit, static_argnames=("settings", "swizzle", "n_pad"))
def _stage_film_prep(film: Film, settings: RenderSettings, swizzle, n_pad):
    h, w = settings.height, settings.width

    def prep(a):
        a = a.reshape(-1, 4)
        if swizzle:
            a = (
                a.reshape(h // 32, 32, w // 32, 32, 4)
                .transpose(0, 2, 1, 3, 4)
                .reshape(h * w, 4)
            )
        if n_pad != h * w:
            a = jnp.pad(a, ((0, n_pad - h * w), (0, 0)))
        return a

    return prep(film.accum), prep(film.albedo), prep(film.normal)


@partial(jax.jit, static_argnames=("settings", "swizzle"))
def _stage_finalize(accum, albedo, normal, settings: RenderSettings, swizzle):
    h, w = settings.height, settings.width

    def fin(a):
        a = a[:h * w]
        if swizzle:
            a = (
                a.reshape(h // 32, w // 32, 32, 32, 4)
                .transpose(0, 2, 1, 3, 4)
                .reshape(h * w, 4)
            )
        return a.reshape(h, w, 4)

    return Film(accum=fin(accum), albedo=fin(albedo), normal=fin(normal))


def render_frame_staged(
    scene,
    env,
    uniforms: Uniforms,
    film: Film,
    frame_index,
    settings: RenderSettings,
    blue_noise=None,
    hooks: KernelHooks | None = None,
):
    """One progressive frame as a sequence of small async jit dispatches.

    Semantics are identical to `render_frame` (same estimator, same RNG
    streams, same ray population, same accumulation — asserted in
    tests/test_integrator.py: bit-exact on the lit configs, <= 1 ULP on
    env configs where XLA fuses differently across jit boundaries), but
    every visibility query runs in its own XLA program: python-level
    tile and bounce loops dispatch raygen -> primary -> [pre -> extend
    -> occlude -> post] x depth -> accumulate, with NO host
    synchronization anywhere (JAX dispatch is async; the caller blocks
    on the returned film exactly as with the megakernel).

    Requires the split-shadow regime: no alpha-tested materials (the
    stochastic transmit loop is megakernel-only). Raises
    HalaRendererError otherwise. Single-chip only; the multi-chip path keeps the
    megakernel (shard_map wraps one program). All pushed kernels
    (raygen/miss/hit/post_shade) dispatch in their owning stages.
    """
    if settings.scene_axis is not None:
        raise HalaRendererError(
            "render_frame_staged is single-chip; geometry sharding "
            "(scene_axis) needs the megakernel inside shard_map — use "
            "render_frame_scene_sharded."
        )
    if scene.materials.has_alpha:
        raise HalaRendererError(
            "render_frame_staged requires a scene without alpha "
            "materials; use render_frame."
        )
    h, w = settings.height, settings.width
    cam_h = h
    spp = max(1, settings.spp)
    n_pix = h * w
    n_rays = n_pix * spp
    tile = min(settings.tile_size, n_rays)
    tile = max(spp, tile - tile % spp)
    pp = tile // spp
    n_tiles = -(-n_rays // tile)
    n_pad = n_tiles * pp
    swizzle = h % 32 == 0 and w % 32 == 0 and pp % 1024 == 0

    fidx = jnp.asarray(frame_index, jnp.uint32)
    inv_n1 = 1.0 / (jnp.asarray(frame_index, jnp.float32) + 1.0)
    row_offset = jnp.int32(0)

    accum, albedo, normal = _stage_film_prep(film, settings, swizzle, n_pad)
    rays_total = jnp.float32(0.0)

    for t in range(n_tiles):
        start = t * pp
        o, d, gpix, fidx_r = _stage_raygen(
            scene, uniforms, blue_noise, fidx, row_offset, start,
            settings, cam_h, spp, tile, swizzle, hooks,
        )
        hit0 = _stage_primary(scene, o, d, settings)
        st = _stage_init(
            scene, env, uniforms, gpix, fidx_r, o, d, hit0,
            settings, cam_h, hooks, blue_noise,
        )
        for b in range(settings.max_depth):
            bounce = _bounce_const(b)
            c, sh_o, sh_d, sh_t = _stage_pre(
                scene, env, uniforms, gpix, fidx_r, bounce, st,
                settings, cam_h, hooks, blue_noise,
            )
            qhit = _stage_extend(
                scene, c["next_o"], c["next_d"], c["ext_tmax"], settings
            )
            occ = _stage_occlude(scene, sh_o, sh_d, sh_t, settings)
            st = _stage_post(
                scene, env, uniforms, gpix, fidx_r, bounce, c, qhit, occ,
                settings, cam_h, hooks, blue_noise,
            )
        accum, albedo, normal, rays_total = _stage_accum(
            accum, albedo, normal, rays_total,
            st["radiance"], st["albedo"], st["normal"], st["rays"],
            inv_n1, start, settings, pp, spp, hooks,
        )

    return _stage_finalize(accum, albedo, normal, settings, swizzle), rays_total
