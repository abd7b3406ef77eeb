"""Rasterization renderer: forward and deferred paths.

Parity: reference src/rz_renderer.rs (HalaRenderer, exported as
HalaRasterizationRenderer):

* global uniform V/P/VP/inv-VP matrices (rz_renderer.rs:25-36) and
  per-object M / MV / MVP uniforms (rz_renderer.rs:38-53) — here the
  view-projection is taken from the camera table and geometry is already
  world-space, so only VP is applied per frame;
* reverse-Z depth (CompareOp::GREATER, rz_renderer.rs:494) with clear
  color {25, 118, 210}/255 (rz_renderer.rs:1053);
* forward path: rasterize + shade in one pass
  (record_forward_command_buffer, rz_renderer.rs:978-1103);
* deferred path: G-buffer albedo/normal/depth then a fullscreen lighting
  pass (record_deferred_command_buffer + create_gbuffer_images,
  rz_renderer.rs:1110-1446, 1455-1570);
* `set_scene` uploads with (use_mesh_shader, global_meshlets=False,
  ray_tracing=False) (rz_renderer.rs:1936-1954).

The per-material-type pipeline arrays and shader push API map to the
jitted shading dispatch (materials are data, not pipelines, here);
MSAA maps to supersampled rasterization with an average resolve
(enable_multisample, rz_renderer.rs:1586-1622).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..error import HalaRendererError
from ..ops.bsdf import gather_materials
from ..ops.raster import clip_to_screen, rasterize, transform_vertices
from ..ops.sampling import dot, normalize
from ..ops.texture import sample_texture
from ..ops.tonemap import apply_tonemap
from ..scene.cpu.scene import Scene
from ..scene.loader.uploader import SceneUploader
from ..utils.pfm import write_pfm
from .renderer import BaseRenderer

logger = logging.getLogger("hala_tpu.rz")

# rz_renderer.rs:1053 clear color.
CLEAR_COLOR = (25.0 / 255.0, 118.0 / 255.0, 210.0 / 255.0)


@dataclasses.dataclass(frozen=True)
class RasterSettings:
    width: int
    height: int
    deferred: bool = False
    msaa: int = 1  # supersampling factor per axis (1 = off)
    chunk: int = 512
    binned: bool = False   # tile-binned rasterization (config[5])
    tile: int = 64
    bin_k_max: int = 256
    mesh_shader: bool = False  # meshlet-binned draw path (rz.task/rz.mesh)
    # Transparency layers for the forward path. The reference blends
    # transparent materials SRC_ALPHA/ONE_MINUS_SRC_ALPHA in draw order
    # (rz_renderer.rs:490); the equivalent here is K-pass depth
    # peeling — order-INDEPENDENT back-to-front compositing of the K
    # nearest transparent layers over the opaque result. 0 restores the
    # legacy everything-opaque behavior. Active only when the scene has
    # a material with opacity < 1 (static capability, so opaque scenes
    # compile no extra passes).
    peel_layers: int = 4
    # Transparency blend operator, from the graphics pipeline's blend
    # state (graphics_program.rs:62-65 color_blend; rz_renderer.rs:490
    # uses SRC_ALPHA/ONE_MINUS_SRC_ALPHA = "over"). "additive" is
    # ONE/ONE, "premultiplied" is ONE/ONE_MINUS_SRC_ALPHA, "none"
    # disables blending (transparent materials rasterize opaque).
    blend: str = "over"


@dataclasses.dataclass(frozen=True)
class RasterHooks:
    """Pushed rz.* kernel dispatch table (the shader-push parity of
    rz_renderer.rs:1829-1931, where pushed SPIR-V stages ARE the
    pipeline). Stages not pushed keep the built-in behavior:

    - vertex(corners (T,3,3)) -> corners: pre-transform world-space
      triangle corners (traditional VS seam; also used as the mesh
      stage's vertex transform when no rz.mesh kernel is pushed).
    - task(meshlets, eye (3,)) -> (M,) bool: meshlet visibility — the
      task-shader seam (default: cone culling).
    - mesh(corners (T,3,3)) -> corners: the mesh-shader vertex seam
      (mesh-shader mode only).
    - fragment(color (N,3), albedo (N,3), normal (N,3)) -> same triple:
      fragment shading override applied after the built-in lighting.
    """

    vertex: object = None
    task: object = None
    mesh: object = None
    fragment: object = None


def _shade(scene, frag, view_pos):
    """Material-aware direct lighting shared by forward shading and the
    deferred lighting pass (role of the lighting fullscreen shader +
    the per-material-type pipeline selection, rz_renderer.rs:597-665,
    429-461, :896): the full Disney/Oren-Nayar BSDF from the ray-tracing
    path shades each fragment against every light in the table, with
    per-type radiance — POINT/SPOT falloff cones, QUAD area lights at
    their center with light-side cosine, SPHERE by subtended solid
    angle. No shadows, matching the reference's raster lighting."""
    from ..ops.bsdf import bsdf_eval
    from ..ops.sampling import build_basis, to_local

    # Stage-bisect probe switch (tools/probe_raster_stages.py): traced
    # at compile time, "" in production. "attrs" returns after the
    # attribute/material fetch, "notex" skips the base-color texture,
    # "nolight" skips the per-light BSDF loop.
    import os as _os

    _probe = _os.environ.get("HALA_SHADE_PROBE", "")

    geom = scene.geometry
    tid = jnp.maximum(frag.tri, 0)
    u, v = frag.u, frag.v
    w0 = 1.0 - u - v
    # ONE fused row take for EVERY per-fragment attribute: corner
    # normals + uvs + material id (shade-table cols) AND the triangle
    # geometry v0/e1/e2, so the per-row gather cost is paid once
    # instead of once per table. The gathered VALUES are unchanged, so
    # shading stays bit-identical.
    table = jnp.concatenate(
        [
            geom.shade_table[:, 0:15],
            geom.shade_table[:, 18:19],
            geom.tri_v0,
            geom.tri_e1,
            geom.tri_e2,
        ],
        axis=1,
    )
    rows = jnp.take(table, tid, axis=0)
    ns = normalize(
        w0[:, None] * rows[:, 0:3]
        + u[:, None] * rows[:, 3:6]
        + v[:, None] * rows[:, 6:9]
    )
    v0 = rows[:, 16:19]
    e1 = rows[:, 19:22]
    e2 = rows[:, 22:25]
    pos = v0 + u[:, None] * e1 + v[:, None] * e2
    # Two-sided shading: orient the normal toward the viewer (the raster
    # pipeline draws both windings, rasterize() accepts either).
    to_view = view_pos[None, :] - pos
    ns = jnp.where(dot(ns, to_view)[:, None] < 0, -ns, ns)
    uv = (
        w0[:, None] * rows[:, 9:11]
        + u[:, None] * rows[:, 11:13]
        + v[:, None] * rows[:, 13:15]
    )
    mat_idx = rows[:, 15].astype(jnp.int32)
    mp = gather_materials(scene.materials, mat_idx)
    if _probe == "attrs":
        return mp.base_color, mp.base_color, ns, pos
    if scene.textures is not None and _probe != "notex":
        mp = mp._replace(
            base_color=mp.base_color
            * sample_texture(scene.textures, mp.base_color_map, uv)[:, :3]
        )
    albedo = mp.base_color

    # Shading frame + BSDF dispatch — the same lobes the integrator
    # uses, statically specialized on scene capabilities.
    w_disney = bool(scene.materials.has_disney)
    w_trans = bool(scene.materials.has_transmission)
    t_b, b_b = build_basis(ns)
    wo = normalize(to_view)
    wo_l = to_local(wo, t_b, b_b, ns)
    wo_l = wo_l.at[:, 2].set(jnp.maximum(wo_l[:, 2], 1e-5))

    lights = scene.lights
    color = mp.emission
    nl = lights.num_lights if _probe != "nolight" else 0
    for li_i in range(nl):
        lt = lights.ltype[li_i]
        lpos = lights.position[li_i]
        inten = lights.intensity[li_i]
        lu = lights.u[li_i]
        lv = lights.v[li_i]
        area = lights.area[li_i]
        radius = lights.radius[li_i]

        is_dir = lt == 1
        is_spot = lt == 2
        is_quad = lt == 3
        is_sphere = lt == 4
        # QUAD: shade toward the patch center, not the corner record
        lcenter = jnp.where(is_quad, lpos + 0.5 * (lu + lv), lpos)
        to_l = lcenter[None, :] - pos
        d2 = jnp.maximum(jnp.sum(to_l * to_l, -1), 1e-6)
        wi = jnp.where(
            is_dir, -lu[None, :], to_l / jnp.sqrt(d2)[:, None]
        )
        # per-type incident radiance approximation
        rad = inten[None, :] / d2[:, None]                      # point
        cos_s = -dot(wi, lu[None, :])
        spot_t = jnp.clip(
            (cos_s - lv[1]) / jnp.maximum(lv[0] - lv[1], 1e-6), 0.0, 1.0
        )
        spot_f = spot_t * spot_t * (3.0 - 2.0 * spot_t)
        rad = jnp.where(is_spot, rad * spot_f[:, None], rad)
        rad = jnp.where(is_dir, inten[None, :], rad)
        n_q = normalize(jnp.cross(lu, lv))
        cos_l = jnp.maximum(-dot(wi, n_q[None, :]), 0.0)  # single-sided
        rad = jnp.where(
            is_quad, inten[None, :] * (area * cos_l / d2)[:, None], rad
        )
        rad = jnp.where(
            is_sphere,
            inten[None, :]
            * jnp.minimum(radius * radius / d2, 1.0)[:, None]
            * jnp.pi,
            rad,
        )

        wi_l = to_local(wi, t_b, b_b, ns)
        f, _ = bsdf_eval(mp, wo_l, wi_l, w_disney, w_trans)
        cos_i = jnp.maximum(wi_l[:, 2], 0.0)
        color = color + f * rad * cos_i[:, None]
    if nl == 0:
        # headlight fallback so untextured scenes are visible
        ndv = jnp.abs(dot(ns, wo))
        color = color + albedo * ndv[:, None]

    background = frag.tri < 0
    clear = jnp.asarray(CLEAR_COLOR)
    color = jnp.where(background[:, None], clear[None, :], color)
    return color, albedo, ns, pos


def _raster_setup(scene, camera_index, settings: RasterSettings,
                  hooks: RasterHooks | None = None, prim_count=None):
    """Vertex transform + primitive validity shared by the opaque
    dispatch and the transparency peel passes (traced inside the same
    jit both times — XLA CSEs the duplicate work). Returns
    (screen, depth, inv_w, valid, visible)."""
    h, w = settings.height, settings.width
    ss = settings.msaa
    rw, rh = w * ss, h * ss
    geom = scene.geometry

    view = scene.cameras.view_matrix[camera_index]
    proj = scene.cameras.proj_matrix[camera_index]
    vp = jnp.matmul(proj, view, precision=jax.lax.Precision.HIGHEST)

    v0 = geom.tri_v0
    v1 = geom.tri_v0 + geom.tri_e1
    v2 = geom.tri_v0 + geom.tri_e2
    corners = jnp.stack([v0, v1, v2], axis=1)  # (T, 3, 3)
    if hooks is not None:
        # pushed vertex/mesh kernel: pre-transform the world-space
        # corners (VS seam; rz.mesh takes precedence in mesh mode)
        vtx_fn = (
            hooks.mesh
            if (settings.mesh_shader and hooks.mesh is not None)
            else hooks.vertex
        )
        if vtx_fn is not None:
            corners = vtx_fn(corners)
    clip = transform_vertices(corners.reshape(-1, 3), vp).reshape(-1, 3, 4)
    screen, depth, inv_w = clip_to_screen(clip, rw, rh)
    valid = (geom.tri_mat >= 0) & jnp.all(clip[..., 3] > 1e-6, axis=-1)
    if prim_count is not None:
        # Indirect work sizing (draw_indirect role,
        # graphics_program.rs:469-643): the primitive count is a
        # DEVICE-computed i32 consumed without any host round trip —
        # the analog of a VkDrawIndirectCommand buffer read. Shapes
        # stay static; the count masks primitive validity.
        valid = valid & (
            jnp.arange(valid.shape[0], dtype=jnp.int32) < prim_count
        )

    # Mesh-shader-style meshlet cone culling (the task-shader role,
    # rz_renderer.rs draw_mesh_tasks + meshopt cone test): a meshlet is
    # culled when the camera lies inside its backfacing cone. A pushed
    # rz.task kernel replaces the cone test.
    visible = None
    if scene.meshlets is not None:
        ml = scene.meshlets
        eye = scene.cameras.position[camera_index]
        if hooks is not None and hooks.task is not None:
            visible = hooks.task(ml, eye)
        else:
            to_c = ml.center - eye[None, :]
            dist = jnp.sqrt(jnp.sum(to_c * to_c, axis=-1))
            facing_away = jnp.sum(to_c * ml.cone_axis, axis=-1) >= (
                ml.cone_cutoff * dist + ml.radius
            )
            visible = ~facing_away
        tri_vis = jnp.take(
            jnp.concatenate([visible, jnp.ones((1,), bool)]),
            jnp.where(ml.tri_meshlet >= 0, ml.tri_meshlet, visible.shape[0]),
        )
        valid = valid & tri_vis
    return screen, depth, inv_w, valid, visible


def _transparent_tris(scene):
    """(T,) bool — real triangles whose material has opacity < 1."""
    geom = scene.geometry
    opac = scene.materials.opacity[jnp.maximum(geom.tri_mat, 0)]
    return (geom.tri_mat >= 0) & (opac < 1.0)


@partial(jax.jit, static_argnames=("settings", "hooks"))
def gbuffer_pass(scene, camera_index, settings: RasterSettings,
                 hooks: RasterHooks | None = None, prim_count=None,
                 tri_mask=None):
    """Visibility + G-buffer fill (deferred first subpass:
    record_deferred_command_buffer G-buffer stage / create_gbuffer_images,
    rz_renderer.rs:1149-1247, 1455-1570). Returns the FragmentBuffer plus
    world-space position for the lighting pass. `tri_mask` restricts the
    pass to a primitive subset (the forward path's opaque pass under
    depth peeling)."""
    h, w = settings.height, settings.width
    ss = settings.msaa
    rw, rh = w * ss, h * ss

    screen, depth, inv_w, valid, visible = _raster_setup(
        scene, camera_index, settings, hooks, prim_count
    )
    if tri_mask is not None:
        valid = valid & tri_mask

    if (
        settings.mesh_shader
        and scene.meshlets is not None
        and scene.meshlets.tri_ids is not None
    ):
        # MESH-SHADER DRAW PATH: meshlets are the binning/draw
        # granularity (draw_mesh_tasks role, rz_renderer.rs:957-962)
        from ..ops.raster import rasterize_meshlet_binned

        frag, _overflow = rasterize_meshlet_binned(
            screen, depth, inv_w, valid,
            scene.meshlets.tri_ids, visible, rw, rh,
            tile=settings.tile,
        )
        return frag
    if settings.binned:
        from ..ops.raster import rasterize_tiled

        frag, _overflow = rasterize_tiled(
            screen, depth, inv_w, valid, rw, rh,
            tile=settings.tile, k_max=settings.bin_k_max,
        )
        return frag
    pix = jnp.arange(rw * rh, dtype=jnp.int32)
    px = (pix % rw).astype(jnp.float32) + 0.5
    py = (pix // rw).astype(jnp.float32) + 0.5
    frag = rasterize(
        screen, depth, inv_w, valid, px, py, chunk=settings.chunk
    )
    return frag


@partial(jax.jit, static_argnames=("settings", "hooks"))
def peel_layers_pass(scene, camera_index, settings: RasterSettings,
                     hooks: RasterHooks | None = None, prim_count=None):
    """Extract the K nearest TRANSPARENT layers front to back (depth
    peeling): each pass only accepts fragments strictly farther than
    the last layer, so pixels with no further fragment get depth 0 and
    every later pass self-disables there. Returns a tuple of K
    FragmentBuffers — pure visibility, cacheable across light changes
    (relight() re-shades them without re-peeling)."""
    ss = settings.msaa
    rw = settings.width * ss
    rh = settings.height * ss
    screen, dpt, inv_w, valid, _ = _raster_setup(
        scene, camera_index, settings, hooks, prim_count
    )
    t_valid = valid & _transparent_tris(scene)
    pix = jnp.arange(rw * rh, dtype=jnp.int32)
    px = (pix % rw).astype(jnp.float32) + 0.5
    py = (pix // rw).astype(jnp.float32) + 0.5
    layers = []
    bound = None
    for _ in range(settings.peel_layers):
        fr = rasterize(
            screen, dpt, inv_w, t_valid, px, py,
            chunk=settings.chunk, depth_bound=bound, seam_dedup=True,
        )
        layers.append(fr)
        # Relative margin: along a coplanar quad's diagonal both
        # triangles cover nearby pixel centers (inexact edge functions)
        # with depths an ulp apart — without the margin the same pane
        # peels twice there. Surfaces closer than 1e-5 relative
        # reverse-Z depth merge into one layer (z-fighting territory).
        bound = fr.depth * (1.0 - 1e-5)
    return tuple(layers)


@partial(jax.jit, static_argnames=("settings", "hooks"))
def peel_composite_pass(scene, layers, color, opaque_depth, camera_index,
                        settings: RasterSettings,
                        hooks: RasterHooks | None = None):
    """Composite peeled transparent layers back-to-front over the
    opaque color (flat (N,3)) with the settings.blend operator —
    "over" a*src + (1-a)*dst (the reference's forward blend state,
    rz_renderer.rs:490), "additive" src + dst (ONE/ONE), or
    "premultiplied" src + (1-a)*dst; layers not strictly nearer than
    the opaque depth are occluded. Pushed rz.fragment kernels apply to
    each layer's shading, as the reference's fragment stage runs for
    blended draws too."""
    cam_pos = scene.cameras.position[camera_index]
    geom = scene.geometry
    if settings.blend not in ("over", "additive", "premultiplied"):
        raise HalaRendererError(
            f"unsupported blend operator {settings.blend!r} "
            "(over | additive | premultiplied | none)"
        )
    for fr in reversed(layers):
        lc, la, ln, _ = _shade(scene, fr, cam_pos)
        if hooks is not None and hooks.fragment is not None:
            lc, la, ln = hooks.fragment(lc, la, ln)
        mat = jnp.maximum(
            jnp.take(geom.tri_mat, jnp.maximum(fr.tri, 0)), 0
        )
        a = jnp.take(scene.materials.opacity, mat)[:, None]
        over = ((fr.tri >= 0) & (fr.depth > opaque_depth))[:, None]
        if settings.blend == "additive":
            blended = lc + color
        elif settings.blend == "premultiplied":
            blended = lc + (1.0 - a) * color
        else:
            blended = a * lc + (1.0 - a) * color
        color = jnp.where(over, blended, color)
    return color


@partial(jax.jit, static_argnames=("settings", "hooks"))
def raster_frame(scene, camera_index, settings: RasterSettings,
                 hooks: RasterHooks | None = None, prim_count=None):
    """FORWARD path: rasterize + shade one frame in a single fused jit.
    Returns (color (H,W,3), gbuffer dict with albedo/normal/depth).

    The deferred path does NOT go through here: RasterizationRenderer
    .update() dispatches gbuffer_pass and lighting_pass as two separate
    jit boundaries with the FragmentBuffer materialized between them
    (rz_renderer.rs:1110-1446 two-subpass parity), so the visibility
    buffer can be re-lit without re-rasterizing (see relight()).
    Forward and deferred produce identical output by construction — the
    reference's split is an optimization structure, not a semantic
    one."""
    h, w = settings.height, settings.width
    ss = settings.msaa
    rw, rh = w * ss, h * ss
    # Depth-peeled transparency (forward path only, like the
    # reference's blending: rz_renderer.rs:490 enables
    # SRC_ALPHA/ONE_MINUS_SRC_ALPHA on the forward pipelines while the
    # G-buffer cannot blend). The reference composites in draw order;
    # peeling composites the K nearest layers back-to-front, which is
    # order-independent and never less correct. has_alpha is a static
    # scene capability, so opaque scenes trace none of this.
    peel = (
        scene.materials.has_alpha and settings.peel_layers > 0
        and settings.blend != "none"
    )
    if peel:
        trans = _transparent_tris(scene)
        frag = gbuffer_pass(
            scene, camera_index, settings, hooks, prim_count,
            tri_mask=~trans,
        )
    else:
        frag = gbuffer_pass(
            scene, camera_index, settings, hooks, prim_count
        )
    cam_pos = scene.cameras.position[camera_index]
    color, albedo, normal, _ = _shade(scene, frag, cam_pos)
    if hooks is not None and hooks.fragment is not None:
        color, albedo, normal = hooks.fragment(color, albedo, normal)

    if peel:
        layers = peel_layers_pass(
            scene, camera_index, settings, hooks, prim_count
        )
        color = peel_composite_pass(
            scene, layers, color, frag.depth, camera_index, settings,
            hooks,
        )

    def resolve(img_flat, ch):
        img = img_flat.reshape(rh, rw, ch)
        if ss == 1:
            return img
        return img.reshape(h, ss, w, ss, ch).mean(axis=(1, 3))

    color = resolve(color, 3)
    gbuffer = {
        "albedo": resolve(albedo, 3),
        "normal": resolve(normal, 3),
        "depth": resolve(frag.depth[:, None], 1)[..., 0],
    }
    return color, gbuffer


@partial(jax.jit, static_argnames=("settings", "hooks"))
def lighting_pass(scene, frag, camera_index, settings: RasterSettings,
                  hooks: RasterHooks | None = None):
    """Fullscreen lighting from the materialized visibility buffer
    (deferred second subpass, rz_renderer.rs:1249-1338 lighting draw)."""
    h, w = settings.height, settings.width
    cam_pos = scene.cameras.position[camera_index]
    color, albedo, normal, _ = _shade(scene, frag, cam_pos)
    if hooks is not None and hooks.fragment is not None:
        color, albedo, normal = hooks.fragment(color, albedo, normal)
    return (
        color.reshape(h, w, 3),
        {
            "albedo": albedo.reshape(h, w, 3),
            "normal": normal.reshape(h, w, 3),
            "depth": frag.depth.reshape(h, w),
        },
    )


class RasterizationRenderer(BaseRenderer):
    def __init__(
        self,
        name: str,
        width: int,
        height: int,
        use_mesh_shader: bool = False,
        use_deferred: bool = False,
        msaa: int = 1,
        enable_tonemap: bool = False,
        chunk: int = 512,
        binned: bool = False,
        tile: int = 64,
        bin_k_max: int = 256,
        peel_layers: int = 4,
        blend: str = "over",
        post_program=None,
    ):
        super().__init__(name, width, height)
        if use_deferred and msaa > 1:
            # rz_renderer.rs:1590: MSAA and deferred are mutually exclusive
            raise HalaRendererError(
                "Multisampling is not supported in deferred rendering."
            )
        self.use_mesh_shader = use_mesh_shader
        self.use_deferred = use_deferred
        self.msaa = msaa
        self.enable_tonemap = enable_tonemap
        self.scene = None
        self._host_scene: Scene | None = None
        self.settings: RasterSettings | None = None
        self._chunk = chunk
        self._binned = binned
        self._tile = tile
        self._bin_k_max = bin_k_max
        self._peel_layers = peel_layers
        if blend not in ("over", "additive", "premultiplied", "none"):
            raise HalaRendererError(
                f"unsupported blend operator {blend!r} "
                "(over | additive | premultiplied | none)"
            )
        self._blend = blend
        # Optional ComputeProgram applied to the shaded color image — the
        # "compute_program post pass" of BASELINE config[5].
        self.post_program = post_program
        self.color: np.ndarray | None = None
        self.gbuffer: dict | None = None
        self.camera_index = 0

    # -- kernel push API (shader push parity) -----------------------------

    def push_traditional_kernels(self, vertex, fragment) -> None:
        """VS+FS pair (rz_renderer.rs:1829-1860: asserts the renderer is
        not in mesh-shader mode)."""
        if self.use_mesh_shader:
            raise HalaRendererError(
                "Traditional shaders require use_mesh_shader=False."
            )
        self._push_kernel("rz.vertex", vertex)
        self._push_kernel("rz.fragment", fragment)

    def push_kernels(self, mesh, fragment, task=None) -> None:
        """task?+mesh+FS set (rz_renderer.rs:1862-1905: asserts the
        mesh-shader mode)."""
        if not self.use_mesh_shader:
            raise HalaRendererError(
                "Mesh-shader kernels require use_mesh_shader=True."
            )
        if task is not None:
            self._push_kernel("rz.task", task)
        self._push_kernel("rz.mesh", mesh)
        self._push_kernel("rz.fragment", fragment)

    def push_compute_kernels(self, fn_or_path) -> None:
        """rz_renderer.rs:1907-1931 push_compute_shaders."""
        self._push_kernel("rz.compute", fn_or_path)

    def _push_kernel(self, name: str, fn_or_path) -> None:
        from ..programs import KernelCache

        cache = KernelCache.get_instance()
        if isinstance(fn_or_path, str):
            cache.from_memory(name, cache.load(fn_or_path))
        else:
            cache.from_memory(name, fn_or_path)

    def set_scene(self, scene: Scene) -> None:
        """rz_renderer.rs:1936-1954."""
        self._host_scene = scene
        self.scene = SceneUploader.upload(
            scene,
            use_mesh_shader=self.use_mesh_shader,
            use_global_meshlets=False,
            use_ray_tracing=False,
        )

    def commit(self) -> None:
        if self.scene is None:
            raise HalaRendererError("commit() before set_scene().")
        self.settings = RasterSettings(
            width=self.info.width,
            height=self.info.height,
            deferred=self.use_deferred,
            msaa=self.msaa,
            chunk=self._chunk,
            binned=self._binned,
            tile=self._tile,
            bin_k_max=self._bin_k_max,
            mesh_shader=self.use_mesh_shader,
            peel_layers=self._peel_layers,
            blend=self._blend,
        )
        # Resolve pushed rz.* kernels into the frame dispatch table (the
        # pipeline-build step of the reference's commit).
        from ..programs import KernelCache

        cache = KernelCache.get_instance()
        hooks = RasterHooks(
            vertex=cache.get("rz.vertex"),
            task=cache.get("rz.task"),
            mesh=cache.get("rz.mesh"),
            fragment=cache.get("rz.fragment"),
        )
        self.hooks = (
            hooks
            if (hooks.vertex or hooks.task or hooks.mesh or hooks.fragment)
            else None
        )

    def update(self, delta_time: float = 0.0, ui_fn=None) -> None:
        """One frame. `ui_fn` is the reference's per-frame UI callback
        (rz_renderer.rs update(..., ui_fn) — records UI draws over the
        shaded image): a jax-traceable (H, W, 3) -> (H, W, 3) applied
        after the post pass, device-side in one jit."""
        self._ui_fn = ui_fn
        if self.settings is None:
            self.commit()
        self.check_and_restore_device()
        t0 = time.monotonic()
        if self.settings.deferred:
            # Two-pass deferred pipeline (rz_renderer.rs:1110-1446,
            # 1455-1570): subpass 1 materializes the visibility/G-buffer,
            # subpass 2 is a fullscreen lighting dispatch. The fragment
            # buffer is cached so lighting can re-run without
            # re-rasterizing (relight()). Transparent materials stay out
            # of the G-buffer (it cannot blend — the reference's hybrid
            # draws them in the forward pass, rz_renderer.rs:896) and
            # composite from cached peel layers after lighting.
            peel = (
                self.scene.materials.has_alpha
                and self.settings.peel_layers > 0
                and self.settings.blend != "none"
            )
            hooks = getattr(self, "hooks", None)
            cam = jnp.int32(self.camera_index)
            self._frag = gbuffer_pass(
                self.scene, cam, self.settings, hooks,
                tri_mask=(
                    ~_transparent_tris(self.scene) if peel else None
                ),
            )
            self._peel = (
                peel_layers_pass(self.scene, cam, self.settings, hooks)
                if peel else None
            )
            color, gbuffer = lighting_pass(
                self.scene, self._frag, cam, self.settings, hooks,
            )
            color = self._composite_peel(color)
        else:
            color, gbuffer = raster_frame(
                self.scene, jnp.int32(self.camera_index), self.settings,
                getattr(self, "hooks", None),
            )
        if self.post_program is not None:
            color = self.post_program.dispatch(color)
        if ui_fn is not None:
            color = jax.jit(ui_fn)(color)
        self._pending = (color, gbuffer)
        self.color = color
        self.gbuffer = gbuffer
        self._last_cpu_time = time.monotonic() - t0

    def relight(self) -> None:
        """Deferred-only: re-run the lighting pass on the cached
        visibility buffer without re-rasterizing (the point of the
        G-buffer split — e.g. light changes with static geometry)."""
        if not (self.settings and self.settings.deferred):
            raise HalaRendererError("relight() requires deferred mode.")
        if getattr(self, "_frag", None) is None:
            raise HalaRendererError("relight() before update().")
        color, gbuffer = lighting_pass(
            self.scene, self._frag, jnp.int32(self.camera_index),
            self.settings, getattr(self, "hooks", None),
        )
        color = self._composite_peel(color)
        if self.post_program is not None:
            color = self.post_program.dispatch(color)
        self._pending = (color, gbuffer)
        self.color = color
        self.gbuffer = gbuffer

    def _composite_peel(self, color):
        """Blend the cached transparency layers (deferred path) over the
        lit color; relight() reuses the cached layers so light changes
        re-shade transparency without re-peeling."""
        if getattr(self, "_peel", None) is None:
            return color
        h, w, _ = color.shape
        flat = peel_composite_pass(
            self.scene, self._peel, color.reshape(-1, 3),
            self._frag.depth, jnp.int32(self.camera_index),
            self.settings, getattr(self, "hooks", None),
        )
        return flat.reshape(h, w, 3)

    def get_final_image(self) -> np.ndarray:
        self.wait_idle()
        img = jnp.asarray(self.color)
        if self.enable_tonemap:
            img = apply_tonemap(img, True, True, True)
        return np.asarray(img)

    def save_image(self, path: str) -> None:
        write_pfm(path, self.get_final_image())

    def _restore_device_state(self) -> None:
        if self._host_scene is not None:
            self.set_scene(self._host_scene)
