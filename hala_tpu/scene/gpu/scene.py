"""Device scene: SoA jnp buffers, registered as pytrees.

Parity: reference src/scene/gpu/scene.rs:11-37 (gpu::HalaScene) and the
#[repr(C, align(16))] record layouts in gpu/{camera,light,material,mesh}.rs.
Those layouts are the parity contract; here each record field becomes a
column of a structure-of-arrays buffer, and the TLAS/BLAS handles become an LBVH node table built by
`hala_tpu.ops.bvh`.

Geometry is pre-transformed to world space at upload (the reference keeps
object space + a 3x4 instance transform in the TLAS,
gpu_uploader.rs:843-874; here a flat world-space SoA removes a gather
and an indirection from the traversal hot loop). `tri_prim` keeps the
flattened (node, primitive) instance id — the TLAS `custom_index` parity —
so per-primitive lookups (material, mesh data) still work.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# Caps match gpu_uploader.rs:39-40.
MAX_CAMERA_COUNT = 8
MAX_LIGHT_COUNT = 32

# Triangle-count padding granularity: one f32 VPU tile lane row.
TRI_PAD = 128


def _register(cls, meta_fields=()):
    data_fields = tuple(
        f.name for f in dataclasses.fields(cls) if f.name not in meta_fields
    )
    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=tuple(meta_fields)
    )
    return cls


@partial(
    _register,
    meta_fields=("num_triangles", "num_primitives", "prefix_layout"),
)
@dataclasses.dataclass
class DeviceGeometry:
    """World-space triangle soup, SoA, padded to a multiple of TRI_PAD.

    Padding triangles carry material -1 and degenerate edges so they can
    never be hit. Replaces per-primitive vertex/index device buffers +
    BLAS geometry (gpu_uploader.rs:406-498, 782-815).
    """

    tri_v0: jax.Array      # (T, 3) f32 — first vertex
    tri_e1: jax.Array      # (T, 3) f32 — v1 - v0
    tri_e2: jax.Array      # (T, 3) f32 — v2 - v0
    normals: jax.Array     # (T, 3, 3) f32 — per-corner shading normals
    tangents: jax.Array    # (T, 3, 3) f32
    uvs: jax.Array         # (T, 3, 2) f32
    tri_mat: jax.Array     # (T,) i32 — material index, -1 for padding
    tri_prim: jax.Array    # (T,) i32 — flattened instance id (custom_index parity)
    # Packed per-triangle shading attributes, one row-gather per hit
    # instead of ~10 scalar gathers. Layout (T, 32) f32:
    # [0:3] n0 [3:6] n1 [6:9] n2 [9:11] uv0 [11:13] uv1 [13:15] uv2
    # [15:18] geometric normal [18] material id [19] primitive id.
    shade_table: jax.Array | None = None
    # Cluster tables (triangles are SAH- or Morton-ordered at upload, so
    # each TRI_PAD chunk is a spatial cluster): per-cluster AABBs and
    # the (C, 16, TRI_PAD) packed geometry blocks (ops/cluster.py): rows
    # = components [v0.xyz | e1.xyz | e2.xyz | 7 pad], columns = the
    # cluster's triangles. Geometry sharding splits at these blocks.
    cluster_min: jax.Array | None = None   # (C, 3)
    cluster_max: jax.Array | None = None   # (C, 3)
    tri_packed: jax.Array | None = None    # (C, 16, TRI_PAD)
    num_triangles: int = 0   # un-padded count (static)
    num_primitives: int = 0  # instance count (static)
    # True iff real triangles occupy the prefix [0, num_triangles) of the
    # slot arrays (Morton tail-padded layout). The binned-SAH layout
    # scatters real triangles past that prefix (interior padding), so
    # consumers that trim by num_triangles MUST check this flag
    # (CLAUDE.md invariant: mask with tri_mat >= 0 otherwise).
    prefix_layout: bool = True


@partial(
    _register,
    meta_fields=(
        "has_disney", "has_transmission", "has_absorb_medium",
        "has_normal_map", "has_alpha", "has_scatter_medium",
        "has_emissive_medium", "has_uv_transform",
    ),
)
@dataclasses.dataclass
class DeviceMaterials:
    """Material table (gpu/material.rs:16-48 layout, SoA).

    `ax`/`ay` hold the precomputed BSDF terms from gpu/material.rs:53-69:
    DIFFUSE -> Oren-Nayar A/B from sigma = roughness * pi/4;
    DISNEY -> anisotropic GGX alphas from alpha = roughness^2.
    `roughness` is the post-precompute value the shaders read (raw for
    DIFFUSE, squared for DISNEY).
    """

    base_color: jax.Array            # (M, 3)
    opacity: jax.Array               # (M,)
    emission: jax.Array              # (M, 3)
    anisotropic: jax.Array           # (M,)
    metallic: jax.Array              # (M,)
    roughness: jax.Array             # (M,)
    subsurface: jax.Array            # (M,)
    specular_tint: jax.Array         # (M,)
    sheen: jax.Array                 # (M,)
    sheen_tint: jax.Array            # (M,)
    clearcoat: jax.Array             # (M,)
    clearcoat_roughness: jax.Array   # (M,)
    clearcoat_tint: jax.Array        # (M, 3)
    specular_transmission: jax.Array  # (M,)
    ior: jax.Array                   # (M,)
    ax: jax.Array                    # (M,)
    ay: jax.Array                    # (M,)
    medium_color: jax.Array          # (M, 3)
    medium_density: jax.Array        # (M,)
    medium_anisotropy: jax.Array     # (M,)
    medium_type: jax.Array           # (M,) i32
    # KHR_texture_transform per material (from the baseColorTexture
    # binding): (offset_u, offset_v, rotation, scale_u, scale_v).
    uv_transform: jax.Array          # (M, 5)
    mat_type: jax.Array              # (M,) i32 — 0 DIFFUSE, 1 DISNEY
    base_color_map: jax.Array        # (M,) i32, -1 = none
    normal_map: jax.Array            # (M,) i32
    metallic_roughness_map: jax.Array  # (M,) i32
    emission_map: jax.Array          # (M,) i32
    # Packed (M, 32) f32 table mirroring the columns above so the
    # integrator gathers one row per hit (see gather_materials). Layout:
    # [0:3] base_color [3] opacity [4:7] emission [7] metallic
    # [8] roughness [9] subsurface [10] specular_tint [11] sheen
    # [12] sheen_tint [13] clearcoat [14] clearcoat_roughness
    # [15:18] clearcoat_tint [18] specular_transmission [19] ior
    # [20] ax [21] ay [22] mat_type [23] base_color_map
    # [24] metallic_roughness_map [25] emission_map [26] normal_map
    # [27] anisotropic.
    packed: jax.Array | None = None
    # Static scene capability flags (the analog of the reference's
    # shader-permutation probes, cpu/scene.rs:59-95): the integrator
    # compiles out BSDF lobes no material in the scene uses.
    has_disney: bool = True
    has_transmission: bool = True
    has_absorb_medium: bool = False
    has_normal_map: bool = False
    has_alpha: bool = False  # any opacity < 1 (cpu/scene.rs has_transparent)
    has_scatter_medium: bool = False  # any SCATTER medium (has_medium_with)
    has_emissive_medium: bool = False  # any EMISSIVE medium (type 3)
    has_uv_transform: bool = False     # any non-identity KHR_texture_transform


@partial(_register, meta_fields=("num_lights",))
@dataclasses.dataclass
class DeviceLights:
    """Light table (gpu/light.rs:8-32 layout, SoA), padded to
    MAX_LIGHT_COUNT. Field semantics per type follow gpu/light.rs comments
    and gpu_uploader.rs:157-274 construction."""

    intensity: jax.Array   # (L, 3) — color * intensity
    position: jax.Array    # (L, 3)
    u: jax.Array           # (L, 3)
    v: jax.Array           # (L, 3)
    radius: jax.Array      # (L,)
    area: jax.Array        # (L,)
    ltype: jax.Array       # (L,) i32; -1 for padding
    aabb_min: jax.Array    # (L, 3) — light AABBs (gpu_uploader light BLAS role)
    aabb_max: jax.Array    # (L, 3)
    num_lights: int = 0


@partial(_register, meta_fields=("num_cameras",))
@dataclasses.dataclass
class DeviceCameras:
    """Camera table (gpu/camera.rs:10-20 layout, SoA), padded to
    MAX_CAMERA_COUNT. forward = -Z axis of the node world transform
    (gpu/camera.rs:28-32)."""

    position: jax.Array       # (C, 3)
    right: jax.Array          # (C, 3)
    up: jax.Array             # (C, 3)
    forward: jax.Array        # (C, 3)
    yfov: jax.Array           # (C,)
    focal_or_xmag: jax.Array  # (C,) focal_distance (persp) or xmag (ortho)
    aperture_or_ymag: jax.Array  # (C,)
    ctype: jax.Array          # (C,) i32: 0 perspective, 1 orthographic
    view_matrix: jax.Array    # (C, 4, 4) — world_transform^-1 (gpu_uploader.rs:114)
    proj_matrix: jax.Array    # (C, 4, 4) — reverse-Z projection
    num_cameras: int = 0


@partial(_register, meta_fields=("num_textures", "num_levels"))
@dataclasses.dataclass
class TextureStack:
    """Padded texture array with a packed mip pyramid.

    The reference uploads per-texture Vulkan images with full mip chains
    and LINEAR/REPEAT samplers (gpu_uploader.rs:334-403, gen_mipmaps).
    There is no texture unit here: all textures are padded into one
    (NT, 2H, W, 4) f32 canvas where mip level l occupies rows
    [H*(2 - 2^(1-l)) ...) at width W/2^l — per-ray LOD selection is then
    just a computed row/col offset into one bilinear fetch
    (`ops.texture`), no per-level branching.
    """

    data: jax.Array    # (NT, 2H, W, 4) f32 packed pyramid
    sizes: jax.Array   # (NT, 2) i32 — level-0 (height, width) used
    num_textures: int = 0
    num_levels: int = 1


@partial(_register, meta_fields=("num_meshlets",))
@dataclasses.dataclass
class DeviceMeshlets:
    """Meshlet cull tables for the mesh-shader-style raster path
    (reference meshlet pipeline, gpu_uploader.rs:555-765 + the task
    shader's cone culling). `tri_meshlet` maps every triangle of the
    Morton-ordered soup to its meshlet."""

    cone_apex: jax.Array    # (M, 3)
    cone_axis: jax.Array    # (M, 3)
    cone_cutoff: jax.Array  # (M,)
    center: jax.Array       # (M, 3)
    radius: jax.Array       # (M,)
    tri_meshlet: jax.Array  # (T,) i32, -1 for padding
    # per-meshlet triangle SLOT list (M, MESHLET_MAX_TRIS) i32, -1
    # padded — the mesh-shader draw granularity (draw_mesh_tasks role):
    # the meshlet-binned rasterizer expands tiles' candidate meshlets
    # through this table instead of binning individual triangles
    tri_ids: jax.Array | None = None
    num_meshlets: int = 0


@partial(_register, meta_fields=("name", "prim_node"))
@dataclasses.dataclass
class DeviceScene:
    """Everything the integrator kernels read (gpu/scene.rs:11-37 role)."""

    geometry: DeviceGeometry
    materials: DeviceMaterials
    lights: DeviceLights
    cameras: DeviceCameras
    textures: TextureStack | None = None
    meshlets: "DeviceMeshlets | None" = None
    # LBVH node table (ops/bvh.py), the TLAS/BLAS replacement. None until
    # built; the brute-force intersector works without it.
    bvh: "object | None" = None
    # Procedural sphere table (ops/prims.DeviceProcedural) — the
    # AABB-geometry/intersection-shader analog (gpu_uploader.rs:818-840).
    # None compiles the merge out of every visibility query.
    procedural: "object | None" = None
    name: str = "scene"
    # flattened primitive id -> scene node index (the animation path's
    # delta-transform routing, ops/animate.py); static host metadata
    prim_node: tuple = ()


def pad_rows(arr: np.ndarray, total: int, fill=0) -> np.ndarray:
    """Pad axis 0 to `total` rows with `fill`."""
    pad = total - arr.shape[0]
    if pad <= 0:
        return arr
    pad_block = np.full((pad,) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad_block], axis=0)
