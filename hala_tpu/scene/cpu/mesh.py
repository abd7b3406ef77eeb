"""Host-side mesh / primitive.

Parity: reference src/scene/cpu/mesh.rs:6-18 (HalaMesh / HalaPrimitive).
Instead of the reference's AoS `HalaVertex {position, normal, tangent,
tex_coord}` (scene/vertex.rs:1-9, 44-byte interleaved layout), vertices
are kept SoA from the start: separate numpy arrays per attribute. SoA is
the natural device layout for batched kernels, and the loader fills
these directly.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Primitive:
    """One drawable primitive: SoA vertex attributes + u32 indices."""

    indices: np.ndarray          # (I,) u32
    positions: np.ndarray        # (V,3) f32
    normals: np.ndarray          # (V,3) f32
    tangents: np.ndarray         # (V,3) f32
    tex_coords: np.ndarray       # (V,2) f32
    material_index: int = 0xFFFFFFFF
    colors: np.ndarray | None = None  # (V,3) f32 vertex colors (COLOR_0)
    # Filled by the meshlet pass (parity: cpu/mesh.rs meshlet fields,
    # populated by gpu_uploader.rs:555-765).
    meshlets: list = dataclasses.field(default_factory=list)
    meshlet_vertices: np.ndarray | None = None     # (MV,) u32
    meshlet_primitives: np.ndarray | None = None   # (MP,) u32 (3x u8 packed)

    @property
    def vertex_count(self) -> int:
        return int(self.positions.shape[0])

    @property
    def triangle_count(self) -> int:
        return int(self.indices.shape[0] // 3)


@dataclasses.dataclass
class Mesh:
    primitives: list[Primitive]
