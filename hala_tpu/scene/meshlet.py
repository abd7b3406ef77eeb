"""Meshlet record used by the raster path's cluster pipeline.

Parity: reference src/scene/meshlet.rs:4-15 (HalaMeshlet) and the
meshopt clustering parameters used by the uploader
(gpu_uploader.rs:577-583: max_vertices=64, max_triangles=124,
cone_weight=0.5). Here the meshlet doubles as the binning granularity
of the tile-binned software rasterizer.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MESHLET_MAX_VERTICES = 64
MESHLET_MAX_PRIMITIVES = 124
MESHLET_CONE_WEIGHT = 0.5


@dataclasses.dataclass
class Meshlet:
    """Cluster of <=64 vertices / <=124 triangles (meshlet.rs:4-15)."""

    center: np.ndarray        # (3,) bounding sphere center
    radius: float
    cone_apex: np.ndarray     # (3,)
    cone_cutoff: float
    cone_axis: np.ndarray     # (3,)
    num_of_vertices: int
    offset_of_vertices: int
    num_of_primitives: int
    offset_of_primitives: int
    draw_index: int = 0
