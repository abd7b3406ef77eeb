"""Multi-device scaling over a jax.sharding.Mesh.

The reference is single-process/single-GPU (SURVEY.md section 2.11);
this package is the greenfield multi-device scaling layer. Two composable modes over the 1-D mesh axis:

- film tiling (tiling.py): scene replicated, each chip owns its film
  rows — zero communication in the render loop;
- geometry sharding (scene_shard.py): cluster blocks + shade rows
  sharded too (tensor-parallel), rays all-gathered per query and hits
  merged with a lexicographic (t, tri) min — lifts the one-card memory
  ceiling on scene size.
"""

from .scene_shard import render_frame_scene_sharded, shard_scene
from .tiling import make_mesh, render_frame_multichip, TiledFilm

__all__ = [
    "make_mesh",
    "render_frame_multichip",
    "render_frame_scene_sharded",
    "shard_scene",
    "TiledFilm",
]
