#!/usr/bin/env python
"""End-to-end example: an animated object inside a progressive render.

    python examples/render_animated.py [frames_per_pose] [out_prefix]

Renders the Cornell box while translating the tall box through three
poses. The tall box is split onto its own scene node, so each
`set_node_transform` + `update_scene` retransforms JUST that node's
triangles ON DEVICE (delta matrix, cluster AABB refit, packed-block
repack — ops/animate.py) with no host re-upload and no jit retrace: the role
of the reference's per-mesh object uniforms rewritten every frame
(/root/reference/src/rz_renderer.rs:38-53, 690-716) plus its implicit
BLAS rebuild. Accumulation restarts at every pose
(`reset_accumulation`) — a moved object invalidates the running mean,
exactly like a reference app zeroing `total_frames`.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from hala_tpu import Mesh, Node, RayTracingRenderer
from hala_tpu.scene.procedural import cornell_box


def _translate(x, y, z):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (x, y, z)
    return m


def main() -> None:
    frames = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    out = sys.argv[2] if len(sys.argv) > 2 else "out/animated"

    scene = cornell_box()
    # cornell_box puts everything on one mesh node: 5 wall quads, then
    # 6 tall-box quads, then 6 short-box quads. Split the tall box onto
    # its own node so it can move independently.
    prims = scene.meshes[0].primitives
    scene.meshes[0].primitives = prims[:5] + prims[11:]
    scene.meshes.append(Mesh(primitives=prims[5:11]))
    box_node = Node(name="tall_box")
    box_node.mesh_index = 1
    scene.nodes.append(box_node)
    scene.update_node_hierarchies()
    node = len(scene.nodes) - 1
    w0 = np.asarray(scene.nodes[node].world_transform, np.float32)

    r = RayTracingRenderer("animated", 512, 512, max_depth=4, rr_depth=2)
    r.set_scene(scene)
    r.commit()

    for pose, dx in enumerate((0.0, 0.15, 0.3)):
        r.set_node_transform(node, _translate(dx, 0.0, 0.0) @ w0)
        r.update_scene()
        r.reset_accumulation()
        r.render_loop(frames)
        r.save_images(f"{out}_pose{pose}.png")
        print(f"pose {pose}: dx={dx:+.2f}, {frames} frames accumulated")


if __name__ == "__main__":
    main()
