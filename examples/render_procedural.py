#!/usr/bin/env python
"""Procedural-primitive example: analytic spheres traced beside the
Cornell Box triangles (the reference's AABB-geometry + intersection-
shader path, gpu_uploader.rs:818-840 — registered in code, not glTF).

    python examples/render_procedural.py [frames] [out_prefix]

Three spheres with different material responses (diffuse, Disney
metal, emissive) shade through the full material system and block
shadow rays; a fused multi-frame dispatch renders the progressive
window in few XLA programs (`frames_per_dispatch`).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from hala_tpu import Material, MaterialType, ProceduralSphere, RayTracingRenderer
from hala_tpu.scene.procedural import cornell_box


def main():
    frames = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    out = sys.argv[2] if len(sys.argv) > 2 else "./out/procedural"
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)

    scene = cornell_box()

    blue = Material(base_color=np.array([0.2, 0.4, 0.9], np.float32))
    metal = Material(
        type=MaterialType.DISNEY,
        base_color=np.array([0.95, 0.85, 0.6], np.float32),
        metallic=1.0, roughness=0.15,
    )
    glow = Material(
        base_color=np.array([1.0, 1.0, 1.0], np.float32),
        emission=np.array([6.0, 3.0, 1.5], np.float32),
    )
    for mat, center, radius in (
        (blue, (-0.45, -0.65, 0.1), 0.35),
        (metal, (0.45, -0.7, -0.2), 0.30),
        (glow, (0.0, 0.35, -0.4), 0.15),
    ):
        scene.materials.append(mat)
        scene.procedurals.append(
            ProceduralSphere(
                center=center, radius=radius,
                material=len(scene.materials) - 1,
            )
        )

    r = RayTracingRenderer(
        "procedural", 512, 512,
        max_depth=6, rr_depth=2,
        enable_tonemap=True, enable_aces=True, use_simple_aces=False,
        max_frames=frames,
    )
    r.set_scene(scene)
    r.commit()
    r.render_loop(frames, frames_per_dispatch=min(16, frames))
    r.save_images(out + ".png")
    m = r.statistics.last_metrics
    print(
        f"rendered {frames} frames "
        f"({m['mrays_per_s']:.1f} Mrays/s) -> {out}_color.pfm"
    )


if __name__ == "__main__":
    main()
