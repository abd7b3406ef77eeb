#!/usr/bin/env python
"""End-to-end example: progressive path trace of a real glTF/GLB file.

    python examples/render_gltf.py [scene.glb] [frames] [out_prefix]

Defaults to the bundled assets/atrium.glb (34k triangles, embedded PNG
textures, quad area lights). Visibility takes the integrator's "auto"
backend (the Pallas kernel on a GPU, the XLA brute force on the CPU);
writes {out}_color.pfm / _albedo.pfm /
_normal.pfm like the reference's save_images.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hala_tpu import RayTracingRenderer, Scene


def main() -> None:
    root = os.path.join(os.path.dirname(__file__), "..")
    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        root, "assets", "atrium.glb"
    )
    frames = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    out = sys.argv[3] if len(sys.argv) > 3 else "out/atrium"

    renderer = RayTracingRenderer(
        os.path.basename(path), 960, 544,
        max_depth=4, max_frames=frames, tile_size=131072,
    )
    renderer.set_scene(Scene.load(path))
    renderer.commit()
    renderer.render_loop(frames)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    renderer.save_images(out + ".png")
    print(
        f"{frames} frames, {renderer.total_rays / 1e6:.1f} Mrays -> "
        f"{out}_color.pfm"
    )


if __name__ == "__main__":
    main()
