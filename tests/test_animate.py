"""Animation / refit path: device-side node retransform + cluster refit
(ops/animate.py). Parity: the reference's per-frame object uniforms +
BLAS refit (/root/reference/src/rz_renderer.rs:38-53, 690-716)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from hala_tpu.models.integrator import (
    Film,
    RenderSettings,
    Uniforms,
    render_frame,
)
from hala_tpu.ops.animate import build_deltas, retransform_geometry
from hala_tpu.ops.intersect import intersect_bruteforce
from hala_tpu.scene.loader.uploader import SceneUploader
from hala_tpu.scene.procedural import cornell_box


def _translate(dx, dy, dz):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (dx, dy, dz)
    return m


@pytest.fixture()
def host_scene():
    return cornell_box()


def _mesh_nodes(scene):
    return [i for i, n in enumerate(scene.nodes) if n.mesh_index is not None]


class TestRetransform:
    def test_matches_fresh_upload(self, host_scene):
        """Moving a node on device must match re-uploading a host scene
        whose node was moved (same world-space triangles to fp
        tolerance), with traversal still exact."""
        dev = SceneUploader.upload(host_scene, use_ray_tracing=False)
        node = _mesh_nodes(host_scene)[0]
        delta = _translate(0.25, 0.5, -0.125)
        deltas, ndeltas = build_deltas(
            dev.prim_node, {node: delta}, len(host_scene.nodes)
        )
        g2 = retransform_geometry(dev.geometry, deltas, ndeltas)

        # host-side: bake the move into the node and re-upload
        host2 = cornell_box()
        host2.nodes[node].world_transform = (
            delta @ host2.nodes[node].world_transform
        )
        ref = SceneUploader.upload(host2, use_ray_tracing=False).geometry

        np.testing.assert_allclose(
            np.asarray(g2.tri_v0), np.asarray(ref.tri_v0), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(g2.normals), np.asarray(ref.normals), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(g2.cluster_min), np.asarray(ref.cluster_min),
            atol=1e-4,
        )
        np.testing.assert_allclose(
            np.asarray(g2.shade_table), np.asarray(ref.shade_table),
            atol=1e-4,
        )

        # the kernel over the retransformed soup stays exact
        rs = np.random.RandomState(0)
        o = jnp.asarray(
            rs.uniform(-0.8, 0.8, (256, 3)).astype(np.float32)
            + np.asarray([0, 1, 0], np.float32)
        )
        d = rs.normal(size=(256, 3)).astype(np.float32)
        d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True))
        bf = intersect_bruteforce(o, d, g2.tri_v0, g2.tri_e1, g2.tri_e2)
        from hala_tpu.ops.pallas.intersect_kernel import intersect_pallas

        hit = intersect_pallas(
            o, d, g2.tri_v0, g2.tri_e1, g2.tri_e2, interpret=True
        )
        np.testing.assert_array_equal(
            np.asarray(hit.tri), np.asarray(bf.tri)
        )

    def test_identity_delta_is_noop(self, host_scene):
        dev = SceneUploader.upload(host_scene, use_ray_tracing=False)
        deltas, ndeltas = build_deltas(
            dev.prim_node, {}, len(host_scene.nodes)
        )
        g2 = retransform_geometry(dev.geometry, deltas, ndeltas)
        np.testing.assert_allclose(
            np.asarray(g2.tri_v0), np.asarray(dev.geometry.tri_v0),
            atol=1e-6,
        )
        np.testing.assert_allclose(
            np.asarray(g2.tri_packed), np.asarray(dev.geometry.tri_packed),
            atol=1e-6,
        )


class TestRendererAnimation:
    def test_moved_object_renders_at_new_position(self, host_scene):
        """End-to-end: set_node_transform + update_scene moves the tall
        box; the render matches a fresh upload of the moved scene (same
        RNG, same settings) without any host geometry re-upload."""
        from hala_tpu.models.rt_renderer import RayTracingRenderer

        r = RayTracingRenderer("anim", 32, 32, max_frames=1, tile_size=256)
        r.set_scene(host_scene)
        r.commit()
        node = _mesh_nodes(host_scene)[0]
        new_world = (
            _translate(0.3, 0.0, 0.2)
            @ np.asarray(host_scene.nodes[node].world_transform, np.float32)
        )
        r.set_node_transform(node, new_world)
        r.update_scene()
        r.render_loop(1)
        img = np.asarray(r.film.accum)

        host2 = cornell_box()
        host2.nodes[node].world_transform = new_world
        dev2 = SceneUploader.upload(host2, use_ray_tracing=False)
        settings = RenderSettings(
            width=32, height=32, max_depth=r.max_depth,
            rr_depth=r.rr_depth, tile_size=256,
        )
        film = Film.create(32, 32)
        film, _ = render_frame(
            dev2, None, Uniforms.default(), film, 0, settings
        )
        ref = np.asarray(film.accum)
        assert np.isfinite(img).all()
        np.testing.assert_allclose(img, ref, atol=2e-3)

    def test_two_updates_compose(self, host_scene):
        """Two successive update_scene calls accumulate (delta vs the
        CURRENT baked transform, not the original)."""
        from hala_tpu.models.rt_renderer import RayTracingRenderer

        r = RayTracingRenderer("anim2", 16, 16, max_frames=1, tile_size=256)
        r.set_scene(host_scene)
        r.commit()
        node = _mesh_nodes(host_scene)[0]
        w0 = np.asarray(host_scene.nodes[node].world_transform, np.float32)
        r.set_node_transform(node, _translate(0.1, 0, 0) @ w0)
        r.update_scene()
        r.set_node_transform(node, _translate(0.1, 0.2, 0) @ w0)
        r.update_scene()
        got = np.asarray(r.scene.geometry.tri_v0)

        host2 = cornell_box()
        host2.nodes[node].world_transform = _translate(0.1, 0.2, 0) @ w0
        ref = SceneUploader.upload(host2, use_ray_tracing=False)
        np.testing.assert_allclose(
            got, np.asarray(ref.geometry.tri_v0), atol=1e-4
        )

    def test_reset_accumulation_restarts_progressive_mean(self, host_scene):
        """reset_accumulation: after N frames + reset, one more frame
        equals a fresh renderer's first frame bit-for-bit (frame index
        and film both restart — rt_renderer.rs:393-414 budget/seed
        role)."""
        from hala_tpu.models.rt_renderer import RayTracingRenderer

        r = RayTracingRenderer("reset", 16, 16, max_frames=8, tile_size=256)
        r.set_scene(host_scene)
        r.commit()
        r.render_loop(3)
        r.reset_accumulation()
        assert float(np.abs(np.asarray(r.film.accum)).max()) == 0.0
        r.render_loop(1)
        got = np.asarray(r.film.accum)

        r2 = RayTracingRenderer("fresh", 16, 16, max_frames=8, tile_size=256)
        r2.set_scene(host_scene)
        r2.commit()
        r2.render_loop(1)
        np.testing.assert_array_equal(got, np.asarray(r2.film.accum))
