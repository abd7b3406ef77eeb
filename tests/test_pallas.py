"""Pallas (Triton) intersect kernel tests, in interpret mode on the CPU,
against the XLA brute force (ops/intersect.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hala_tpu.ops.intersect import intersect_bruteforce, occluded_bruteforce
from hala_tpu.ops.pallas.intersect_kernel import (
    BLOCK_RAYS,
    BLOCK_TRIS,
    intersect_pallas,
    occluded_pallas,
)
from hala_tpu.scene.loader.uploader import SceneUploader
from hala_tpu.scene.procedural import cornell_box, random_triangle_soup


def _rays(n, rs):
    o = rs.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _soup(t, rs, pad_to=None):
    """t random triangles in the unit cube, zero-padded to pad_to slots."""
    v0 = rs.uniform(-1, 1, (t, 3)).astype(np.float32)
    e1 = rs.uniform(-0.6, 0.6, (t, 3)).astype(np.float32)
    e2 = rs.uniform(-0.6, 0.6, (t, 3)).astype(np.float32)
    pad = (pad_to or t) - t
    z = lambda a: jnp.asarray(np.pad(a, ((0, pad), (0, 0))))
    return z(v0), z(e1), z(e2)


def _assert_hits_match(out, ref):
    np.testing.assert_array_equal(np.asarray(out.tri), np.asarray(ref.tri))
    np.testing.assert_allclose(
        np.asarray(out.t), np.asarray(ref.t), rtol=1e-6
    )
    hit = np.asarray(ref.tri) >= 0
    for a, b in ((out.u, ref.u), (out.v, ref.v)):
        np.testing.assert_allclose(
            np.asarray(a)[hit], np.asarray(b)[hit], atol=1e-5
        )


class TestPallasIntersect:
    def test_matches_bruteforce_cornell(self, rs):
        geom = SceneUploader.upload(cornell_box(), use_ray_tracing=False).geometry
        o, d = _rays(300, rs)  # non-multiple of the ray block: pad path
        ref = intersect_bruteforce(
            o, d, geom.tri_v0, geom.tri_e1, geom.tri_e2, chunk=128
        )
        out = intersect_pallas(
            o, d, geom.tri_v0, geom.tri_e1, geom.tri_e2, interpret=True
        )
        _assert_hits_match(out, ref)

    def test_multi_chunk_soup(self, rs):
        """Several triangle tiles: exercises the in-program tile loop."""
        scene = random_triangle_soup(300, seed=5)
        geom = SceneUploader._upload_geometry(scene)
        assert geom.tri_v0.shape[0] == 384  # 3 blocks of 128
        o, d = _rays(256, rs)
        ref = intersect_bruteforce(
            o, d, geom.tri_v0, geom.tri_e1, geom.tri_e2, chunk=128
        )
        out = intersect_pallas(
            o, d, geom.tri_v0, geom.tri_e1, geom.tri_e2, interpret=True
        )
        _assert_hits_match(out, ref)

    def test_occlusion(self, rs):
        geom = SceneUploader.upload(cornell_box(), use_ray_tracing=False).geometry
        o, d = _rays(128, rs)
        t_far = jnp.full((128,), 1.5)
        ref = occluded_bruteforce(
            o, d, t_far, geom.tri_v0, geom.tri_e1, geom.tri_e2, chunk=128
        )
        out = occluded_pallas(
            o, d, t_far, geom.tri_v0, geom.tri_e1, geom.tri_e2, interpret=True
        )
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))

    def test_t_max_respected(self, rs):
        geom = SceneUploader.upload(cornell_box(), use_ray_tracing=False).geometry
        o = jnp.asarray([[0.0, 0.0, 3.0]])
        d = jnp.asarray([[0.0, 0.0, -1.0]])
        near = intersect_pallas(
            o, d, geom.tri_v0, geom.tri_e1, geom.tri_e2,
            t_max=jnp.asarray([0.5]), interpret=True,
        )
        assert int(near.tri[0]) == -1  # wall is beyond t_max


# Triangle counts around the tile width (1 triangle, one short of a
# tile, a tile and one more), a count with zero padding behind it, and
# ray counts off the ray block.
_TRIS = [1, BLOCK_TRIS - 1, BLOCK_TRIS + 1, 200]
_RAYS = [1, BLOCK_RAYS - 3, 3 * BLOCK_RAYS + 5]


class TestKernelAgainstBruteforce:
    @pytest.mark.parametrize("n_tris", _TRIS)
    @pytest.mark.parametrize("n_rays", _RAYS)
    def test_closest_hit(self, n_tris, n_rays):
        rs = np.random.RandomState(n_tris * 1000 + n_rays)
        tris = _soup(n_tris, rs, pad_to=-(-n_tris // 128) * 128)
        o, d = _rays(n_rays, rs)
        ref = intersect_bruteforce(o, d, *tris, chunk=128)
        out = intersect_pallas(o, d, *tris, interpret=True)
        _assert_hits_match(out, ref)

    @pytest.mark.parametrize("n_tris", _TRIS)
    @pytest.mark.parametrize("n_rays", _RAYS)
    def test_any_hit(self, n_tris, n_rays):
        rs = np.random.RandomState(7 + n_tris * 1000 + n_rays)
        tris = _soup(n_tris, rs, pad_to=-(-n_tris // 128) * 128)
        o, d = _rays(n_rays, rs)
        t_far = jnp.asarray(rs.uniform(0.0, 2.0, n_rays).astype(np.float32))
        ref = occluded_bruteforce(o, d, t_far, *tris, chunk=128)
        out = occluded_pallas(o, d, t_far, *tris, interpret=True)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))

    @pytest.mark.parametrize("t_max", ["none", "scalar", "per_ray"])
    def test_t_max_forms(self, t_max, rs):
        tris = _soup(100, rs, pad_to=128)
        o, d = _rays(150, rs)
        tm = {
            "none": None,
            "scalar": jnp.float32(0.8),
            "per_ray": jnp.asarray(rs.uniform(0, 2, 150).astype(np.float32)),
        }[t_max]
        ref = intersect_bruteforce(o, d, *tris, t_max=tm, chunk=128)
        out = intersect_pallas(o, d, *tris, t_max=tm, interpret=True)
        _assert_hits_match(out, ref)

    @pytest.mark.parametrize("any_hit", [False, True])
    def test_all_padding_never_hits(self, any_hit, rs):
        """A table of zero (degenerate) triangles: every ray misses."""
        tris = tuple(jnp.zeros((128, 3), jnp.float32) for _ in range(3))
        o, d = _rays(70, rs)
        if any_hit:
            out = occluded_pallas(o, d, jnp.full((70,), 5.0), *tris,
                                  interpret=True)
            assert not np.asarray(out).any()
        else:
            out = intersect_pallas(o, d, *tris, interpret=True)
            assert (np.asarray(out.tri) == -1).all()

    @pytest.mark.parametrize("num_real", [1, 33, 128])
    def test_num_real_prefix(self, num_real, rs):
        """num_real trims the scan to the tiles holding the real prefix
        (the Morton tail-padded layout): equal to the full scan."""
        tris = _soup(num_real, rs, pad_to=256)
        o, d = _rays(100, rs)
        ref = intersect_bruteforce(o, d, *tris, chunk=128)
        out = intersect_pallas(o, d, *tris, num_real=num_real,
                               interpret=True)
        _assert_hits_match(out, ref)

    @pytest.mark.parametrize(
        "block_rays,block_tris", [(16, 8), (32, 64), (128, 16)]
    )
    def test_block_shapes(self, block_rays, block_tris, rs):
        tris = _soup(150, rs, pad_to=256)
        o, d = _rays(90, rs)
        ref = intersect_bruteforce(o, d, *tris, chunk=128)
        out = intersect_pallas(
            o, d, *tris, interpret=True, block_rays=block_rays,
            block_tris=block_tris,
        )
        _assert_hits_match(out, ref)

    def test_ties_break_to_lowest_id(self):
        """Two copies of one triangle: the reference scan keeps the
        lower id, and so must the kernel (across tiles too)."""
        v0 = np.zeros((64, 3), np.float32)
        e1 = np.zeros((64, 3), np.float32)
        e2 = np.zeros((64, 3), np.float32)
        for k in (5, 40):  # different BLOCK_TRIS tiles
            v0[k] = [-1, -1, 0]
            e1[k] = [2, 0, 0]
            e2[k] = [0, 2, 0]
        o = jnp.asarray([[-0.5, -0.4, 1.0]], jnp.float32)
        d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
        out = intersect_pallas(o, d, jnp.asarray(v0), jnp.asarray(e1),
                               jnp.asarray(e2), interpret=True)
        assert int(out.tri[0]) == 5

    def test_inside_shard_map(self, rs):
        """Rays sharded over an 8-device CPU mesh, triangles replicated:
        each shard's kernel call equals the unsharded query."""
        from jax.sharding import Mesh, PartitionSpec as P

        devices = jax.devices()[:8]
        mesh = Mesh(np.array(devices), ("x",))
        tris = _soup(90, rs, pad_to=128)
        o, d = _rays(8 * 40, rs)
        ref = intersect_pallas(o, d, *tris, interpret=True)

        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P("x"), P("x"), P(), P(), P()), out_specs=P("x"),
            check_vma=False,
        )
        def sharded(o_s, d_s, v0, e1, e2):
            return intersect_pallas(o_s, d_s, v0, e1, e2, interpret=True)

        out = sharded(o, d, *tris)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestIntegratorPallasPath:
    def test_render_frame_with_pallas_intersector(self, cornell_device_scene):
        from hala_tpu.models.integrator import (
            Film,
            RenderSettings,
            Uniforms,
            render_frame,
        )

        s = RenderSettings(
            width=16, height=16, max_depth=2, tile_size=256,
            intersector="pallas", interpret_pallas=True,
        )
        s_ref = RenderSettings(
            width=16, height=16, max_depth=2, tile_size=256,
            intersector="bruteforce",
        )
        uni = Uniforms.default()
        fa, _ = render_frame(
            cornell_device_scene, None, uni, Film.create(16, 16), 0, s
        )
        fb, _ = render_frame(
            cornell_device_scene, None, uni, Film.create(16, 16), 0, s_ref
        )
        np.testing.assert_allclose(
            np.asarray(fa.accum), np.asarray(fb.accum), atol=1e-3
        )
