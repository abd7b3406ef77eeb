"""Compiled Pallas kernels against their plain references, on the card.

Marked `gpu`: they skip on the CPU (a Triton kernel compiles only for a
GPU) and run with

    HALA_TEST_ON_GPU=1 python -m pytest tests/ -m gpu
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hala_tpu.ops.intersect import (
    canonical_hit,
    intersect_bruteforce,
    occluded_bruteforce,
)
from hala_tpu.ops.pallas.intersect_kernel import (
    intersect_pallas,
    occluded_pallas,
)

pytestmark = pytest.mark.gpu


def _soup(rs, t, n):
    tris = tuple(
        jnp.asarray(rs.uniform(lo, hi, (t, 3)).astype(np.float32))
        for lo, hi in ((-1, 1), (-0.6, 0.6), (-0.6, 0.6))
    )
    o = jnp.asarray(rs.uniform(-0.9, 0.9, (n, 3)).astype(np.float32))
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True))
    return tris, o, d


@pytest.mark.parametrize("t,n", [(128, 1000), (4096, 65536)])
def test_closest_hit_compiled(gpu, t, n):
    tris, o, d = _soup(np.random.RandomState(t), t, n)
    canon = jax.jit(canonical_hit)
    ref = canon(o, d, *tris, jax.jit(intersect_bruteforce)(o, d, *tris))
    out = canon(o, d, *tris, intersect_pallas(o, d, *tris))
    same = np.asarray(ref.tri) == np.asarray(out.tri)
    assert same.mean() >= 0.9999
    np.testing.assert_array_equal(
        np.asarray(ref.t)[same], np.asarray(out.t)[same]
    )


@pytest.mark.parametrize("t,n", [(128, 1000), (4096, 65536)])
def test_any_hit_compiled(gpu, t, n):
    rs = np.random.RandomState(t + 1)
    tris, o, d = _soup(rs, t, n)
    t_far = jnp.asarray(rs.uniform(0, 2, n).astype(np.float32))
    ref = jax.jit(occluded_bruteforce)(o, d, t_far, *tris)
    out = occluded_pallas(o, d, t_far, *tris)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(out))


def test_raster_exact_compiled(gpu):
    from hala_tpu.ops.raster import rasterize
    from hala_tpu.ops.raster_kernel import rasterize_tiled_exact

    rs = np.random.RandomState(3)
    t, w, h = 2000, 256, 192
    c = rs.uniform(0, 256, (t, 1, 2))
    tri = jnp.asarray((c + rs.uniform(-8, 8, (t, 3, 2))).astype(np.float32))
    depth = jnp.asarray(rs.uniform(0.1, 0.9, (t, 3)).astype(np.float32))
    inv_w = jnp.asarray(rs.uniform(0.5, 2.0, (t, 3)).astype(np.float32))
    valid = jnp.ones((t,), bool)
    frag, over = rasterize_tiled_exact(tri, depth, inv_w, valid, w, h,
                                       tile=64)
    pix = jnp.arange(w * h, dtype=jnp.int32)
    ref = jax.jit(rasterize, static_argnames="chunk")(
        tri, depth, inv_w, valid, (pix % w).astype(jnp.float32) + 0.5,
        (pix // w).astype(jnp.float32) + 0.5, chunk=400,
    )
    assert float(over) == 0.0
    np.testing.assert_array_equal(np.asarray(ref.tri), np.asarray(frag.tri))
    np.testing.assert_array_equal(
        np.asarray(ref.depth), np.asarray(frag.depth)
    )
