"""Brute-force ray-triangle queries as Pallas kernels through Triton.

The GPU replacement for hardware `trace_rays` at the intersection level
(rt_renderer.rs:458-464). `ops.intersect.intersect_bruteforce` is the
plain XLA version of the same query: it writes (rays, chunk) blocks of
t/u/v to device memory for every triangle chunk and reads them back for
the min-reduction. Here one program owns a block of BLOCK_RAYS rays and
keeps their running (t, triangle) best in registers while it streams the
whole triangle table through in BLOCK_TRIS-wide tiles, so the only
device-memory traffic is rays in, triangles in (L2-resident across
programs) and hits out.

* Closest-hit: the kernel returns each ray's winning (t, triangle); the
  wrapper re-evaluates (t, u, v) for the winner with the canonical XLA
  Moller-Trumbore (`ops.intersect.canonical_hit`), so reported bits are
  a pure function of (ray, winning triangle) and match the brute-force
  reference wherever the winners agree. Ties break to the lowest
  triangle id, as in the reference scan.
* Any-hit: a ray block retires as soon as every ray in it is blocked
  (or can never be: t_far at or below the ray epsilon).

Layouts: rays are an (8, N_pad) table (o.xyz, d.xyz, t_max, unused);
triangles a (9, T_pad) table (v0.xyz, e1.xyz, e2.xyz), zero-padded — a
zero triangle has det == 0 and never hits. Block sizes are powers of two
(Triton's block model); the padding to them happens here.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..intersect import T_MAX, Hit, canonical_hit, out_struct

BLOCK_RAYS = 64    # rays per program (registers: rays x tris per step)
BLOCK_TRIS = 32    # triangles per inner step
NUM_WARPS = 4
# Python scalars: a kernel may not capture jax arrays (ops.intersect's
# EPS / T_MAX / ray_triangle t_min, same values).
_EPS = 1.0e-7
_T_BIG = 3.0e38
_T_MIN = 1.0e-4


def _mt_t(tri_ref, ts, ox, oy, oz, dx, dy, dz):
    """Moller-Trumbore t of every (ray, triangle) pair of one tile, in the
    operation order of ops.intersect.ray_triangle; T_MAX where the pair
    misses. Rays are (BR, 1) columns, triangle rows (1, BT)."""
    row = lambda k: tri_ref[k, ts][None, :]
    v0x, v0y, v0z = row(0), row(1), row(2)
    e1x, e1y, e1z = row(3), row(4), row(5)
    e2x, e2y, e2z = row(6), row(7), row(8)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = px * e1x + py * e1y + pz * e1z
    inv_det = jnp.where(jnp.abs(det) > _EPS, 1.0 / det, 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = (
        (jnp.abs(det) > _EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > _T_MIN)
    )
    return jnp.where(valid, t, _T_BIG)


def _tile(j, bt):
    """Slice of triangle tile j (j is 0 for the peeled first tile)."""
    start = j * bt
    if not isinstance(start, int):
        start = pl.multiple_of(start, bt)
    return pl.ds(start, bt)


def _load_rays(ray_ref, br):
    rs = pl.ds(pl.multiple_of(pl.program_id(0) * br, br), br)
    cols = [ray_ref[k, rs] for k in range(7)]
    return rs, [c[:, None] for c in cols[:6]], cols[6]


def _closest_kernel(tri_ref, ray_ref, t_ref, id_ref, *, n_tiles, br, bt):
    rs, r, tmax = _load_rays(ray_ref, br)
    lane = jnp.arange(bt, dtype=jnp.int32)[None, :]

    def tile_best(j):
        """(min t, lowest triangle id at that t) of tile j."""
        tt = _mt_t(tri_ref, _tile(j, bt), *r)
        t_min = jnp.min(tt, axis=1)
        loc = jnp.min(jnp.where(tt == t_min[:, None], lane, bt), axis=1)
        return t_min, j * bt + loc

    def body(j, carry):
        t_best, id_best = carry
        t_min, idx = tile_best(j)
        better = t_min < t_best  # strict: earlier tiles win ties
        return (
            jnp.where(better, t_min, t_best),
            jnp.where(better, idx, id_best),
        )

    # The first tile seeds the carry, so carry and body share one type
    # (inside shard_map too); t_max applies once at the end: the first
    # minimum below t_max is the reference scan's winner.
    t_best, id_best = jax.lax.fori_loop(1, n_tiles, body, tile_best(0))
    hit = t_best < tmax
    t_ref[rs] = jnp.where(hit, t_best, tmax)
    id_ref[rs] = jnp.where(hit, id_best, -1)


def _anyhit_kernel(tri_ref, ray_ref, occ_ref, *, n_tiles, br, bt):
    rs, r, t_far = _load_rays(ray_ref, br)

    def tile_hit(j):
        tt = _mt_t(tri_ref, _tile(j, bt), *r)
        return jnp.max(jnp.where(tt < t_far[:, None], 1, 0), axis=1)

    def cond(carry):
        j, _, done = carry
        return (j < n_tiles) & (jnp.min(done) == 0)

    def body(carry):
        j, blocked, done = carry
        hit = tile_hit(j)
        return j + 1, blocked | hit, done | hit

    # a ray with t_far at or below the ray epsilon can never be blocked
    hit0 = tile_hit(0)
    done0 = hit0 | jnp.where(t_far <= _T_MIN, 1, 0)
    _, blocked, _ = jax.lax.while_loop(cond, body, (1, hit0, done0))
    occ_ref[rs] = blocked


def _tables(o, d, t_col, tri_v0, tri_e1, tri_e2, num_real, br, bt):
    """Padded ray and triangle tables plus the static loop bounds."""
    n = o.shape[0]
    n_pad = -(-n // br) * br
    rays = jnp.concatenate(
        [o.T, d.T, t_col[None, :], jnp.zeros_like(t_col)[None, :]], axis=0
    )
    rays = jnp.pad(rays, ((0, 0), (0, n_pad - n)))
    n_tiles = max(1, -(-num_real // bt))
    tris = jnp.concatenate([tri_v0.T, tri_e1.T, tri_e2.T], axis=0)
    t_slots = tris.shape[1]
    if t_slots < n_tiles * bt:
        tris = jnp.pad(tris, ((0, 0), (0, n_tiles * bt - t_slots)))
    return rays, tris, n_pad, n_tiles


def _call(kernel, rays, tris, out_shape, n_pad, br, interpret, num_warps):
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(n_pad // br,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps),
        interpret=interpret,
    )(tris, rays)


@functools.partial(
    jax.jit,
    static_argnames=(
        "interpret", "num_real", "block_rays", "block_tris", "num_warps",
    ),
)
def intersect_pallas_ranked(
    o: jnp.ndarray,
    d: jnp.ndarray,
    tri_v0: jnp.ndarray,
    tri_e1: jnp.ndarray,
    tri_e2: jnp.ndarray,
    t_max=None,
    interpret: bool = False,
    num_real: int | None = None,
    block_rays: int = BLOCK_RAYS,
    block_tris: int = BLOCK_TRIS,
    num_warps: int = NUM_WARPS,
) -> tuple[Hit, jnp.ndarray]:
    """Closest hit over the first `num_real` triangle slots (all slots
    by default). o, d: (N, 3); tri_*: (T, 3). Returns (hit, t_rank):
    `hit` has the contract of ops.intersect.intersect_bruteforce, with
    canonical (t, u, v); `t_rank` is the kernel's own t of the winner
    (t_max on a miss), the key the kernel ranked triangles by — merging
    per-shard winners on it picks the winner the whole table would."""
    n = o.shape[0]
    if num_real is None:
        num_real = tri_v0.shape[0]
    like = o[:, 0]
    if t_max is None:
        t_col = like * 0.0 + T_MAX
    else:
        t_col = like * 0.0 + jnp.broadcast_to(t_max, (n,)).astype(jnp.float32)
    rays, tris, n_pad, n_tiles = _tables(
        o, d, t_col, tri_v0, tri_e1, tri_e2, num_real, block_rays, block_tris
    )
    kernel = functools.partial(
        _closest_kernel, n_tiles=n_tiles, br=block_rays, bt=block_tris
    )
    t_best, id_best = _call(
        kernel, rays, tris,
        [out_struct((n_pad,), jnp.float32, rays),
         out_struct((n_pad,), jnp.int32, rays)],
        n_pad, block_rays, interpret, num_warps,
    )
    zeros = t_col * 0.0
    hit = Hit(t=t_best[:n], tri=id_best[:n], u=zeros, v=zeros)
    return canonical_hit(o, d, tri_v0, tri_e1, tri_e2, hit), hit.t


def intersect_pallas(o, d, tri_v0, tri_e1, tri_e2, t_max=None,
                     **kwargs) -> Hit:
    """Closest hit: the Hit of intersect_pallas_ranked."""
    return intersect_pallas_ranked(
        o, d, tri_v0, tri_e1, tri_e2, t_max=t_max, **kwargs
    )[0]


@functools.partial(
    jax.jit,
    static_argnames=(
        "interpret", "num_real", "block_rays", "block_tris", "num_warps",
    ),
)
def occluded_pallas(
    o, d, t_far, tri_v0, tri_e1, tri_e2, interpret: bool = False,
    num_real: int | None = None,
    block_rays: int = BLOCK_RAYS,
    block_tris: int = BLOCK_TRIS,
    num_warps: int = NUM_WARPS,
) -> jnp.ndarray:
    """Any-hit: True where a triangle lies in (t_min, t_far), the
    contract of ops.intersect.occluded_bruteforce."""
    n = o.shape[0]
    if num_real is None:
        num_real = tri_v0.shape[0]
    tf = o[:, 0] * 0.0 + jnp.broadcast_to(t_far, (n,)).astype(jnp.float32)
    rays, tris, n_pad, n_tiles = _tables(
        o, d, tf, tri_v0, tri_e1, tri_e2, num_real, block_rays, block_tris
    )
    kernel = functools.partial(
        _anyhit_kernel, n_tiles=n_tiles, br=block_rays, bt=block_tris
    )
    occ = _call(
        kernel, rays, tris, out_struct((n_pad,), jnp.int32, rays),
        n_pad, block_rays, interpret, num_warps,
    )
    return occ[:n] > 0
