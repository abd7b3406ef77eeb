"""Software rasterization: vertex transform + edge-function coverage.

Role parity: the reference's rasterization pipelines
(rz_renderer.rs:429-505): vertex layout {pos, normal, tangent, uv}
(vertex.rs), reverse-Z depth test with CompareOp::GREATER
(rz_renderer.rs:494), negative-viewport y-flip (rz_renderer.rs:861-869).
The fixed-function rasterizer becomes a chunked scan: every pixel tests
triangle chunks with edge functions and keeps the reverse-Z max depth —
the same memory shape as the brute-force ray intersector, so XLA fuses
the whole pixel pipeline. Tile binning (BASELINE config[5]) layers on
top by restricting each tile's chunk list.

Perspective-correct interpolation uses 1/w-weighted barycentrics.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp


class FragmentBuffer(NamedTuple):
    """Per-pixel visibility result (flat over pixels)."""

    depth: jnp.ndarray  # (N,) reverse-Z depth (0 = far plane/clear)
    tri: jnp.ndarray    # (N,) i32 triangle id, -1 = background
    u: jnp.ndarray      # (N,) perspective-correct barycentric of v1
    v: jnp.ndarray      # (N,) of v2


def transform_vertices(positions: jnp.ndarray, view_proj: jnp.ndarray):
    """World -> clip space. positions (V, 3), view_proj (4, 4) -> (V, 4)."""
    homo = jnp.concatenate(
        [positions, jnp.ones_like(positions[..., :1])], axis=-1
    )
    # float32 product (the GPU default would round operands to TF32 and
    # move screen positions by ~1e-3 relative)
    return jnp.matmul(homo, view_proj.T, precision=jax.lax.Precision.HIGHEST)


def clip_to_screen(clip: jnp.ndarray, width: int, height: int):
    """Clip -> (screen xy, reverse-Z depth, inv_w). Y-flip parity with the
    reference's negative-height viewport."""
    w = clip[..., 3]
    safe_w = jnp.where(jnp.abs(w) < 1e-9, 1e-9, w)
    inv_w = 1.0 / safe_w
    ndc = clip[..., :3] * inv_w[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * width
    sy = (1.0 - (ndc[..., 1] * 0.5 + 0.5)) * height
    return jnp.stack([sx, sy], axis=-1), ndc[..., 2], inv_w


def rasterize(
    tri_screen: jnp.ndarray,   # (T, 3, 2) screen xy per corner
    tri_depth: jnp.ndarray,    # (T, 3) reverse-Z depth per corner
    tri_inv_w: jnp.ndarray,    # (T, 3) 1/w per corner
    tri_valid: jnp.ndarray,    # (T,) bool (in front of near plane etc.)
    px: jnp.ndarray,           # (N,) pixel centers x
    py: jnp.ndarray,           # (N,)
    chunk: int = 512,
    tri_ids: jnp.ndarray | None = None,  # (T,) i32 global ids (>= 0)
    depth_bound: jnp.ndarray | None = None,  # (N,) exclusive reverse-Z cap
    seam_dedup: bool = False,
) -> FragmentBuffer:
    """Full visibility: every pixel vs every triangle chunk, keeping the
    reverse-Z GREATER winner (rz_renderer.rs:494).

    With `tri_ids`, the fragment `tri` field carries the GLOBAL id
    resolved in-kernel via the winner one-hot (vector math) — callers
    binning through candidate lists must NOT remap with a per-pixel
    `take(ids, frag.tri)` afterwards (one more gather per pixel).

    With `depth_bound`, a pixel only accepts fragments strictly FARTHER
    than its bound (depth < bound in reverse-Z) — the depth-peeling
    primitive: pass layer k's depths as layer k+1's bound to extract
    successive transparency layers front to back.

    `seam_dedup` applies a top-left-style fill rule: a pixel center
    exactly ON an edge belongs to only ONE of the two triangles sharing
    it (the one whose oriented edge points "down", ties to "leftward").
    Without it both triangles of a coplanar quad cover their shared
    diagonal (inclusive >= 0 edge tests), and under peeling an ulp of
    interpolated-depth difference lets the second coplanar fragment
    through the strict bound — the same pane composites twice along the
    seam. Off by default to keep the opaque paths bit-stable."""
    n = px.shape[0]
    t = tri_screen.shape[0]
    chunk = min(chunk, t)
    assert t % chunk == 0, "triangle buffers must be chunk-padded"
    p = jnp.stack([px, py], axis=-1)  # (N, 2)

    init = FragmentBuffer(
        depth=jnp.zeros((n,)),
        tri=jnp.full((n,), -1, jnp.int32),
        u=jnp.zeros((n,)),
        v=jnp.zeros((n,)),
    )

    def body(carry: FragmentBuffer, ci):
        start = ci * chunk
        s = jax.lax.dynamic_slice_in_dim(tri_screen, start, chunk)  # (C,3,2)
        dz = jax.lax.dynamic_slice_in_dim(tri_depth, start, chunk)
        iw = jax.lax.dynamic_slice_in_dim(tri_inv_w, start, chunk)
        ok = jax.lax.dynamic_slice_in_dim(tri_valid, start, chunk)
        gid = (
            None if tri_ids is None
            else jax.lax.dynamic_slice_in_dim(tri_ids, start, chunk)
        )

        a, b, c = s[:, 0], s[:, 1], s[:, 2]  # (C, 2)
        # Edge function e(p) = cross(p1 - p0, p - p0): positive on the
        # interior side for CCW triangles, sign-consistent with `area`.
        def edge(p0, p1):
            d = p1 - p0  # (C, 2)
            return (
                d[None, :, 0] * (p[:, None, 1] - p0[None, :, 1])
                - d[None, :, 1] * (p[:, None, 0] - p0[None, :, 0])
            )  # (N, C)

        w0 = edge(b, c)
        w1 = edge(c, a)
        w2 = edge(a, b)
        area = (
            (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
            - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
        )  # (C,)
        # Two-sided: accept either winding by sign-normalizing.
        sgn = jnp.where(area >= 0, 1.0, -1.0)
        if seam_dedup:
            # screen y is DOWN; the oriented (interior-positive) edge
            # vector is sgn * (p1 - p0). Accept an exactly-on-edge
            # pixel only for the "down or leftward-horizontal" edge —
            # exactly one of the two triangles sharing the edge.
            def accept(w, p0, p1):
                d = p1 - p0  # (C, 2)
                dx = d[:, 0] * sgn
                dy = d[:, 1] * sgn
                tl = (dy > 0) | ((dy == 0) & (dx < 0))
                ws = w * sgn[None, :]
                return (ws > 0) | ((ws == 0) & tl[None, :])

            cover = accept(w0, b, c) & accept(w1, c, a) & accept(w2, a, b)
        else:
            cover = (
                (w0 * sgn[None, :] >= 0)
                & (w1 * sgn[None, :] >= 0)
                & (w2 * sgn[None, :] >= 0)
            )
        inside = (
            cover
            & (jnp.abs(area)[None, :] > 1e-12)
            & ok[None, :]
        )
        inv_area = 1.0 / jnp.where(jnp.abs(area) > 1e-12, area, 1.0)
        l0 = w0 * inv_area[None, :]
        l1 = w1 * inv_area[None, :]
        l2 = w2 * inv_area[None, :]
        # Depth interpolates linearly in screen space (z_ndc is already /w).
        z = l0 * dz[None, :, 0] + l1 * dz[None, :, 1] + l2 * dz[None, :, 2]
        # Perspective-correct barycentrics via 1/w weights.
        iw_i = (
            l0 * iw[None, :, 0] + l1 * iw[None, :, 1] + l2 * iw[None, :, 2]
        )

        z = jnp.where(inside, z, -1.0)
        if depth_bound is not None:
            z = jnp.where(z < depth_bound[:, None], z, -1.0)
        z_best = jnp.max(z, axis=1)
        # Gather-free winner resolve: per-pixel row gathers
        # (u_pc[rows, argmax]) would each be one gather per pixel, and
        # the full (N, C) perspective divides are wasted on losers.
        # Instead pick the
        # first column achieving z_best (== argmax tie order) with a
        # one-hot mask and divide only the winner's weights.
        cols = jax.lax.broadcasted_iota(jnp.int32, z.shape, 1)
        is_best = (z == z_best[:, None]) & inside
        tri_loc = jnp.min(jnp.where(is_best, cols, chunk), axis=1)
        onehot = cols == tri_loc[:, None]
        iw_sel = jnp.sum(jnp.where(onehot, iw_i, 0.0), axis=1)
        uw = jnp.sum(jnp.where(onehot, l1 * iw[None, :, 1], 0.0), axis=1)
        vw = jnp.sum(jnp.where(onehot, l2 * iw[None, :, 2], 0.0), axis=1)
        u_pc = uw / jnp.maximum(iw_sel, 1e-12)
        v_pc = vw / jnp.maximum(iw_sel, 1e-12)
        if gid is None:
            tri_win = (start + tri_loc).astype(jnp.int32)
        else:
            # ids+1 so "no winner" (all-false one-hot) decodes to -1,
            # distinguishable from global id 0.
            tri_win = jnp.sum(
                jnp.where(onehot, gid[None, :] + 1, 0), axis=1
            ) - 1
        better = z_best > carry.depth  # reverse-Z GREATER
        return FragmentBuffer(
            depth=jnp.where(better, z_best, carry.depth),
            tri=jnp.where(better, tri_win, carry.tri),
            u=jnp.where(better, u_pc, carry.u),
            v=jnp.where(better, v_pc, carry.v),
        ), None

    out, _ = jax.lax.scan(body, init, jnp.arange(t // chunk))
    return out


def rasterize_meshlet_binned(
    tri_screen: jnp.ndarray,   # (T, 3, 2)
    tri_depth: jnp.ndarray,    # (T, 3)
    tri_inv_w: jnp.ndarray,    # (T, 3)
    tri_valid: jnp.ndarray,    # (T,)
    ml_tri: jnp.ndarray,       # (M, 128) meshlet -> triangle slots, -1 pad
    ml_visible: jnp.ndarray,   # (M,) bool (task-stage cull result)
    width: int,
    height: int,
    tile: int = 64,
    km_max: int = 16,
) -> tuple[FragmentBuffer, jnp.ndarray]:
    """Mesh-shader-style rasterization: MESHLETS are the binning and
    draw granularity (draw_mesh_tasks(ceil(meshlets/32)) role,
    /root/reference/src/rz_renderer.rs:957-962). The task stage culls
    meshlets (ml_visible), each surviving meshlet's screen AABB is the
    union of its triangles' AABBs, tiles collect up to km_max candidate
    meshlets, and the per-pixel depth test runs over the candidates'
    triangle lists — a tile never touches triangles of meshlets it
    cannot see. Returns (fragments, overflow fraction of tiles whose
    meshlet list clipped)."""
    m = ml_tri.shape[0]
    tw = -(-width // tile)
    th = -(-height // tile)
    km_max = min(km_max, m)

    # meshlet screen AABB = union of member-triangle screen AABBs
    smin_t = jnp.min(tri_screen, axis=1)  # (T, 2)
    smax_t = jnp.max(tri_screen, axis=1)
    member = jnp.maximum(ml_tri, 0)
    mvalid = (ml_tri >= 0) & jnp.take(tri_valid, member)  # (M, 128)
    big = jnp.float32(1e9)
    ml_min = jnp.min(
        jnp.where(mvalid[..., None],
                  jnp.take(smin_t, member, axis=0), big),
        axis=1,
    )  # (M, 2)
    ml_max = jnp.max(
        jnp.where(mvalid[..., None],
                  jnp.take(smax_t, member, axis=0), -big),
        axis=1,
    )
    ml_live = ml_visible & jnp.any(mvalid, axis=1)

    tile_ids = jnp.arange(tw * th, dtype=jnp.int32)

    def per_tile(tid):
        tx = (tid % tw) * tile
        ty = (tid // tw) * tile
        x0, y0 = jnp.float32(0) + tx, jnp.float32(0) + ty
        overlap = (
            ml_live
            & (ml_max[:, 0] >= x0)
            & (ml_min[:, 0] <= x0 + tile)
            & (ml_max[:, 1] >= y0)
            & (ml_min[:, 1] <= y0 + tile)
        )
        count = jnp.sum(overlap.astype(jnp.int32))
        mids = jnp.argsort(~overlap, stable=True).astype(jnp.int32)[:km_max]
        msel = jnp.arange(km_max) < count

        # mesh stage: expand candidate meshlets to their triangle lists
        tris = jnp.take(ml_tri, mids, axis=0)        # (km, 128)
        tsel = msel[:, None] & (tris >= 0)
        ids = jnp.maximum(tris, 0).reshape(-1)       # (km*128,)
        sel = (
            tsel.reshape(-1)
            & jnp.take(tri_valid, ids)
        )
        s = jnp.take(tri_screen, ids, axis=0)
        dz = jnp.take(tri_depth, ids, axis=0)
        iw = jnp.take(tri_inv_w, ids, axis=0)
        pix = jnp.arange(tile * tile, dtype=jnp.int32)
        px = (pix % tile + tx).astype(jnp.float32) + 0.5
        py = (pix // tile + ty).astype(jnp.float32) + 0.5
        frag = rasterize(s, dz, iw, sel, px, py, chunk=128, tri_ids=ids)
        return frag, count > km_max

    frags, over = jax.vmap(per_tile)(tile_ids)

    def untile(a):
        a = a.reshape(th, tw, tile, tile)
        a = a.transpose(0, 2, 1, 3).reshape(th * tile, tw * tile)
        return a[:height, :width].reshape(-1)

    out = FragmentBuffer(
        depth=untile(frags.depth),
        tri=untile(frags.tri),
        u=untile(frags.u),
        v=untile(frags.v),
    )
    return out, jnp.mean(over.astype(jnp.float32))


def _rasterize_tiled_scatter(
    tri_screen: jnp.ndarray,   # (T, 3, 2)
    tri_depth: jnp.ndarray,    # (T, 3)
    tri_inv_w: jnp.ndarray,    # (T, 3)
    tri_valid: jnp.ndarray,    # (T,)
    width: int,
    height: int,
    tile: int,
    k_max: int,
    large_max: int = 256,
) -> tuple[FragmentBuffer, jnp.ndarray]:
    """Scatter-table binning for LARGE meshes (the path `rasterize_tiled`
    takes past ~4k triangles).

    The per-tile-overlap path is O(tiles x T) in both the AABB tests and
    the per-tile argsort — at 167k triangles x 510 tiles that is an 85M-
    element sort per frame. Here binning is O(T log T + tiles x k_max):
    each small triangle (tile-span <= 2x2) is replicated into its <= 4
    covered tiles' buckets by ONE global sort on the (cell id, tri id)
    pairs + a positional scatter into a dense (tiles, k_max) id table;
    triangles larger than 2x2 tiles go to a shared capped list every
    tile tests (walls/floors — few at mesh scale). Per-slot triangle
    data is prefetched table-aligned so the vmapped per-tile raster does
    ZERO per-tile gathers. Overflow reports the fraction of tiles whose
    bucket (or the shared large list) clipped, matching the overlap
    path's contract."""
    t = tri_screen.shape[0]
    tw = -(-width // tile)
    th = -(-height // tile)
    n_tiles = tw * th
    kb = min(k_max, t)
    lmax = min(large_max, t)

    smin = jnp.min(tri_screen, axis=1)  # (T, 2)
    smax = jnp.max(tri_screen, axis=1)
    onscreen = (
        tri_valid
        & (smax[:, 0] >= 0.0) & (smin[:, 0] <= width)
        & (smax[:, 1] >= 0.0) & (smin[:, 1] <= height)
    )
    inv_t = 1.0 / tile
    bx0 = jnp.clip(jnp.floor(smin[:, 0] * inv_t).astype(jnp.int32), 0, tw - 1)
    bx1 = jnp.clip(jnp.floor(smax[:, 0] * inv_t).astype(jnp.int32), 0, tw - 1)
    by0 = jnp.clip(jnp.floor(smin[:, 1] * inv_t).astype(jnp.int32), 0, th - 1)
    by1 = jnp.clip(jnp.floor(smax[:, 1] * inv_t).astype(jnp.int32), 0, th - 1)
    spanx = bx1 - bx0
    spany = by1 - by0
    small = onscreen & (spanx <= 1) & (spany <= 1)

    ids = jnp.arange(t, dtype=jnp.int32)
    sent = jnp.int32(n_tiles)
    keys = []
    for dx in (0, 1):
        for dy in (0, 1):
            ok = small & (spanx >= dx) & (spany >= dy)
            cell = (by0 + dy) * tw + (bx0 + dx)
            keys.append(jnp.where(ok, cell, sent))
    key4 = jnp.concatenate(keys)
    id4 = jnp.concatenate([ids] * 4)
    k_s, p_s = jax.lax.sort((key4, id4), num_keys=1)
    # Rank within bucket: index minus the bucket's first sorted index.
    iota = jnp.arange(4 * t, dtype=jnp.int32)
    is_start = k_s != jnp.concatenate([jnp.full((1,), -1, jnp.int32),
                                       k_s[:-1]])
    pos = iota - jax.lax.cummax(jnp.where(is_start, iota, 0))
    slot = jnp.where(
        (k_s < sent) & (pos < kb), k_s * kb + pos, n_tiles * kb
    )
    tbl = (
        jnp.full((n_tiles * kb + 1,), -1, jnp.int32)
        .at[slot].set(p_s, mode="drop")[:n_tiles * kb]
        .reshape(n_tiles, kb)
    )
    cnt = (
        jnp.zeros((n_tiles + 1,), jnp.int32)
        .at[jnp.minimum(k_s, sent)].max(pos + 1, mode="drop")
    )
    tile_over = cnt[:n_tiles] > kb

    big = onscreen & ~small
    _, b_sorted = jax.lax.sort(
        (jnp.where(big, 0, 1).astype(jnp.int32), ids), num_keys=1
    )
    l_ids = b_sorted[:lmax]
    sel_big = jnp.take(big, l_ids)
    big_over = jnp.sum(big.astype(jnp.int32)) > lmax

    def fetch(idbuf):
        safe = jnp.maximum(idbuf.reshape(-1), 0)
        return (
            jnp.take(tri_screen, safe, axis=0),
            jnp.take(tri_depth, safe, axis=0),
            jnp.take(tri_inv_w, safe, axis=0),
        )

    s_tbl, dz_tbl, iw_tbl = fetch(tbl)
    s_tbl = s_tbl.reshape(n_tiles, kb, 3, 2)
    dz_tbl = dz_tbl.reshape(n_tiles, kb, 3)
    iw_tbl = iw_tbl.reshape(n_tiles, kb, 3)
    sel_tbl = tbl >= 0
    s_big, dz_big, iw_big = fetch(l_ids)

    tile_ids = jnp.arange(n_tiles, dtype=jnp.int32)
    pix = jnp.arange(tile * tile, dtype=jnp.int32)

    def per_tile(tid, s_r, dz_r, iw_r, sel_r, id_r, over_r):
        tx = (tid % tw) * tile
        ty = (tid // tw) * tile
        s = jnp.concatenate([s_r, s_big], axis=0)
        dz = jnp.concatenate([dz_r, dz_big], axis=0)
        iw = jnp.concatenate([iw_r, iw_big], axis=0)
        sel = jnp.concatenate([sel_r, sel_big], axis=0)
        cids = jnp.concatenate([id_r, l_ids], axis=0)
        px = (pix % tile + tx).astype(jnp.float32) + 0.5
        py = (pix // tile + ty).astype(jnp.float32) + 0.5
        frag = rasterize(
            s, dz, iw, sel, px, py, chunk=kb + lmax, tri_ids=cids
        )
        return frag, over_r | big_over

    frags, over = jax.vmap(per_tile)(
        tile_ids, s_tbl, dz_tbl, iw_tbl, sel_tbl, tbl, tile_over
    )

    def untile(a):
        a = a.reshape(th, tw, tile, tile)
        a = a.transpose(0, 2, 1, 3).reshape(th * tile, tw * tile)
        return a[:height, :width].reshape(-1)

    out = FragmentBuffer(
        depth=untile(frags.depth),
        tri=untile(frags.tri),
        u=untile(frags.u),
        v=untile(frags.v),
    )
    return out, jnp.mean(over.astype(jnp.float32))


def raster_route(platform: str, num_tris: int, tile: int) -> str:
    """The path `rasterize_tiled(scatter=None)` takes for a mesh of
    `num_tris` triangles on a jax platform.

    Up to 4096 triangles the per-tile overlap table ("overlap") holds
    every candidate. Past that both capped tables drop geometry at the
    atrium_big bench camera, so large meshes take an exact path: the
    segment kernel (ops/raster_kernel.py, "exact") on a GPU, the full
    O(pixels x triangles) XLA scan ("scan", the reference) on the CPU
    or when the tile is not a power of two."""
    if platform not in ("gpu", "cpu"):
        raise ValueError(
            f"no raster path for jax platform {platform!r} "
            "(supported: gpu, cpu)"
        )
    if num_tris <= 4096:
        return "overlap"
    if platform == "gpu" and tile & (tile - 1) == 0:
        return "exact"
    return "scan"


def rasterize_tiled(
    tri_screen: jnp.ndarray,   # (T, 3, 2)
    tri_depth: jnp.ndarray,    # (T, 3)
    tri_inv_w: jnp.ndarray,    # (T, 3)
    tri_valid: jnp.ndarray,    # (T,)
    width: int,
    height: int,
    tile: int = 64,
    k_max: int = 256,
    scatter: bool | str | None = None,
    interpret: bool = False,
) -> tuple[FragmentBuffer, jnp.ndarray]:
    """Tile-binned rasterization (BASELINE config[5]): triangles are
    binned to screen tiles by their screen AABB; each tile tests only its
    candidate list, cutting work from O(pixels x triangles) to
    O(pixels x bin occupancy).

    Returns (FragmentBuffer flat over pixels, overflow fraction of tiles
    whose candidate list clipped at k_max). Meshlets are the natural
    binning granularity upstream (SURVEY.md section 7 stage 7).

    `scatter=None` picks the path with raster_route; "exact" forces the
    segment kernel (`interpret=True` runs it in the Pallas interpreter),
    "scan" the full scan, True the capped scatter table and False the
    capped per-tile-overlap path."""
    t = tri_screen.shape[0]
    if scatter is None:
        route = raster_route(jax.default_backend(), t, tile)
        scatter = False if route == "overlap" else route
    if scatter == "exact":
        from .raster_kernel import rasterize_tiled_exact

        return rasterize_tiled_exact(
            tri_screen, tri_depth, tri_inv_w, tri_valid,
            width, height, tile=tile, interpret=interpret,
        )
    if scatter == "scan":
        pix = jnp.arange(width * height, dtype=jnp.int32)
        frag = rasterize(
            tri_screen, tri_depth, tri_inv_w, tri_valid,
            (pix % width).astype(jnp.float32) + 0.5,
            (pix // width).astype(jnp.float32) + 0.5,
            chunk=math.gcd(512, t),
        )
        return frag, jnp.float32(0.0)
    if scatter:
        return _rasterize_tiled_scatter(
            tri_screen, tri_depth, tri_inv_w, tri_valid,
            width, height, tile, k_max,
        )
    tw = -(-width // tile)
    th = -(-height // tile)
    k_max = min(k_max, t)

    # Triangle screen AABBs.
    smin = jnp.min(tri_screen, axis=1)  # (T, 2)
    smax = jnp.max(tri_screen, axis=1)

    tile_ids = jnp.arange(tw * th, dtype=jnp.int32)

    def per_tile(tid):
        tx = (tid % tw) * tile
        ty = (tid // tw) * tile
        x0, y0 = jnp.float32(0) + tx, jnp.float32(0) + ty
        overlap = (
            tri_valid
            & (smax[:, 0] >= x0)
            & (smin[:, 0] <= x0 + tile)
            & (smax[:, 1] >= y0)
            & (smin[:, 1] <= y0 + tile)
        )
        count = jnp.sum(overlap.astype(jnp.int32))
        ids = jnp.argsort(~overlap, stable=True).astype(jnp.int32)[:k_max]
        sel = jnp.arange(k_max) < count

        s = jnp.take(tri_screen, ids, axis=0)
        dz = jnp.take(tri_depth, ids, axis=0)
        iw = jnp.take(tri_inv_w, ids, axis=0)
        pix = jnp.arange(tile * tile, dtype=jnp.int32)
        px = (pix % tile + tx).astype(jnp.float32) + 0.5
        py = (pix // tile + ty).astype(jnp.float32) + 0.5
        frag = rasterize(s, dz, iw, sel, px, py, chunk=k_max, tri_ids=ids)
        return frag, count > k_max

    # vmap, NOT lax.map: batched, the bin+test work runs as a handful
    # of fused whole-screen ops instead of one small step per tile.
    frags, over = jax.vmap(per_tile)(tile_ids)
    # Reassemble tiles -> (H_pad, W_pad) -> crop
    def untile(a):
        a = a.reshape(th, tw, tile, tile)
        a = a.transpose(0, 2, 1, 3).reshape(th * tile, tw * tile)
        return a[:height, :width].reshape(-1)

    out = FragmentBuffer(
        depth=untile(frags.depth),
        tri=untile(frags.tri),
        u=untile(frags.u),
        v=untile(frags.v),
    )
    return out, jnp.mean(over.astype(jnp.float32))
