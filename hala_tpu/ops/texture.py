"""Manual texture sampling from the padded texture stack.

Role parity: the reference's combined-image-sampler descriptor arrays
with LINEAR mipmap samplers (gpu_uploader.rs:334-353 creates samplers
with mipmap_mode LINEAR). There is no texture unit here, so this is software
trilinear with REPEAT wrap over TextureStack (SURVEY.md section 7
hard-part #4): bilinear at the two bracketing packed mip levels,
lerped by the fractional LOD.
"""

from __future__ import annotations

import jax.numpy as jnp


def _bilinear_addrs(stack, sizes, idx, uv, level):
    """Corner addresses + lerp fractions for one mip level.

    Returns ((a00, a01, a10, a11), fx, fy) over the FLATTENED stack —
    shared by the per-map path and the packed multi-map path so both
    produce bit-identical texels."""
    h0 = sizes[:, 0].astype(jnp.int32)
    w0 = sizes[:, 1].astype(jnp.int32)
    max_h = stack.data.shape[1] // 2

    lh = jnp.maximum(h0 >> level, 1)
    lw = jnp.maximum(w0 >> level, 1)
    # packed pyramid row offset: sum_{k<l} max_h >> k = 2*max_h*(1 - 2^-l)
    # (exact because the canvas height is padded to a power of two).
    row_off = 2 * max_h - (jnp.int32(2 * max_h) >> level)

    h = lh.astype(jnp.float32)
    w = lw.astype(jnp.float32)
    u = uv[:, 0] - jnp.floor(uv[:, 0])
    v = uv[:, 1] - jnp.floor(uv[:, 1])
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    def wrap(c, n):
        return jnp.mod(c.astype(jnp.int32), jnp.maximum(n, 1))

    x0i, x1i = wrap(x0, lw), wrap(x0 + 1, lw)
    y0i = wrap(y0, lh) + row_off
    y1i = wrap(y0 + 1, lh) + row_off
    th, tw = stack.data.shape[1], stack.data.shape[2]
    base = idx * (th * tw)
    return (
        (
            base + y0i * tw + x0i,
            base + y0i * tw + x1i,
            base + y1i * tw + x0i,
            base + y1i * tw + x1i,
        ),
        fx, fy,
    )


def _lerp2(c00, c01, c10, c11, fx, fy):
    return (
        c00 * (1 - fx) * (1 - fy)
        + c01 * fx * (1 - fy)
        + c10 * (1 - fx) * fy
        + c11 * fx * fy
    )


def _bilinear(stack, idx, tex_idx, uv, level):
    """Bilinear fetch at one mip level. level (N,) i32."""
    sizes = jnp.take(stack.sizes, idx, axis=0)  # (N, 2) h, w (level 0)
    addrs, fx, fy = _bilinear_addrs(stack, sizes, idx, uv, level)
    # Single-index row gathers from the flattened stack: take() over
    # the linearized index instead of a 3-vector advanced index (a
    # multi-dim XLA gather; as in ops/env.py _bilinear). The four corner takes merge
    # into ONE (integer addresses are exact; the lerp keeps its (N, .)
    # shape, so output bits are unchanged — the round-5 takes-packing
    # rule).
    flat = stack.data.reshape(-1, stack.data.shape[3])
    c = jnp.take(flat, jnp.concatenate(addrs), axis=0)
    c00, c01, c10, c11 = jnp.split(c, 4)
    return _lerp2(c00, c01, c10, c11, fx, fy)


def sample_texture(
    stack, tex_idx: jnp.ndarray, uv: jnp.ndarray, lod_uv=None
) -> jnp.ndarray:
    """Trilinear sample: tex_idx (N,) i32 (-1 = none -> white), uv (N,2).

    Returns (N, 4) RGBA. REPEAT addressing on both axes. `lod_uv` is an
    optional per-ray log2 footprint in UV units; the sampler adds
    log2(texture width) and lerps between the two bracketing packed mip
    levels (LINEAR mipmap_mode parity). Without `lod_uv` (or a 1-level
    stack) it is plain bilinear at level 0.
    """
    idx = jnp.maximum(tex_idx, 0)

    if lod_uv is not None and stack.num_levels > 1:
        sizes = jnp.take(stack.sizes, idx, axis=0)
        w0 = sizes[:, 1].astype(jnp.float32)
        lod = jnp.clip(
            lod_uv + jnp.log2(jnp.maximum(w0, 1.0)),
            0.0,
            float(stack.num_levels - 1),
        )
        l0 = jnp.floor(lod).astype(jnp.int32)
        l1 = jnp.minimum(l0 + 1, stack.num_levels - 1)
        fl = (lod - l0.astype(jnp.float32))[:, None]
        texel = (
            _bilinear(stack, idx, tex_idx, uv, l0) * (1.0 - fl)
            + _bilinear(stack, idx, tex_idx, uv, l1) * fl
        )
    else:
        texel = _bilinear(stack, idx, tex_idx, uv, jnp.zeros_like(idx))
    return jnp.where((tex_idx >= 0)[:, None], texel, 1.0)


def sample_textures_packed(stack, tex_idxs, uv, lod_uv=None, lods=None):
    """Trilinear-sample M maps at the SAME (uv, lod) with ONE texel
    gather (row-take packing, DESIGN round-3 EnvMap trick applied to
    the material fetch sites — VERDICT r4 item 2).

    The per-map path issues 8 corner takes + 2 sizes takes per map
    (26 gather ops per bounce for base+mr+em); here every corner
    address of every map and both bracketing mip levels concatenate
    into ONE take over the flattened stack (plus one packed sizes
    take). Per-lane texel math reuses the exact `_bilinear` address and
    lerp expressions, so results are bit-identical to M separate
    `sample_texture` calls when compiled standalone.

    Used by the path-tracing megakernel for the base/mr/emission trio
    (integrator._path_context). Bit-stability caveat: an earlier
    variant also ran the LERP chain at the packed (M*N) shape and XLA
    re-associated its fma differently between the film-tiled and
    single-device frame programs — 1-2 ULP divergence even inside
    optimization barriers (round-5 ledger). The shipped variant packs
    ONLY the integer corner takes and keeps every float expression at
    the per-map (N, .) shape, which measured 0 mismatches across
    device counts.

    tex_idxs: list of (N,) i32 (-1 = none -> white). Returns a list of
    (N, 4) RGBA in the same order. `lods` optionally gives a PER-MAP
    lod (entries None -> level-0 bilinear for that map, e.g. the
    normal map rides the same take as the trilinear base/mr/em trio);
    mutually exclusive with the shared `lod_uv`.
    """
    m = len(tex_idxs)
    if lods is None:
        lods = [lod_uv] * m
    assert len(lods) == m
    if m == 1:
        return [sample_texture(stack, tex_idxs[0], uv, lods[0])]
    n = uv.shape[0]
    flat = stack.data.reshape(-1, stack.data.shape[3])

    # Per-map FLOAT math at the original (N, ...) shapes; only the
    # integer corner ADDRESSES concatenate into the one big take.
    # (An earlier variant also ran the lerp chain at the packed (M*N)
    # shape and XLA re-associated its fma differently between the
    # film-tiled and single-device frame programs — 1-2 ULP divergence
    # even inside optimization barriers. Integer gathers are exact, so
    # packing ONLY the takes keeps every float expression at the
    # per-map shape the separate path compiles, preserving frame
    # bit-identity across device counts.)
    per_map = []
    addr_chunks = []
    for ti, ld in zip(tex_idxs, lods):
        idx = jnp.maximum(ti, 0)
        sizes = jnp.take(stack.sizes, idx, axis=0)
        if ld is not None and stack.num_levels > 1:
            w0 = sizes[:, 1].astype(jnp.float32)
            lod = jnp.clip(
                ld + jnp.log2(jnp.maximum(w0, 1.0)),
                0.0,
                float(stack.num_levels - 1),
            )
            l0 = jnp.floor(lod).astype(jnp.int32)
            l1 = jnp.minimum(l0 + 1, stack.num_levels - 1)
            fl = (lod - l0.astype(jnp.float32))[:, None]
            a0, fx0, fy0 = _bilinear_addrs(stack, sizes, idx, uv, l0)
            a1, fx1, fy1 = _bilinear_addrs(stack, sizes, idx, uv, l1)
            addr_chunks.extend(a0 + a1)
            per_map.append((ti, 8, fl, fx0, fy0, fx1, fy1))
        else:
            a, fx, fy = _bilinear_addrs(
                stack, sizes, idx, uv, jnp.zeros_like(idx)
            )
            addr_chunks.extend(a)
            per_map.append((ti, 4, None, fx, fy, None, None))
    c_all = jnp.take(flat, jnp.concatenate(addr_chunks), axis=0)
    out = []
    off = 0
    for ti, k, fl, fx0, fy0, fx1, fy1 in per_map:
        cs = [c_all[(off + j) * n:(off + j + 1) * n] for j in range(k)]
        off += k
        if k == 8:
            texel = (
                _lerp2(cs[0], cs[1], cs[2], cs[3], fx0, fy0) * (1.0 - fl)
                + _lerp2(cs[4], cs[5], cs[6], cs[7], fx1, fy1) * fl
            )
        else:
            texel = _lerp2(cs[0], cs[1], cs[2], cs[3], fx0, fy0)
        out.append(jnp.where((ti >= 0)[:, None], texel, 1.0))
    return out
