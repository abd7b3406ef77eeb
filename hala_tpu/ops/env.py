"""Environment lighting: procedural sky gradient + HDR envmap sampling.

Role parity: the reference's miss shader consuming the global uniform's
env fields (rt_renderer.rs:44-65): env_type SKY(0) blends ground/sky
colors, MAP(1) samples the equirect HDR with the precomputed
inverted-CDF tables (envmap.rs) and applies `env_rotation` (already
normalized by /360 at rt_renderer.rs:420) and `env_intensity`.

Direction <-> equirect convention (self-consistent across eval/sample/
pdf): u = (atan2(d.z, d.x)/(2 pi) + 0.5 + rotation) mod 1,
v = acos(d.y)/pi (v=0 at +Y).
"""

from __future__ import annotations

import jax.numpy as jnp


_EPS = 1e-6
TWO_PI = jnp.float32(2.0 * jnp.pi)


def sky_radiance(d: jnp.ndarray, ground_color, sky_color) -> jnp.ndarray:
    """SKY env type: vertical gradient between ground and sky colors."""
    t = jnp.clip(0.5 * (d[..., 2:3] * 0.0 + d[..., 1:2] + 1.0), 0.0, 1.0)
    return ground_color * (1.0 - t) + sky_color * t


def dir_to_uv(d: jnp.ndarray, rotation) -> tuple[jnp.ndarray, jnp.ndarray]:
    u = jnp.arctan2(d[..., 2], d[..., 0]) / TWO_PI + 0.5 + rotation
    u = u - jnp.floor(u)
    v = jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0)) / jnp.pi
    return u, v


def uv_to_dir(u: jnp.ndarray, v: jnp.ndarray, rotation) -> jnp.ndarray:
    phi = (u - 0.5 - rotation) * TWO_PI
    theta = v * jnp.pi
    sin_t = jnp.sin(theta)
    return jnp.stack(
        [sin_t * jnp.cos(phi), jnp.cos(theta), sin_t * jnp.sin(phi)], axis=-1
    )


def _bilinear(img: jnp.ndarray, u, v):
    """Bilinear fetch from (H, W, C) with wrap in u, clamp in v."""
    h, w = img.shape[0], img.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    x1i = jnp.mod(x0i + 1, w)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0i + 1, 0, h - 1)
    # Single-index row gathers from the flattened table: take() over
    # y*w+x instead of a 2-vector advanced index (img[y, x]), which
    # lowers to a multi-dim XLA gather.
    flat = img.reshape(h * w, -1)
    c00 = jnp.take(flat, y0i * w + x0i, axis=0)
    c01 = jnp.take(flat, y0i * w + x1i, axis=0)
    c10 = jnp.take(flat, y1i * w + x0i, axis=0)
    c11 = jnp.take(flat, y1i * w + x1i, axis=0)
    return (
        c00 * (1 - fx) * (1 - fy)
        + c01 * fx * (1 - fy)
        + c10 * (1 - fx) * fy
        + c11 * fx * fy
    )


def _quad_fetch(env, u, v):
    """ONE 16-wide row take from the precomputed 2x2-neighborhood table
    (EnvMap.quad) returning the four bilinear corners' rgb+luminance:
    one take replaces 4-5 separate takes per fetch site. Returns (c00, c01, c10, c11 (N,4), x0i, y0i, fx, fy)."""
    h, w = env.height, env.width
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    row = jnp.take(env.quad.reshape(h * w, 16), y0i * w + x0i, axis=0)
    return (
        row[:, 0:4], row[:, 4:8], row[:, 8:12], row[:, 12:16],
        x0i, y0i, fx, fy,
    )


def _quad_bilinear(c00, c01, c10, c11, fx, fy):
    fx = fx[..., None]
    fy = fy[..., None]
    return (
        c00 * (1 - fx) * (1 - fy)
        + c01 * fx * (1 - fy)
        + c10 * (1 - fx) * fy
        + c11 * fx * fy
    )


def env_radiance(env, d: jnp.ndarray, rotation, intensity) -> jnp.ndarray:
    """Bilinear equirect lookup of emitted radiance along d."""
    u, v = dir_to_uv(d, rotation)
    if env.quad is not None:
        c00, c01, c10, c11, _, _, fx, fy = _quad_fetch(env, u, v)
        return _quad_bilinear(
            c00[:, :3], c01[:, :3], c10[:, :3], c11[:, :3], fx, fy
        ) * intensity
    return _bilinear(env.image, u, v) * intensity


def env_pdf(env, d: jnp.ndarray, rotation) -> jnp.ndarray:
    """Solid-angle pdf of env_sample for direction d (MIS weighting).

    p(texel) = lum(texel) / total_lum (the per-row normalization cancels,
    see envmap.rs:277-308); pdf_sw = p * W*H / (2 pi^2 sin(theta)).
    """
    h, w = env.height, env.width
    u, v = dir_to_uv(d, rotation)
    xi = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    lum = jnp.take(env.luminance.reshape(-1), yi * w + xi)
    p_texel = lum / jnp.maximum(env.total_luminance, _EPS)
    sin_t = jnp.maximum(jnp.sin(v * jnp.pi), _EPS)
    return p_texel * (w * h) / (2.0 * jnp.pi * jnp.pi * sin_t)


def env_eval(env, d: jnp.ndarray, rotation, intensity):
    """Fused miss-path evaluation: emitted radiance AND the MIS pdf
    from ONE direction->equirect transform (the atan2/acos pair is the
    dominant per-miss VPU cost; results are bit-identical to calling
    env_radiance and env_pdf separately). With the quad table the whole
    evaluation is a SINGLE row take: the nearest texel is always one of
    the four bilinear corners, selected by index comparison (the
    nearest index uses clip while the bilinear x wraps, so fractional
    thresholds alone would mispick at the seam)."""
    h, w = env.height, env.width
    u, v = dir_to_uv(d, rotation)
    xi = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    if env.quad is not None:
        c00, c01, c10, c11, x0i, y0i, fx, fy = _quad_fetch(env, u, v)
        radiance = _quad_bilinear(
            c00[:, :3], c01[:, :3], c10[:, :3], c11[:, :3], fx, fy
        ) * intensity
        from_x1 = xi != x0i
        from_y1 = yi != y0i
        lum = jnp.where(
            from_y1,
            jnp.where(from_x1, c11[:, 3], c10[:, 3]),
            jnp.where(from_x1, c01[:, 3], c00[:, 3]),
        )
    else:
        radiance = _bilinear(env.image, u, v) * intensity
        lum = jnp.take(env.luminance.reshape(-1), yi * w + xi)
    p_texel = lum / jnp.maximum(env.total_luminance, _EPS)
    sin_t = jnp.maximum(jnp.sin(v * jnp.pi), _EPS)
    pdf = p_texel * (w * h) / (2.0 * jnp.pi * jnp.pi * sin_t)
    return radiance, pdf


def env_sample(env, rnd: jnp.ndarray, rotation, intensity):
    """Importance-sample the envmap with the 2-fetch inverted CDF tables.

    rnd: (N, 2) uniforms. Returns (wi (N,3), radiance (N,3), pdf (N,)).
    Mirrors the shader-side lookup the reference precomputes for
    (envmap.rs:311-331): v' = marginal[floor(u1*H)],
    u' = conditional[v'][floor(u2*W)].
    """
    h, w = env.height, env.width
    vi = jnp.clip((rnd[:, 0] * h).astype(jnp.int32), 0, h - 1)
    ui = jnp.clip((rnd[:, 1] * w).astype(jnp.int32), 0, w - 1)
    if env.sstab is not None:
        # Fused table: the marginal->conditional->stab chain is a
        # precomputed texel permutation (EnvMap.sstab), so the whole
        # sample is ONE row take instead of three dependent ones.
        row = jnp.take(env.sstab.reshape(h * w, 8), vi * w + ui, axis=0)
        delta = rotation * TWO_PI
        c, s = jnp.cos(delta), jnp.sin(delta)
        x0, y0, z0 = row[:, 4], row[:, 5], row[:, 6]
        wi = jnp.stack([x0 * c + z0 * s, y0, z0 * c - x0 * s], axis=-1)
        radiance = row[:, :3] * intensity
        p_texel = row[:, 3] / jnp.maximum(env.total_luminance, _EPS)
        pdf = p_texel * (w * h) / (2.0 * jnp.pi * jnp.pi * row[:, 7])
        return wi, radiance, pdf

    v = jnp.take(env.marginal, vi)  # quantized to texel grid
    vrow = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    u = jnp.take(env.conditional.reshape(-1), vrow * w + ui)

    xi = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    flat_idx = yi * w + xi
    if env.stab is not None:
        # The CDF tables only emit texel-grid (u, v), so direction and
        # sin(theta) are per-texel constants (EnvMap.stab): ONE 8-wide
        # row take, zero per-element transcendentals. env_rotation is a
        # pure Y-rotation applied as a scalar 2x2 rotation of dir0.xz.
        row = jnp.take(env.stab.reshape(h * w, 8), flat_idx, axis=0)
        delta = rotation * TWO_PI
        c, s = jnp.cos(delta), jnp.sin(delta)
        x0, y0, z0 = row[:, 4], row[:, 5], row[:, 6]
        wi = jnp.stack([x0 * c + z0 * s, y0, z0 * c - x0 * s], axis=-1)
        radiance = row[:, :3] * intensity
        p_texel = row[:, 3] / jnp.maximum(env.total_luminance, _EPS)
        pdf = p_texel * (w * h) / (2.0 * jnp.pi * jnp.pi * row[:, 7])
        return wi, radiance, pdf

    wi = uv_to_dir(u, v, rotation)
    if env.quad is not None:
        # texel rgb+lum ride lanes 0-3 of the sampled cell's quad row
        # (one row take instead of two)
        texel = jnp.take(env.quad.reshape(h * w, 16), flat_idx, axis=0)
        radiance = texel[:, :3] * intensity
        lum = texel[:, 3]
    else:
        radiance = (
            jnp.take(env.image.reshape(h * w, 3), flat_idx, axis=0)
            * intensity
        )
        lum = jnp.take(env.luminance.reshape(-1), flat_idx)
    p_texel = lum / jnp.maximum(env.total_luminance, _EPS)
    sin_t = jnp.maximum(jnp.sin(v * jnp.pi), _EPS)
    pdf = p_texel * (w * h) / (2.0 * jnp.pi * jnp.pi * sin_t)
    return wi, radiance, pdf
