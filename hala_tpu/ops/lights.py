"""Analytic light sampling (NEE) and emission lookup for BSDF rays.

Role parity: the reference's light list + NEE shaders, consuming the
gpu::HalaLight record {intensity = color*watt, position, u, v, radius,
area, type} (gpu/light.rs:8-32, constructed at gpu_uploader.rs:157-274):

* POINT (0): position; delta light, L = I / d^2.
* DIRECTIONAL (1): u = direction light travels (-Z axis of the node),
  v.x = cos(half cone angle); sampled within the cone.
* SPOT (2): position, u = direction, v = (cos inner, cos outer);
  smooth falloff between the cones, L = I * falloff / d^2.
* QUAD (3): position = corner, u/v = edge vectors * lengths,
  area = w*h; single-sided (emits along cross(u, v)); record intensity
  is treated as emitted radiance (the loader's `intensity /= 0.5*w*h`
  fixup, gltf_loader.rs:474-478, makes it area-normalized).
* SPHERE (4): position/radius/area = 4 pi r^2; sampled by visible solid
  angle cone; record intensity is emitted radiance.

The reference makes emissive lights visible to secondary rays via a
procedural-AABB light BLAS at SBT record offset 1
(gpu_uploader.rs:818-840, 877-885); `intersect_lights` is the analytic
equivalent, returning emitted radiance and the matching NEE pdf so BSDF
rays can be MIS-weighted.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .intersect import T_MAX, ray_quad, ray_sphere
from .sampling import (
    build_basis,
    dot,
    normalize,
    to_world,
    uniform_sample_cone,
)

_EPS = 1e-6
_DELTA_DIST = jnp.float32(1.0e7)  # "infinite" distance for directional


class LightSample(NamedTuple):
    wi: jnp.ndarray        # (N, 3) direction to light (unit)
    dist: jnp.ndarray      # (N,) distance for the shadow ray
    radiance: jnp.ndarray  # (N, 3) incident radiance (delta lights: I/d^2)
    pdf: jnp.ndarray       # (N,) solid-angle pdf (delta lights: 1)
    is_delta: jnp.ndarray  # (N,) bool — exclude from MIS


def sample_one_light(lights, p: jnp.ndarray, rnd: jnp.ndarray) -> LightSample:
    """Uniformly pick one light and sample it. rnd: (N, 3).

    Returns a LightSample whose pdf already includes the 1/num_lights
    selection probability. num_lights == 0 yields a zero sample.
    """
    n = p.shape[0]
    nl = lights.num_lights
    if nl == 0:
        zero3 = jnp.zeros((n, 3))
        return LightSample(
            wi=zero3.at[:, 2].set(1.0),
            dist=jnp.ones((n,)),
            radiance=zero3,
            pdf=jnp.zeros((n,)),
            is_delta=jnp.ones((n,), bool),
        )
    li = jnp.minimum((rnd[:, 0] * nl).astype(jnp.int32), nl - 1)
    # Gather from the first nl rows only (num_lights is static; the table
    # is padded to MAX_LIGHT_COUNT and padded slots must not cost work).
    g = lambda a: jnp.take(a[:nl], li, axis=0)
    I = g(lights.intensity)
    pos = g(lights.position)
    u = g(lights.u)
    v = g(lights.v)
    radius = g(lights.radius)
    area = g(lights.area)
    lt = g(lights.ltype)
    u1, u2 = rnd[:, 1], rnd[:, 2]

    # --- POINT / SPOT: direction to position -----------------------------
    to_l = pos - p
    d2 = jnp.maximum(jnp.sum(to_l * to_l, axis=-1), _EPS)
    dist_p = jnp.sqrt(d2)
    wi_p = to_l / dist_p[:, None]
    rad_point = I / d2[:, None]
    # spot falloff: angle between emit direction u and -wi
    cos_s = dot(u, -wi_p)
    cos_inner, cos_outer = v[:, 0], v[:, 1]
    t = jnp.clip(
        (cos_s - cos_outer) / jnp.maximum(cos_inner - cos_outer, _EPS), 0.0, 1.0
    )
    falloff = t * t * (3.0 - 2.0 * t)
    rad_spot = rad_point * falloff[:, None]

    # --- DIRECTIONAL: sample cone around -u ------------------------------
    cos_max_dir = jnp.clip(v[:, 0], -1.0, 1.0)
    axis_dir = normalize(-u)
    t_b, b_b = build_basis(axis_dir)
    local_dir = uniform_sample_cone(u1, u2, cos_max_dir)
    wi_dir = to_world(local_dir, t_b, b_b, axis_dir)
    rad_dir = I  # radiance along the beam

    # --- QUAD: uniform area sample ---------------------------------------
    sample_q = pos + u * u1[:, None] + v * u2[:, None]
    n_q = normalize(jnp.cross(u, v))
    to_q = sample_q - p
    d2_q = jnp.maximum(jnp.sum(to_q * to_q, axis=-1), _EPS)
    dist_q = jnp.sqrt(d2_q)
    wi_q = to_q / dist_q[:, None]
    cos_l = dot(n_q, -wi_q)  # light-side cosine; single-sided
    pdf_q = d2_q / jnp.maximum(area * jnp.maximum(cos_l, 0.0), _EPS)
    rad_q = jnp.where((cos_l > 0)[:, None], I, 0.0)

    # --- SPHERE: visible-cone sample -------------------------------------
    to_c = pos - p
    dc2 = jnp.maximum(jnp.sum(to_c * to_c, axis=-1), _EPS)
    dc = jnp.sqrt(dc2)
    sin2_max = jnp.clip(radius * radius / dc2, 0.0, 1.0)
    cos_max_s = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_max))
    axis_s = to_c / dc[:, None]
    t_s, b_s = build_basis(axis_s)
    local_s = uniform_sample_cone(u1, u2, cos_max_s)
    wi_s = to_world(local_s, t_s, b_s, axis_s)
    pdf_s = 1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - cos_max_s), _EPS)
    # distance to sphere surface along wi_s
    b_q = dot(wi_s, -to_c)
    disc = jnp.maximum(b_q * b_q - (dc2 - radius * radius), 0.0)
    dist_s = jnp.maximum(-b_q - jnp.sqrt(disc), _EPS)
    rad_s = I

    is_point = lt == 0
    is_dir = lt == 1
    is_spot = lt == 2
    is_quad = lt == 3
    is_sphere = lt == 4

    def sel(*vals):
        out = jnp.zeros_like(vals[0])
        for mask, val in zip((is_point, is_dir, is_spot, is_quad, is_sphere), vals):
            m = mask[..., None] if val.ndim > 1 else mask
            out = jnp.where(m, val, out)
        return out

    wi = sel(wi_p, wi_dir, wi_p, wi_q, wi_s)
    dist = sel(
        dist_p, jnp.full_like(dist_p, _DELTA_DIST), dist_p, dist_q, dist_s
    )
    radiance = sel(rad_point, rad_dir, rad_spot, rad_q, rad_s)
    pdf_cone_dir = 1.0 / jnp.maximum(
        2.0 * jnp.pi * (1.0 - cos_max_dir), _EPS
    )
    ones = jnp.ones_like(dist_p)
    pdf = sel(
        ones,
        jnp.where(cos_max_dir >= 1.0 - 1e-7, ones, pdf_cone_dir),
        ones,
        pdf_q,
        pdf_s,
    )
    is_delta = is_point | is_spot | (is_dir & (cos_max_dir >= 1.0 - 1e-7))

    inv_sel = jnp.float32(1.0 / nl)
    # Fold selection pdf into radiance for delta lights, into pdf otherwise
    # (keeps `radiance/pdf * inv?` single formula: contribution = radiance / pdf
    # with pdf including selection for area lights; delta contribution
    # = radiance * nl).
    pdf = pdf * inv_sel
    return LightSample(wi=wi, dist=dist, radiance=radiance, pdf=pdf, is_delta=is_delta)


class LightHit(NamedTuple):
    t: jnp.ndarray         # (N,) distance, T_MAX if none
    radiance: jnp.ndarray  # (N, 3)
    pdf: jnp.ndarray       # (N,) NEE solid-angle pdf at this hit (incl. selection)


def intersect_lights(lights, o: jnp.ndarray, d: jnp.ndarray) -> LightHit:
    """Closest emissive-light hit along (o, d) for quad/sphere lights."""
    n = o.shape[0]
    nl = lights.num_lights
    if nl == 0:
        return LightHit(
            t=jnp.full((n,), T_MAX),
            radiance=jnp.zeros((n, 3)),
            pdf=jnp.zeros((n,)),
        )
    # Static slice to the real light count: the table is padded to
    # MAX_LIGHT_COUNT and testing padded slots costs real VPU time.
    lt = lights.ltype[:nl]  # (L,)
    lpos = lights.position[:nl]
    lu = lights.u[:nl]
    lv = lights.v[:nl]
    lradius = lights.radius[:nl]
    # Quad hits: only through the emitting face (cos > 0 toward ray origin)
    t_quad = ray_quad(o, d, lpos, lu, lv)
    n_q = normalize(jnp.cross(lu, lv))  # (L,3)
    facing = -jnp.einsum(
        "nk,lk->nl", d, n_q, precision=jax.lax.Precision.HIGHEST
    ) > 0.0
    t_quad = jnp.where((lt == 3)[None, :] & facing, t_quad, T_MAX)

    t_sph = ray_sphere(o, d, lpos, lradius)
    t_sph = jnp.where((lt == 4)[None, :], t_sph, T_MAX)

    t_all = jnp.minimum(t_quad, t_sph)  # (N, L)
    t_best = jnp.min(t_all, axis=1)
    li = jnp.argmin(t_all, axis=1)
    hit = t_best < T_MAX

    g = lambda a: jnp.take(a[:nl], li, axis=0)
    I = g(lights.intensity)
    area = g(lights.area)
    radius = g(lights.radius)
    pos = g(lights.position)
    ltype_h = g(lights.ltype)

    # NEE pdf at this hit, for MIS (matches sample_one_light conventions).
    hit_p = o + t_best[:, None] * d
    # quad: d^2 / (area * cos)
    nq_h = g(n_q)
    cos_l = jnp.abs(dot(nq_h, d))
    pdf_quad = (t_best * t_best) / jnp.maximum(area * jnp.maximum(cos_l, _EPS), _EPS)
    # sphere: visible-cone pdf from the ray origin
    to_c = pos - o
    dc2 = jnp.maximum(jnp.sum(to_c * to_c, axis=-1), _EPS)
    sin2_max = jnp.clip(radius * radius / dc2, 0.0, 1.0)
    cos_max = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_max))
    pdf_sph = 1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - cos_max), _EPS)
    pdf = jnp.where(ltype_h == 3, pdf_quad, pdf_sph) / jnp.float32(nl)

    return LightHit(
        t=jnp.where(hit, t_best, T_MAX),
        radiance=jnp.where(hit[:, None], I, 0.0),
        pdf=jnp.where(hit, pdf, 0.0),
    )
