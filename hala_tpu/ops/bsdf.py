"""BSDF evaluation and sampling: Oren-Nayar diffuse + Disney BSDF.

Role parity: the reference dispatches material evaluation to callable
SPIR-V shaders (rt_renderer.rs:151-173 CALLABLE stage flags); the
material parameter set and its precompute are defined by
cpu/material.rs:24-80 and gpu/material.rs:53-69:

* DIFFUSE (type 0): Oren-Nayar with A, B precomputed into (ax, ay) from
  sigma = roughness * pi/4;
* DISNEY (type 1): full Burley parameter set with anisotropic GGX alphas
  ax/ay precomputed from alpha = roughness^2.

Everything runs in the local shading frame (z = shading normal), SoA
over N rays, fully branch-free (lobe selection via weighted one-sample
MIS). The Disney model follows the 2012/2015 Burley papers: Burley
diffuse with subsurface mix and sheen, anisotropic GGX specular with
VNDF sampling, GTR1 clearcoat, and rough dielectric transmission.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .sampling import (
    INV_PI,
    TWO_PI,
    cosine_sample_hemisphere,
    fresnel_dielectric,
    fresnel_schlick,
    ggx_d,
    ggx_g1,
    ggx_g2,
    gtr1_d,
    normalize,
    sample_ggx_vndf,
    sample_gtr1,
)

_EPS = 1e-6


class MatParams(NamedTuple):
    """Per-ray gathered material parameters (columns of DeviceMaterials)."""

    base_color: jnp.ndarray       # (N, 3)
    emission: jnp.ndarray         # (N, 3)
    opacity: jnp.ndarray          # (N,)
    metallic: jnp.ndarray
    roughness: jnp.ndarray        # post-precompute value
    subsurface: jnp.ndarray
    specular_tint: jnp.ndarray
    sheen: jnp.ndarray
    sheen_tint: jnp.ndarray
    clearcoat: jnp.ndarray
    clearcoat_roughness: jnp.ndarray
    clearcoat_tint: jnp.ndarray   # (N, 3)
    specular_transmission: jnp.ndarray
    ior: jnp.ndarray
    ax: jnp.ndarray
    ay: jnp.ndarray
    mat_type: jnp.ndarray         # (N,) i32
    # Premultiplied absorption coefficient color*density for ABSORB
    # media (zero otherwise) — Beer-Lambert attenuation of interior
    # segments; scatter/emissive media are plumbed but deferred.
    medium_sigma: jnp.ndarray = None      # (N, 3)
    base_color_map: jnp.ndarray = None       # (N,) i32, -1 = none
    metallic_roughness_map: jnp.ndarray = None
    emission_map: jnp.ndarray = None
    normal_map: jnp.ndarray = None


def gather_materials(materials, mat_idx: jnp.ndarray) -> MatParams:
    """Gather material parameters for per-ray material indices.

    Uses the packed (M, 32) table when present — ONE row gather per ray
    instead of 17 scalar gathers."""
    idx = jnp.maximum(mat_idx, 0)
    if materials.packed is not None:
        rows = jnp.take(materials.packed, idx, axis=0)  # (N, 32)
        return MatParams(
            base_color=rows[:, 0:3],
            opacity=rows[:, 3],
            emission=rows[:, 4:7],
            metallic=rows[:, 7],
            roughness=rows[:, 8],
            subsurface=rows[:, 9],
            specular_tint=rows[:, 10],
            sheen=rows[:, 11],
            sheen_tint=rows[:, 12],
            clearcoat=rows[:, 13],
            clearcoat_roughness=rows[:, 14],
            clearcoat_tint=rows[:, 15:18],
            specular_transmission=rows[:, 18],
            ior=rows[:, 19],
            ax=rows[:, 20],
            ay=rows[:, 21],
            mat_type=rows[:, 22].astype(jnp.int32),
            medium_sigma=rows[:, 28:31],
            base_color_map=rows[:, 23].astype(jnp.int32),
            metallic_roughness_map=rows[:, 24].astype(jnp.int32),
            emission_map=rows[:, 25].astype(jnp.int32),
            normal_map=rows[:, 26].astype(jnp.int32),
        )
    g = lambda a: jnp.take(a, idx, axis=0)
    return MatParams(
        base_color=g(materials.base_color),
        emission=g(materials.emission),
        opacity=g(materials.opacity),
        metallic=g(materials.metallic),
        roughness=g(materials.roughness),
        subsurface=g(materials.subsurface),
        specular_tint=g(materials.specular_tint),
        sheen=g(materials.sheen),
        sheen_tint=g(materials.sheen_tint),
        clearcoat=g(materials.clearcoat),
        clearcoat_roughness=g(materials.clearcoat_roughness),
        clearcoat_tint=g(materials.clearcoat_tint),
        specular_transmission=g(materials.specular_transmission),
        ior=g(materials.ior),
        ax=g(materials.ax),
        ay=g(materials.ay),
        mat_type=g(materials.mat_type),
        medium_sigma=g(materials.medium_color)
        * g(materials.medium_density)[:, None]
        * (g(materials.medium_type) == 1)[:, None],
        base_color_map=g(materials.base_color_map),
        metallic_roughness_map=g(materials.metallic_roughness_map),
        emission_map=g(materials.emission_map),
        normal_map=g(materials.normal_map),
    )


# ---------------------------------------------------------------------------
# Oren-Nayar (DIFFUSE material type)
# ---------------------------------------------------------------------------


def oren_nayar_eval(mp: MatParams, wo, wi):
    """f and pdf for the DIFFUSE type. A = mp.ax, B = mp.ay
    (gpu/material.rs:53-60 packing)."""
    cos_o, cos_i = jnp.abs(wo[..., 2]), jnp.abs(wi[..., 2])
    sin_o = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_o * cos_o))
    sin_i = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_i * cos_i))
    # cos(phi_i - phi_o) from tangent-plane projections.
    denom = jnp.maximum(sin_o * sin_i, _EPS)
    cos_dphi = jnp.clip(
        (wo[..., 0] * wi[..., 0] + wo[..., 1] * wi[..., 1]) / denom, -1.0, 1.0
    )
    sin_alpha = jnp.maximum(sin_o, sin_i)
    tan_beta = jnp.minimum(sin_o, sin_i) / jnp.maximum(
        jnp.minimum(cos_o, cos_i), _EPS
    )
    f_scalar = INV_PI * (
        mp.ax + mp.ay * jnp.maximum(0.0, cos_dphi) * sin_alpha * tan_beta
    )
    f = mp.base_color * f_scalar[..., None]
    pdf = cos_i * INV_PI
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return jnp.where(valid[..., None], f, 0.0), jnp.where(valid, pdf, 0.0)


# ---------------------------------------------------------------------------
# Disney BSDF
# ---------------------------------------------------------------------------


def _tint_color(base_color):
    lum = jnp.sum(
        base_color * jnp.asarray([0.212671, 0.715160, 0.072169]), axis=-1,
        keepdims=True,
    )
    return jnp.where(lum > 0.0, base_color / jnp.maximum(lum, _EPS), 1.0)


def _disney_lobe_weights(mp: MatParams):
    """Sampling probabilities for {diffuse, specular, clearcoat, trans}."""
    metallic = mp.metallic
    trans = (1.0 - metallic) * mp.specular_transmission
    w_diffuse = (1.0 - metallic) * (1.0 - mp.specular_transmission)
    w_spec = 1.0
    w_clear = 0.25 * mp.clearcoat
    w_trans = trans
    total = w_diffuse + w_spec + w_clear + w_trans
    return (
        w_diffuse / total,
        w_spec / total,
        w_clear / total,
        w_trans / total,
    )


def _spec_f0(mp: MatParams):
    f0_scalar = ((mp.ior - 1.0) / (mp.ior + 1.0)) ** 2
    tint = _tint_color(mp.base_color)
    dielectric = f0_scalar[..., None] * (
        (1.0 - mp.specular_tint[..., None]) + mp.specular_tint[..., None] * tint
    )
    return (
        (1.0 - mp.metallic[..., None]) * dielectric
        + mp.metallic[..., None] * mp.base_color
    )


def _clearcoat_alpha(mp: MatParams):
    return jnp.clip(0.001 + mp.clearcoat_roughness * 0.099, 0.001, 0.1)


def _disney_diffuse_eval(mp: MatParams, wo, wi):
    """Burley diffuse + subsurface mix + sheen. Reflection side only."""
    cos_o, cos_i = jnp.abs(wo[..., 2]), jnp.abs(wi[..., 2])
    h = normalize(wo + wi)
    cos_d = jnp.abs(jnp.sum(wi * h, axis=-1))
    fl = (1.0 - cos_i) ** 5
    fv = (1.0 - cos_o) ** 5
    # raw Burley roughness ~ sqrt(alpha); mp.roughness is alpha here.
    rough = jnp.sqrt(jnp.clip(mp.roughness, 1e-4, 1.0))
    fd90 = 0.5 + 2.0 * rough * cos_d * cos_d
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    # Hanrahan-Krueger-inspired subsurface term (Burley 2012 course notes).
    fss90 = rough * cos_d * cos_d
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    ss = 1.25 * (
        fss * (1.0 / jnp.maximum(cos_i + cos_o, _EPS) - 0.5) + 0.5
    )
    diffuse_scalar = INV_PI * (
        (1.0 - mp.subsurface) * fd + mp.subsurface * ss
    )
    sheen_color = (
        (1.0 - mp.sheen_tint[..., None])
        + mp.sheen_tint[..., None] * _tint_color(mp.base_color)
    )
    fh = (1.0 - cos_d) ** 5
    sheen = mp.sheen[..., None] * sheen_color * fh[..., None]
    weight = (1.0 - mp.metallic) * (1.0 - mp.specular_transmission)
    f = (mp.base_color * diffuse_scalar[..., None] + sheen) * weight[..., None]
    pdf = cos_i * INV_PI
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return jnp.where(valid[..., None], f, 0.0), jnp.where(valid, pdf, 0.0)


def _disney_specular_eval(mp: MatParams, wo, wi):
    """Anisotropic GGX reflection with VNDF pdf."""
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    h = normalize(wo + wi)
    d = ggx_d(h, mp.ax, mp.ay)
    g2 = ggx_g2(wo, wi, mp.ax, mp.ay)
    g1 = ggx_g1(wo, mp.ax, mp.ay)
    cos_d = jnp.abs(jnp.sum(wo * h, axis=-1))
    f0 = _spec_f0(mp)
    fr = fresnel_schlick(f0, cos_d[..., None])
    cos_o = jnp.maximum(jnp.abs(wo[..., 2]), _EPS)
    cos_i = jnp.maximum(jnp.abs(wi[..., 2]), _EPS)
    f = fr * (d * g2 / (4.0 * cos_o * cos_i))[..., None]
    pdf = d * g1 * cos_d / jnp.maximum(4.0 * cos_o * cos_d, _EPS)
    # VNDF pdf: D * G1 * max(0, wo.h) / cos_o / (4 wo.h) = D*G1/(4 cos_o)
    pdf = d * g1 / jnp.maximum(4.0 * cos_o, _EPS)
    return jnp.where(valid[..., None], f, 0.0), jnp.where(valid, pdf, 0.0)


def _disney_clearcoat_eval(mp: MatParams, wo, wi):
    valid = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    h = normalize(wo + wi)
    a = _clearcoat_alpha(mp)
    d = gtr1_d(h[..., 2], a)
    cos_d = jnp.abs(jnp.sum(wo * h, axis=-1))
    fr = 0.04 + 0.96 * (1.0 - cos_d) ** 5
    # Fixed-alpha (0.25) separable Smith G as in Burley's course notes.
    g = ggx_g2(wo, wi, jnp.full_like(a, 0.25), jnp.full_like(a, 0.25))
    cos_o = jnp.maximum(jnp.abs(wo[..., 2]), _EPS)
    cos_i = jnp.maximum(jnp.abs(wi[..., 2]), _EPS)
    scalar = 0.25 * mp.clearcoat * fr * d * g / (4.0 * cos_o * cos_i)
    f = mp.clearcoat_tint * scalar[..., None]
    pdf = d * jnp.abs(h[..., 2]) / jnp.maximum(4.0 * cos_d, _EPS)
    return jnp.where(valid[..., None], f, 0.0), jnp.where(valid, pdf, 0.0)


def _refract(wi, h, eta):
    """Refract wi about h with relative ior eta (eta_i/eta_t)."""
    cos_i = jnp.sum(wi * h, axis=-1)
    sin2_t = eta * eta * jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))
    wt = -wi * eta[..., None] + (eta * cos_i - cos_t)[..., None] * h
    return normalize(wt), sin2_t < 1.0


def _disney_transmission_eval(mp: MatParams, wo, wi):
    """Rough dielectric (reflection + transmission), Walter 2007 microfacet
    refraction with GGX. wo is always in the upper hemisphere of the
    shading frame by convention (the integrator flips the frame)."""
    eta = jnp.where(wo[..., 2] > 0, 1.0 / mp.ior, mp.ior)  # eta_i/eta_t
    reflect = wi[..., 2] * wo[..., 2] > 0
    # Half vector: reflection vs refraction.
    h_refl = normalize(wo + wi)
    h_refr = normalize(wo + wi / jnp.maximum(eta, _EPS)[..., None])
    h = jnp.where(reflect[..., None], h_refl, h_refr)
    h = jnp.where((h[..., 2] < 0)[..., None], -h, h)

    cos_oh = jnp.sum(wo * h, axis=-1)
    fr = fresnel_dielectric(jnp.abs(cos_oh), 1.0 / jnp.maximum(eta, _EPS))
    d = ggx_d(h, mp.ax, mp.ay)
    g2 = ggx_g2(wo, wi, mp.ax, mp.ay)
    g1 = ggx_g1(wo, mp.ax, mp.ay)
    cos_o = jnp.maximum(jnp.abs(wo[..., 2]), _EPS)
    cos_i = jnp.maximum(jnp.abs(wi[..., 2]), _EPS)

    # Reflection part
    f_refl = fr * d * g2 / (4.0 * cos_o * cos_i)
    pdf_refl = fr * d * g1 / jnp.maximum(4.0 * cos_o, _EPS)

    # Transmission part (Walter et al. eq. 21, with radiance scaling eta^2)
    cos_ih = jnp.sum(wi * h, axis=-1)
    denom = jnp.maximum((cos_oh + cos_ih / jnp.maximum(eta, _EPS)) ** 2, _EPS)
    jac = jnp.abs(cos_ih) / denom / jnp.maximum(eta, _EPS) ** 2
    f_trans = (
        (1.0 - fr) * d * g2 * jnp.abs(cos_oh) * jac / (cos_o * cos_i)
    )
    pdf_trans = (1.0 - fr) * d * g1 * jnp.abs(cos_oh) / cos_o * jac

    weight = (1.0 - mp.metallic) * mp.specular_transmission
    color = jnp.sqrt(jnp.clip(mp.base_color, 0.0, 1.0))  # Burley: sqrt tint
    scalar = jnp.where(reflect, f_refl, f_trans)
    f = color * (scalar * weight)[..., None]
    pdf = jnp.where(reflect, pdf_refl, pdf_trans)
    return f, jnp.maximum(pdf, 0.0)


def disney_eval(mp: MatParams, wo, wi, with_transmission: bool = True):
    """Combined Disney f and one-sample-MIS pdf for given wo, wi (local).

    `with_transmission=False` statically compiles out the dielectric
    transmission lobe (scene capability specialization — the reference's
    shader-permutation analog, cpu/scene.rs has_transparent probe)."""
    w_d, w_s, w_c, w_t = _disney_lobe_weights(mp)
    f_d, p_d = _disney_diffuse_eval(mp, wo, wi)
    f_s, p_s = _disney_specular_eval(mp, wo, wi)
    f_c, p_c = _disney_clearcoat_eval(mp, wo, wi)
    f = f_d + f_s + f_c
    pdf = w_d * p_d + w_s * p_s + w_c * p_c
    if with_transmission:
        f_t, p_t = _disney_transmission_eval(mp, wo, wi)
        has_trans = mp.specular_transmission > 0.0
        f = f + jnp.where(has_trans[..., None], f_t, 0.0)
        pdf = pdf + jnp.where(has_trans, w_t * p_t, 0.0)
    return f, pdf


def bsdf_eval(
    mp: MatParams, wo, wi,
    with_disney: bool = True, with_transmission: bool = True,
):
    """Dispatch on material type (0 DIFFUSE / 1 DISNEY). The with_*
    flags statically drop model families no material in the scene uses."""
    f_on, p_on = oren_nayar_eval(mp, wo, wi)
    if not with_disney:
        return f_on, p_on
    f_di, p_di = disney_eval(mp, wo, wi, with_transmission)
    is_disney = (mp.mat_type == 1)
    return (
        jnp.where(is_disney[..., None], f_di, f_on),
        jnp.where(is_disney, p_di, p_on),
    )


def bsdf_sample(
    mp: MatParams, wo, rnd,
    with_disney: bool = True, with_transmission: bool = True,
):
    """Sample wi in the local frame. rnd: (N, 4) uniforms.

    Returns (wi, f, pdf). f/pdf are the full one-sample-MIS combination,
    so throughput update is f * |cos| / pdf.
    """
    if not with_disney:
        wi = cosine_sample_hemisphere(rnd[..., 1], rnd[..., 2])
        f, pdf = oren_nayar_eval(mp, wo, wi)
        return wi, f, pdf
    w_d, w_s, w_c, w_t = _disney_lobe_weights(mp)
    u_lobe = rnd[..., 0]
    u1, u2 = rnd[..., 1], rnd[..., 2]

    # Candidate directions from each lobe.
    wi_diffuse = cosine_sample_hemisphere(u1, u2)

    h_spec = sample_ggx_vndf(wo, mp.ax, mp.ay, u1, u2)
    wi_spec = normalize(
        2.0 * jnp.sum(wo * h_spec, axis=-1, keepdims=True) * h_spec - wo
    )

    h_clear = sample_gtr1(_clearcoat_alpha(mp), u1, u2)
    wi_clear = normalize(
        2.0 * jnp.sum(wo * h_clear, axis=-1, keepdims=True) * h_clear - wo
    )

    # Transmission lobe: reflect or refract by exact Fresnel.
    if with_transmission:
        eta = jnp.where(wo[..., 2] > 0, 1.0 / mp.ior, mp.ior)
        h_t = sample_ggx_vndf(wo, mp.ax, mp.ay, u1, u2)
        cos_oh = jnp.sum(wo * h_t, axis=-1)
        fr_t = fresnel_dielectric(
            jnp.abs(cos_oh), 1.0 / jnp.maximum(eta, _EPS)
        )
        wt, can_refract = _refract(wo, h_t, eta)
        wi_t_refl = normalize(2.0 * cos_oh[..., None] * h_t - wo)
        choose_refl = (rnd[..., 3] < fr_t) | ~can_refract
        wi_trans = jnp.where(choose_refl[..., None], wi_t_refl, wt)
    else:
        wi_trans = wi_spec

    # Lobe selection by cumulative weights.
    c1 = w_d
    c2 = c1 + w_s
    c3 = c2 + w_c
    sel_d = u_lobe < c1
    sel_s = (u_lobe >= c1) & (u_lobe < c2)
    sel_c = (u_lobe >= c2) & (u_lobe < c3)
    sel_t = u_lobe >= c3

    wi_disney = jnp.where(
        sel_d[..., None],
        wi_diffuse,
        jnp.where(
            sel_s[..., None],
            wi_spec,
            jnp.where(sel_c[..., None], wi_clear, wi_trans),
        ),
    )

    # DIFFUSE type always cosine-samples.
    is_disney = mp.mat_type == 1
    wi = jnp.where(is_disney[..., None], wi_disney, wi_diffuse)
    f, pdf = bsdf_eval(mp, wo, wi, True, with_transmission)
    return wi, f, pdf
