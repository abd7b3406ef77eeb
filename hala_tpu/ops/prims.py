"""Procedural (non-triangle) primitives: analytic spheres.

Role parity: the reference traces custom primitives through AABB
geometries + intersection shaders (procedural BLAS,
/root/reference/src/scene/loader/gpu_uploader.rs:818-840) dispatched
via the PROCEDURAL hit-group class
(src/rt_renderer.rs:1016-1112 of the reference). Here there is no SBT:
procedural primitives are a small SoA table intersected analytically in
the same dispatch as the triangle query, and the closest-hit merge
encodes them as `tri >= PROC_BASE` so the Hit plumbing (state carries,
staged dispatch, shard merge) is unchanged. The sphere is the first
shape (the reference's own in-repo procedural use is the sphere-light
BLAS); the `rt.intersection` kernel hook remains the user seam for
custom shapes.

Merged hits shade through the standard material system: `Hit.u/v`
carry the spherical parameterization, so textures, Disney params and
media all apply (models/integrator.py overrides the triangle-derived
attributes where `tri >= PROC_BASE`).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from .intersect import Hit, T_MAX

# Procedural ids live above every triangle slot id (global sharded ids
# included: slot counts stay far below 2^24; the raster sort key packs
# ids in 20 bits, and sharded global ids add shard*slots < 2^24).
PROC_BASE = 1 << 24

# Self-intersection epsilon along the ray (the triangle kernels' ray
# epsilon is applied by the caller via shadow_o offsets; spheres need a
# local one because the origin can sit exactly on the surface after a
# bounce off the sphere itself).
_T_EPS = 1e-4


def _register(cls, meta_fields=()):
    data_fields = tuple(
        f.name for f in dataclasses.fields(cls) if f.name not in meta_fields
    )
    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=tuple(meta_fields)
    )
    return cls


@partial(_register, meta_fields=("num_prims",))
@dataclasses.dataclass
class DeviceProcedural:
    """SoA sphere table + the packed row the shading fetch gathers."""

    center: jax.Array   # (P, 3) f32
    radius: jax.Array   # (P,) f32
    mat: jax.Array      # (P,) i32 — material index
    # (P, 8) f32 [cx cy cz r mat 0 0 0] — ONE row take per shading
    # point (the per-row take law, DESIGN.md round-5).
    packed: jax.Array = None
    num_prims: int = 0


def _sphere_roots(proc: DeviceProcedural, o, d):
    """(t, ok) per (ray, sphere): nearest positive root of the sphere
    quadratic, masked to t > eps."""
    oc = o[:, None, :] - proc.center[None, :, :]          # (N, P, 3)
    b = jnp.sum(oc * d[:, None, :], axis=-1)              # (N, P)
    cq = jnp.sum(oc * oc, axis=-1) - (proc.radius * proc.radius)[None, :]
    disc = b * b - cq
    ok = disc > 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = jnp.where(t0 > _T_EPS, t0, t1)
    ok = ok & (t > _T_EPS)
    return t, ok


def intersect_spheres(proc: DeviceProcedural, o, d, t_max=None) -> Hit:
    """Closest sphere hit per ray. Returns Hit with tri = PROC_BASE +
    sphere index (or -1), t = +inf on miss, and u/v = the spherical
    parameterization (u from atan2 around +Y, v from latitude) — the
    direct analog of a sphere intersection shader writing hit
    attributes."""
    n = o.shape[0]
    t, ok = _sphere_roots(proc, o, d)
    if t_max is not None:
        tm = jnp.broadcast_to(t_max, (n,)).astype(jnp.float32)
        ok = ok & (t < tm[:, None])
    t_m = jnp.where(ok, t, T_MAX)
    best = jnp.argmin(t_m, axis=1)                         # first min: ties
    t_b = jnp.take_along_axis(t_m, best[:, None], axis=1)[:, 0]
    hit_any = t_b < T_MAX
    c_b = jnp.take(proc.center, best, axis=0)
    r_b = jnp.take(proc.radius, best)
    p = o + t_b[:, None] * d
    nrm = (p - c_b) / jnp.maximum(r_b, 1e-12)[:, None]
    u = 0.5 + jnp.arctan2(nrm[:, 2], nrm[:, 0]) / (2.0 * jnp.pi)
    v = 0.5 - jnp.arcsin(jnp.clip(nrm[:, 1], -1.0, 1.0)) / jnp.pi
    tri = jnp.where(
        hit_any, jnp.int32(PROC_BASE) + best.astype(jnp.int32), -1
    )
    return Hit(
        t=t_b,  # T_MAX on miss (the triangle backends' convention)
        tri=tri,
        u=jnp.where(hit_any, u, 0.0),
        v=jnp.where(hit_any, v, 0.0),
    )


def occluded_spheres(proc: DeviceProcedural, o, d, t_far) -> jnp.ndarray:
    """(N,) bool any-hit within (eps, t_far) — the shadow-class query."""
    n = o.shape[0]
    t, ok = _sphere_roots(proc, o, d)
    tf = jnp.broadcast_to(t_far, (n,)).astype(jnp.float32)
    return jnp.any(ok & (t < tf[:, None]), axis=1)


def merge_procedural(proc: DeviceProcedural, o, d, hit: Hit, t_max=None) -> Hit:
    """Fold the closest sphere hit into a triangle Hit (the PROCEDURAL
    vs TRIANGLES hit-group merge). Both sides use t = T_MAX with
    tri = -1 on miss, so comparing t directly is safe; ties (t exactly
    equal) keep the triangle, matching the reference's commit order
    (triangles at SBT offset 0)."""
    ph = intersect_spheres(proc, o, d, t_max)
    closer = (ph.t < hit.t) & (ph.tri >= 0)
    return Hit(
        t=jnp.where(closer, ph.t, hit.t),
        tri=jnp.where(closer, ph.tri, hit.tri),
        u=jnp.where(closer, ph.u, hit.u),
        v=jnp.where(closer, ph.v, hit.v),
    )
