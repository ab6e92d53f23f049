"""Specular chains for the VRL eye path.

Counterpart of the delta-BSDF recursion in vrlIntegrator::LiInternal
(vrlIntegrator.cpp:445-511): at a delta surface (mirror, smooth
dielectric, null boundary), the VRL gather recurses along the specular
continuation with weight *= transmittance * bsdfWeight / rrProb, using
Russian roulette on throughputWithEtaSq (forced stopping probability
0.98 beyond specularForcedRRdepth, initial throughput
`initialSpecularThroughput`).

Array design: the recursion tree is re-shaped into a bounded loop:
  * MIRROR and NULL have one delta lobe — followed deterministically;
  * DIELECTRIC has two lobes (reflect/refract) which the reference
    enumerates as a tree; we sample ONE lobe per step with the Fresnel
    probability (weight 1 by cancellation) — an unbiased estimator of
    the same family that keeps the loop linear (documented deviation).
"""

from __future__ import annotations

from alvrl_tpu.core import struct

import jax
import jax.numpy as jnp

from alvrl_tpu.core import math as m
from alvrl_tpu.core import rng
from alvrl_tpu.media import api as mapi
from alvrl_tpu.scene.scene import DIELECTRIC, MIRROR, NULL, Scene


@struct.dataclass
class SpecularConfig:
    max_depth: int = struct.field(pytree_node=False, default=6)
    forced_rr_depth: int = struct.field(pytree_node=False, default=100)
    initial_throughput: float = struct.field(pytree_node=False, default=20.0)


def fresnel_dielectric(cos_i, eta):
    """Unpolarized Fresnel reflectance for a smooth dielectric with
    relative IOR eta (= int/ext). cos_i >= 0."""
    cos_i = jnp.clip(cos_i, 0.0, 1.0)
    sin_t2 = (1.0 / (eta * eta)) * jnp.maximum(1.0 - cos_i * cos_i, 0.0)
    tir = sin_t2 >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin_t2, 0.0))
    rs = (cos_i - eta * cos_t) / jnp.maximum(cos_i + eta * cos_t, 1e-12)
    rp = (eta * cos_i - cos_t) / jnp.maximum(eta * cos_i + cos_t, 1e-12)
    f = 0.5 * (rs * rs + rp * rp)
    return jnp.where(tir, 1.0, f), cos_t


def specular_bounce(scene: Scene, u, mat_id, d_in, ng_raw):
    """Sample the delta continuation at a surface.

    `u` is the lobe-selection uniform (explicit so primary-sample-space
    integrators can own it). Returns (wo, weight (3,), eta_ratio,
    is_delta). ng_raw is the winding normal (not flipped); d_in the
    incoming ray direction."""
    kind = scene.materials.kind[mat_id]
    tint = scene.materials.albedo[mat_id]
    eta_mat = scene.materials.eta[mat_id]

    entering = m.dot(ng_raw, d_in) < 0
    n = jnp.where(entering[..., None], ng_raw, -ng_raw)
    cos_i = -m.dot(n, d_in)
    eta = jnp.where(entering, eta_mat, 1.0 / jnp.maximum(eta_mat, 1e-6))

    wo_mirror = d_in + 2.0 * cos_i[..., None] * n

    f, cos_t = fresnel_dielectric(cos_i, eta)
    reflect = u < f
    inv_eta = 1.0 / jnp.maximum(eta, 1e-6)
    wo_refract = (
        d_in * inv_eta[..., None]
        + (cos_i * inv_eta - cos_t)[..., None] * n
    )
    # radiance transport: refraction carries the 1/eta^2 radiance
    # compression (dielectric.cpp); sampling by Fresnel cancels F/(1-F).
    w_refract = inv_eta * inv_eta
    wo_diel = jnp.where(reflect[..., None], wo_mirror, wo_refract)
    w_diel = jnp.where(reflect, 1.0, w_refract)[..., None] * jnp.ones((3,))
    eta_diel = jnp.where(reflect, 1.0, 1.0 / jnp.maximum(eta, 1e-6))

    is_mirror = kind == MIRROR
    is_null = kind == NULL
    is_diel = kind == DIELECTRIC
    is_delta = is_mirror | is_null | is_diel

    wo = jnp.where(
        is_null[..., None], d_in,
        jnp.where(is_mirror[..., None], wo_mirror, wo_diel),
    )
    weight = jnp.where(
        is_null[..., None], jnp.ones((3,)),
        jnp.where(is_mirror[..., None], tint, w_diel),
    )
    eta_ratio = jnp.where(is_diel, eta_diel, 1.0)
    return wo, weight, eta_ratio, is_delta


def li_specular_chain(
    scene: Scene,
    ray_o,
    ray_d,
    li_at_hit,  # callable(ray_o, ray_d, hit, key, weight) -> (B, 3)
    trace_eye_rays,  # callable(scene, o, d) -> HitInfo-like
    key,
    spec_cfg: SpecularConfig = SpecularConfig(),
):
    """Accumulate VRL gather contributions along the specular chain.

    Each step: evaluate the gather at the current hit with the running
    `weight`, then continue through a delta lobe with RR on
    throughputWithEtaSq (vrlIntegrator.cpp:480-510)."""
    b = ray_o.shape[0]
    li = jnp.zeros((b, 3), jnp.float32)
    weight = jnp.ones((b, 3), jnp.float32)
    twes = jnp.full((b, 3), spec_cfg.initial_throughput, jnp.float32)
    active = jnp.ones((b,), bool)
    o, d = ray_o, ray_d

    for depth in range(spec_cfg.max_depth + 1):
        k_step = rng.fold(key, depth, rng.P_SPECULAR)
        hit = trace_eye_rays(scene, o, d)
        contrib = li_at_hit(o, d, hit, rng.fold(k_step, 0), weight)
        li = li + jnp.where((active & hit.valid)[..., None], contrib, 0.0)

        if depth == spec_cfg.max_depth:
            break

        mat_id = hit.mat
        wo, w_bsdf, eta_ratio, is_delta = specular_bounce(
            scene, rng.uniform(rng.fold(k_step, 1), (b,)), mat_id, d,
            hit.ng_raw,
        )
        tau = mapi.transmittance(scene.medium, o, hit.p)
        twes2 = twes * tau * w_bsdf * (eta_ratio * eta_ratio)[..., None]

        max_rr = jnp.where(depth + 1 >= spec_cfg.forced_rr_depth, 0.98, 1.0)
        rr_prob = jnp.minimum(max_rr, jnp.max(twes2, axis=-1))
        u = rng.uniform(rng.fold(k_step, 2), (b,))
        go = active & hit.valid & is_delta & (rr_prob > 0) & (
            (rr_prob >= 1.0) | (u < rr_prob)
        )
        scale = 1.0 / jnp.maximum(rr_prob, 1e-30)
        weight = weight * tau * w_bsdf * scale[..., None]
        twes = twes2 * scale[..., None]
        active = go
        o = hit.p
        d = wo
    return li
