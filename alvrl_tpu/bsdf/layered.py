"""Layered / slab BSDF building blocks: smooth coating (coating.cpp),
normal/bump mapping (normalmap.cpp/bumpmap.cpp), and the
Hanrahan-Krueger single-scattering slab (hk.cpp).

All functions work in the LOCAL shading frame (z = shading normal) and
plug into the material-table dispatch of bsdf.api.
"""

from __future__ import annotations

import jax.numpy as jnp

from alvrl_tpu.bsdf.lobes import fresnel_dielectric_scalar
from alvrl_tpu.core import math as m

# ---------------------------------------------------------------------------
# coating.cpp: smooth dielectric layer over a nested BSDF
# ---------------------------------------------------------------------------


def refract_z(w_l, inv_eta):
    """Refract a local direction across the z-plane interface, scaling
    the tangential part by inv_eta (coating.cpp:refractTo). Keeps the
    hemisphere sign. Returns (refracted (unit), valid)."""
    x = w_l[..., 0] * inv_eta
    y = w_l[..., 1] * inv_eta
    z2 = 1.0 - x * x - y * y
    valid = z2 > 0.0
    z = jnp.sign(w_l[..., 2]) * jnp.sqrt(jnp.maximum(z2, 0.0))
    return jnp.stack([x, y, z], axis=-1), valid


def coating_absorption(sigma_a, thickness, ci_p, co_p):
    """exp(-sigma_a * thickness * (1/|cos_i'| + 1/|cos_o'|)) — the slab
    absorption along the refracted in/out directions (coating.cpp)."""
    inv = 1.0 / jnp.maximum(jnp.abs(ci_p), 1e-6) + \
        1.0 / jnp.maximum(jnp.abs(co_p), 1e-6)
    return jnp.exp(-sigma_a * (thickness * inv)[..., None])


def coating_factors(wi_l, wo_l, eta):
    """Shared coating geometry: Fresnel terms, refracted directions,
    and the solid-angle measure factor cos(wo)/cos(wo') / eta^2."""
    fi = fresnel_dielectric_scalar(jnp.abs(wi_l[..., 2]), eta)
    fo = fresnel_dielectric_scalar(jnp.abs(wo_l[..., 2]), eta)
    wi_p, ok_i = refract_z(wi_l, 1.0 / eta)
    wo_p, ok_o = refract_z(wo_l, 1.0 / eta)
    jac = jnp.abs(wo_l[..., 2]) / jnp.maximum(
        jnp.abs(wo_p[..., 2]), 1e-6) / (eta * eta)
    return fi, fo, wi_p, wo_p, ok_i & ok_o, jac


# ---------------------------------------------------------------------------
# hk.cpp: Hanrahan-Krueger single-scattering slab
# ---------------------------------------------------------------------------


def hk_eval(wi_l, wo_l, sigma_s, sigma_a, thickness, g):
    """f*|cos_o| of the glossy reflection + transmission components
    (hk.cpp:eval, ESolidAngle branch, formulas kept verbatim for
    parity). Spectral; HG phase with mean cosine g."""
    from alvrl_tpu.media.phase import eval_hg

    tau_d = (sigma_s + sigma_a) * thickness[..., None]
    sig_t = sigma_s + sigma_a
    albedo = jnp.where(sig_t > 0.0, sigma_s / jnp.maximum(sig_t, 1e-30),
                       0.0)
    ci = wi_l[..., 2]
    co = wo_l[..., 2]
    aci = jnp.maximum(jnp.abs(ci), 1e-6)
    aco = jnp.maximum(jnp.abs(co), 1e-6)
    phase = eval_hg(g, wi_l, wo_l)[..., None]

    # reflection (hk.cpp:233-234)
    refl = albedo * phase * (ci / (ci + co))[..., None] * (
        1.0 - jnp.exp(-(1.0 / aci + 1.0 / aco)[..., None] * tau_d)
    )

    # transmission (hk.cpp:248-256), split on |ci| ~ |co|
    close = jnp.abs(ci + co) < 1e-4
    trans_eq = albedo * phase * (tau_d / aco[..., None]) * jnp.exp(
        -tau_d / aco[..., None])
    denom = jnp.where(jnp.abs(aci - aco) < 1e-6, 1e-6, aci - aco)
    trans_ne = albedo * phase * (aci / denom)[..., None] * (
        jnp.exp(-tau_d / aci[..., None]) - jnp.exp(-tau_d / aco[..., None])
    )
    trans = jnp.where(close[..., None], trans_eq, trans_ne)

    dp = ci * co
    out = jnp.where((dp > 0)[..., None], refl,
                    jnp.where((dp < 0)[..., None], trans, 0.0))
    return jnp.maximum(out, 0.0)


def hk_delta_transmittance(wi_l, sigma_s, sigma_a, thickness):
    """Attenuation of the unscattered straight-through delta lobe
    (hk.cpp:206)."""
    tau_d = (sigma_s + sigma_a) * thickness[..., None]
    return jnp.exp(
        -tau_d / jnp.maximum(jnp.abs(wi_l[..., 2]), 1e-6)[..., None])


def hk_pdf(wi_l, wo_l):
    """pdf of the two-sided cosine sampling used for the HK glossy
    lobes: 0.5 * |cos_o| / pi on each hemisphere."""
    return 0.5 * jnp.abs(wo_l[..., 2]) / jnp.pi


# ---------------------------------------------------------------------------
# normalmap.cpp / bumpmap.cpp: shading-normal perturbation
# ---------------------------------------------------------------------------


def perturbed_normal(scene, mat_id, ng, uv):
    """World shading normal from a tangent-space normal texture
    (normalmap.cpp; the loader converts bumpmap height fields to normal
    maps host-side). Falls back to ng where the texture is flat."""
    from alvrl_tpu.textures.procedural import bitmap_lookup

    t = bitmap_lookup(scene.textures, scene.materials.tex_id[mat_id], uv)
    n_tan = 2.0 * t - 1.0
    s_f, t_f = m.build_frame(ng)
    n_w = (s_f * n_tan[..., 0:1] + t_f * n_tan[..., 1:2]
           + ng * jnp.maximum(n_tan[..., 2:3], 0.1))
    n_w = m.normalize(n_w)
    # keep the perturbed normal in ng's hemisphere
    flip = m.dot(n_w, ng) < 0.0
    return jnp.where(flip[..., None], ng, n_w)


def bump_to_normal_map(height, strength=1.0):
    """Host-side conversion of a (H, W) height texture into a tangent
    normal map (bumpmap.cpp evaluates dh/du, dh/dv at shade time; here
    it is baked once)."""
    import numpy as np

    h = np.asarray(height, np.float32)
    gy, gx = np.gradient(h)
    n = np.stack([-gx * strength, -gy * strength, np.ones_like(h)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return (n * 0.5 + 0.5).astype(np.float32)
