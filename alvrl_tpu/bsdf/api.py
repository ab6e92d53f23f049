"""Central BSDF dispatch: eval + sample over the material table.

Replaces the reference's BSDF virtual interface (include/mitsuba/render/
bsdf.h): the per-plugin virtual dispatch becomes masked arithmetic over
the material-kind column, evaluated once here instead of being inlined
at each integrator call site (volpath surface vertices, VRL vol-surf
factor, tracer importance walks).

Wrapper kinds (MASK, MIXTURE — mask.cpp, mixturebsdf.cpp/blendbsdf.cpp)
resolve one level of nesting to a *leaf* kind: selection probability =
opacity / lobe weight; the one-sample estimator stays unbiased because
each branch estimates its own mixture component (weight_i = f_i cos /
pdf_i, selected with probability w_i, sums to the mixture in
expectation).

Transport modes: "radiance" (eye paths) vs "importance" (light paths) —
the only asymmetry in this material set is the 1/eta^2 radiance
compression of dielectric refraction (dielectric.cpp applies it to
ERadiance only).

Occlusion note: shadow rays treat MASK surfaces as opaque (the
reference's evalTransmittance composites the null component of masks;
a documented approximation here).

Scenes whose material table holds only Lambertian and delta kinds
(Materials.kinds(), static under jit) take short paths that compute
those kinds alone: the same values, a fraction of the program (the full
dispatch quadruples the compiled size of a render or train step).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from alvrl_tpu.bsdf import lobes
from alvrl_tpu.bsdf import microfacet as mf
from alvrl_tpu.core import math as m
from alvrl_tpu.core import rng, warp
from alvrl_tpu.scene.scene import (
    COATING, DIELECTRIC, DIFFTRANS, DIFFUSE, HK, IRAWAN, MASK, MIRROR,
    MIXTURE, NORMALMAP, NULL, PHONG, PLASTIC, ROUGH_COATING,
    ROUGH_CONDUCTOR, ROUGH_DIELECTRIC, ROUGH_PLASTIC, WARD,
    Scene,
)
from alvrl_tpu.textures.procedural import albedo_at

LAMBERT_DELTA = frozenset((DIFFUSE, NULL, MIRROR, DIELECTRIC))


def lambert_delta_only(scene: Scene) -> bool:
    """Whether every material is Lambertian or delta (static)."""
    kinds = scene.materials.kinds()
    return kinds is not None and kinds <= LAMBERT_DELTA


def _leaf_eval_local(scene: Scene, mat_id, wi_l, wo_l, albedo):
    """f * cos_o for the smooth component of a *leaf* material kind,
    in the local frame (z = shading normal). Delta kinds -> 0."""
    mats = scene.materials
    kind = mats.kind[mat_id]
    alpha = mats.alpha[mat_id]
    alpha_v = mats.alpha_v[mat_id]
    dist = mats.dist[mat_id]
    cos_o = jnp.maximum(wo_l[..., 2], 0.0)

    f_diffuse = albedo * (cos_o / jnp.pi)[..., None]
    f_cond = mf.eval_rough_conductor_d(wi_l, wo_l, dist, alpha, alpha_v,
                                       albedo)
    f_rplastic = mf.eval_rough_plastic_d(wi_l, wo_l, dist, alpha, alpha_v,
                                         albedo)
    f_rdiel = albedo * mf.eval_rough_dielectric(
        wi_l, wo_l, mats.eta[mat_id], dist, alpha, alpha_v
    )[..., None]
    f_phong = lobes.eval_phong(
        wi_l, wo_l, albedo, mats.specular[mat_id], mats.exponent[mat_id]
    )
    f_ward = lobes.eval_ward(
        wi_l, wo_l, albedo, mats.specular[mat_id], alpha,
        mats.alpha_v[mat_id],
    )
    f_dtrans = lobes.eval_difftrans(wi_l, wo_l, albedo)
    f_plastic = lobes.eval_plastic_smooth(wi_l, wo_l, albedo,
                                          mats.eta[mat_id])

    out = jnp.where(
        (kind == DIFFUSE)[..., None], f_diffuse,
        jnp.where(
            (kind == ROUGH_CONDUCTOR)[..., None], f_cond,
            jnp.where(
                (kind == ROUGH_PLASTIC)[..., None], f_rplastic,
                jnp.where(
                    (kind == PHONG)[..., None], f_phong,
                    jnp.where(
                        (kind == WARD)[..., None], f_ward,
                        jnp.where(
                            (kind == DIFFTRANS)[..., None], f_dtrans,
                            jnp.where(
                                (kind == PLASTIC)[..., None], f_plastic,
                                jnp.where(
                                    (kind == ROUGH_DIELECTRIC)[..., None],
                                    f_rdiel, 0.0),
                            ),
                        ),
                    ),
                ),
            ),
        ),
    )
    return out


def eval_smooth(scene: Scene, mat_id, ng, wi_world, wo_world,
                p_world=None, uv=None):
    """BSDF eval * cos(theta_o) of the smooth (ESmooth) components —
    the reference's bsdf->eval(bRec) with ESmooth-only measure
    (vrlIntegrator.cpp:758-761). Resolves MASK/MIXTURE/COATING/
    NORMALMAP wrappers and the HK slab."""
    from alvrl_tpu.bsdf import layered

    mats = scene.materials
    kind = mats.kind[mat_id]
    if lambert_delta_only(scene):
        s_f, t_f = m.build_frame(ng)
        cos_o = jnp.maximum(m.frame_to_local(s_f, t_f, ng, wo_world)[..., 2],
                            0.0)
        alb = (mats.albedo[mat_id] if p_world is None
               else albedo_at(scene, mat_id, p_world, uv=uv))
        return jnp.where((kind == DIFFUSE)[..., None],
                         alb * (cos_o / jnp.pi)[..., None], 0.0)

    # normal mapping perturbs the shading frame before everything else
    if uv is not None:
        ng_pert = layered.perturbed_normal(scene, mat_id, ng, uv)
        ng = jnp.where((kind == NORMALMAP)[..., None], ng_pert, ng)
    s_f, t_f = m.build_frame(ng)
    wi_l = m.frame_to_local(s_f, t_f, ng, wi_world)
    wo_l = m.frame_to_local(s_f, t_f, ng, wo_world)

    def leaf(mid, wi=None, wo=None):
        alb = (mats.albedo[mid] if p_world is None
               else albedo_at(scene, mid, p_world, uv=uv))
        return _leaf_eval_local(
            scene, mid,
            wi_l if wi is None else wi,
            wo_l if wo is None else wo, alb,
        )

    f_leaf = leaf(mat_id)
    f_n1 = leaf(mats.nested[mat_id])
    f_n2 = leaf(mats.nested2[mat_id])
    w = mats.opacity[mat_id][..., None]

    # coating.cpp eval: Fresnel-attenuated nested eval at the refracted
    # directions, slab absorption, solid-angle measure factor
    eta_c = mats.eta[mat_id]
    fi, fo, wi_p, wo_p, ok_c, jac = layered.coating_factors(
        wi_l, wo_l, eta_c)
    absorb = layered.coating_absorption(
        mats.albedo2[mat_id], mats.exponent[mat_id],
        wi_p[..., 2], wo_p[..., 2])
    f_coat = leaf(mats.nested[mat_id], wi=wi_p, wo=wo_p) * (
        (1.0 - fi) * (1.0 - fo) * jac)[..., None] * absorb
    f_coat = jnp.where(ok_c[..., None], f_coat, 0.0)

    # hk.cpp's eval output is already in the f*cos convention
    f_hk = layered.hk_eval(
        wi_l, wo_l, mats.albedo[mat_id], mats.albedo2[mat_id],
        mats.exponent[mat_id], mats.alpha[mat_id],
    )

    # roughcoating.cpp eval (:257-320): glossy microfacet reflection at
    # the coat interface + nested eval at SMOOTH-refracted directions,
    # attenuated by the rough transmittance T(cos, alpha) both ways,
    # slab absorption, and the same measure factor as smooth coating
    a_rc = mats.alpha[mat_id]
    dist_rc = mats.dist[mat_id]
    same_side = wi_l[..., 2] * wo_l[..., 2] > 0
    h_rc = m.normalize(wi_l + wo_l)
    h_rc = h_rc * jnp.sign(h_rc[..., 2] + 1e-20)[..., None]
    d_rc = mf.mf_d(dist_rc, h_rc, a_rc, a_rc)
    g_rc = (mf.mf_g1(dist_rc, wi_l, h_rc, a_rc, a_rc)
            * mf.mf_g1(dist_rc, wo_l, h_rc, a_rc, a_rc))
    fr_rc = lobes.fresnel_dielectric_scalar(
        jnp.abs(m.dot(wi_l, h_rc)), eta_c)
    spec_rc = fr_rc * d_rc * g_rc / jnp.maximum(
        4.0 * jnp.abs(wi_l[..., 2]), 1e-9)
    spec_rc = jnp.where(same_side, spec_rc, 0.0)
    t_i = mf.rough_transmittance_b(
        mats.rt_table[mat_id], wi_l[..., 2], a_rc,
        mats.rt_alpha_max[mat_id])
    t_o = mf.rough_transmittance_b(
        mats.rt_table[mat_id], wo_l[..., 2], a_rc,
        mats.rt_alpha_max[mat_id])
    f_rcoat = (
        leaf(mats.nested[mat_id], wi=wi_p, wo=wo_p)
        * (t_i * t_o * jac)[..., None] * absorb
    )
    f_rcoat = jnp.where(ok_c[..., None], f_rcoat, 0.0) \
        + spec_rc[..., None]

    out = jnp.where(
        (kind == MASK)[..., None], w * f_n1,
        jnp.where(
            (kind == MIXTURE)[..., None], w * f_n1 + (1.0 - w) * f_n2,
            jnp.where(
                (kind == COATING)[..., None], f_coat,
                jnp.where(
                    (kind == ROUGH_COATING)[..., None], f_rcoat,
                    jnp.where(
                        (kind == HK)[..., None], f_hk,
                        jnp.where((kind == NORMALMAP)[..., None],
                                  f_n1, f_leaf),
                    ),
                ),
            ),
        ),
    )
    if scene.weave is not None:
        from alvrl_tpu.bsdf import irawan as irw

        uv_w = uv if uv is not None else jnp.zeros(wi_l.shape[:-1] + (2,))
        f_ir = irw.eval_raw(scene.weave, uv_w, wi_l, wo_l)
        out = jnp.where((kind == IRAWAN)[..., None], f_ir, out)
    return out


def _leaf_pdf_local(scene: Scene, mat_id, wi_l, wo_l):
    """Solid-angle pdf of `sample`'s smooth lobe for a *leaf* kind
    (the measure MIS weights need; delta kinds -> 0)."""
    mats = scene.materials
    kind = mats.kind[mat_id]
    alpha = mats.alpha[mat_id]
    albedo = mats.albedo[mat_id]
    dist = mats.dist[mat_id]
    cos_o = jnp.maximum(wo_l[..., 2], 0.0)

    pdf_cos = cos_o / jnp.pi  # diffuse + rough-plastic + plastic base
    pdf_ggx = mf.pdf_rough_conductor_d(wi_l, wo_l, dist, alpha,
                                       mats.alpha_v[mat_id])
    pdf_rd = mf.pdf_rough_dielectric(wi_l, wo_l, mats.eta[mat_id], dist,
                                     alpha, mats.alpha_v[mat_id])
    pdf_ph = lobes.pdf_phong(wi_l, wo_l, albedo, mats.specular[mat_id],
                             mats.exponent[mat_id])
    pdf_wd = lobes.pdf_ward(wi_l, wo_l, albedo, mats.specular[mat_id],
                            alpha, mats.alpha_v[mat_id])
    pdf_dt = jnp.where((wi_l[..., 2] * wo_l[..., 2]) < 0,
                       jnp.abs(wo_l[..., 2]) / jnp.pi, 0.0)
    # smooth plastic: diffuse lobe chosen with prob (1 - F_i)
    fi = lobes.fresnel_dielectric_scalar(wi_l[..., 2], mats.eta[mat_id])
    pdf_pl = (1.0 - fi) * pdf_cos

    return jnp.where(
        (kind == DIFFUSE) | (kind == IRAWAN), pdf_cos,
        jnp.where(
            kind == ROUGH_CONDUCTOR, pdf_ggx,
            jnp.where(
                kind == ROUGH_PLASTIC, pdf_cos,
                jnp.where(
                    kind == PHONG, pdf_ph,
                    jnp.where(
                        kind == WARD, pdf_wd,
                        jnp.where(
                            kind == DIFFTRANS, pdf_dt,
                            jnp.where(
                                kind == PLASTIC, pdf_pl,
                                jnp.where(kind == ROUGH_DIELECTRIC,
                                          pdf_rd, 0.0))),
                    ),
                ),
            ),
        ),
    )


def pdf_smooth(scene: Scene, mat_id, ng, wi_world, wo_world, uv=None):
    """Solid-angle pdf that `sample` generates wo given wi over the
    smooth lobes (BSDF::pdf with ESmooth measure) — the quantity
    bidirectional MIS weights need. Wrapper kinds mix nested pdfs by
    their selection probabilities."""
    from alvrl_tpu.bsdf import layered

    mats = scene.materials
    kind = mats.kind[mat_id]
    if lambert_delta_only(scene):
        s_f, t_f = m.build_frame(ng)
        cos_o = jnp.maximum(m.frame_to_local(s_f, t_f, ng, wo_world)[..., 2],
                            0.0)
        return jnp.where(kind == DIFFUSE, cos_o / jnp.pi, 0.0)
    if uv is not None:
        ng_pert = layered.perturbed_normal(scene, mat_id, ng, uv)
        ng = jnp.where((kind == NORMALMAP)[..., None], ng_pert, ng)
    s_f, t_f = m.build_frame(ng)
    wi_l = m.frame_to_local(s_f, t_f, ng, wi_world)
    wo_l = m.frame_to_local(s_f, t_f, ng, wo_world)

    p_leaf = _leaf_pdf_local(scene, mat_id, wi_l, wo_l)
    p_n1 = _leaf_pdf_local(scene, mats.nested[mat_id], wi_l, wo_l)
    p_n2 = _leaf_pdf_local(scene, mats.nested2[mat_id], wi_l, wo_l)
    w = mats.opacity[mat_id]

    fi, _, wi_p, wo_p, ok_c, jac = layered.coating_factors(
        wi_l, wo_l, mats.eta[mat_id])
    p_coat = (1.0 - fi) * _leaf_pdf_local(
        scene, mats.nested[mat_id], wi_p, wo_p) * jac
    p_coat = jnp.where(ok_c, p_coat, 0.0)
    p_hk = layered.hk_pdf(wi_l, wo_l)

    # roughcoating pdf: glossy-lobe pdf * selection prob + nested pdf
    # at refracted dirs * (1 - prob) * measure jac (roughcoating.cpp
    # :322-366 structure; selection prob = 1 - T(cos_i, alpha))
    a_rc = mats.alpha[mat_id]
    dist_rc = mats.dist[mat_id]
    t_i = mf.rough_transmittance_b(
        mats.rt_table[mat_id], wi_l[..., 2], a_rc,
        mats.rt_alpha_max[mat_id])
    prob_spec = jnp.clip(1.0 - t_i, 0.05, 0.95)
    h_rc = m.normalize(wi_l + wo_l)
    h_rc = h_rc * jnp.sign(h_rc[..., 2] + 1e-20)[..., None]
    p_spec = mf.mf_pdf(dist_rc, h_rc, a_rc, a_rc) / jnp.maximum(
        4.0 * jnp.abs(m.dot(wo_l, h_rc)), 1e-9)
    p_spec = jnp.where(wi_l[..., 2] * wo_l[..., 2] > 0, p_spec, 0.0)
    p_rcoat = prob_spec * p_spec + (1.0 - prob_spec) * jnp.where(
        ok_c, _leaf_pdf_local(scene, mats.nested[mat_id], wi_p, wo_p)
        * jac, 0.0)

    return jnp.where(
        kind == MASK, w * p_n1,
        jnp.where(
            kind == MIXTURE, w * p_n1 + (1.0 - w) * p_n2,
            jnp.where(
                kind == COATING, p_coat,
                jnp.where(
                    kind == ROUGH_COATING, p_rcoat,
                    jnp.where(kind == HK, p_hk,
                              jnp.where(kind == NORMALMAP, p_n1, p_leaf)),
                ),
            ),
        ),
    )


class BSDFSample(NamedTuple):
    wo: jax.Array         # (..., 3) world outgoing direction
    weight: jax.Array     # (..., 3) throughput factor f*cos/pdf (or tint)
    eta_ratio: jax.Array  # relative-IOR change of the sampled lobe
    is_delta: jax.Array   # bool: the SAMPLED lobe is a delta lobe
    is_smooth: jax.Array  # bool: material has a smooth component
    valid: jax.Array      # bool: sample usable (a recognized lobe)


N_SAMPLE_DIMS = 5  # uniforms consumed by sample_from_uniforms


def sample(scene: Scene, key, mat_id, ng, ng_raw, d_in, p_world,
           mode: str = "radiance", uv=None) -> BSDFSample:
    """Sample the BSDF at a surface hit. ng is the oriented shading
    normal, ng_raw the winding normal (delta refraction needs it),
    d_in the incoming ray direction (pointing AT the surface)."""
    u = rng.uniform(
        key, jnp.shape(scene.materials.kind[mat_id]) + (N_SAMPLE_DIMS,)
    )
    return sample_from_uniforms(scene, u, mat_id, ng, ng_raw, d_in,
                                p_world, mode=mode, uv=uv)


def sample_from_uniforms(scene: Scene, u, mat_id, ng, ng_raw, d_in,
                         p_world, mode: str = "radiance",
                         uv=None) -> BSDFSample:
    """Explicit-uniform BSDF sampling (u: (..., N_SAMPLE_DIMS)) — the
    primary-sample-space entry point (pssmlt owns and mutates u)."""
    from alvrl_tpu.integrators.vrl.specular import specular_bounce

    if lambert_delta_only(scene):
        return _sample_lambert_delta(scene, u, mat_id, ng, ng_raw, d_in,
                                     p_world, mode, uv)
    mats = scene.materials

    from alvrl_tpu.bsdf import layered

    # ---- wrapper resolution (one nesting level) ----------------------
    kind0 = mats.kind[mat_id]
    u_sel = u[..., 0]
    opac = mats.opacity[mat_id]
    is_mask = kind0 == MASK
    is_mix = kind0 == MIXTURE
    is_nmap = kind0 == NORMALMAP
    is_coat = kind0 == COATING
    is_hk = kind0 == HK
    mask_pass = is_mask & (u_sel >= opac)
    eff = jnp.where(
        is_mask | is_nmap, mats.nested[mat_id],
        jnp.where(is_mix & (u_sel < opac), mats.nested[mat_id],
                  jnp.where(is_mix, mats.nested2[mat_id], mat_id)),
    )

    # normal mapping perturbs the shading frame (normalmap.cpp)
    if uv is not None:
        ng_pert = layered.perturbed_normal(scene, mat_id, ng, uv)
        ng = jnp.where(is_nmap[..., None], ng_pert, ng)

    s_f, t_f = m.build_frame(ng)
    wi_l = m.frame_to_local(s_f, t_f, ng, -d_in)

    # coating.cpp: select the delta coat lobe with prob F(wi); the
    # transmitted branch shades the nested BSDF at REFRACTED directions
    eta_c = mats.eta[mat_id]
    fi_c = lobes.fresnel_dielectric_scalar(jnp.abs(wi_l[..., 2]), eta_c)
    coat_refl = is_coat & (u_sel < fi_c)
    coat_trans = is_coat & ~coat_refl
    # roughcoating.cpp: the glossy coat lobe is selected with prob
    # 1 - T(cos_i, alpha) (the reflected energy fraction)
    is_rcoat = kind0 == ROUGH_COATING
    a_rc0 = mats.alpha[mat_id]
    dist_rc0 = mats.dist[mat_id]
    t_i_rc = mf.rough_transmittance_b(
        mats.rt_table[mat_id], wi_l[..., 2], a_rc0,
        mats.rt_alpha_max[mat_id])
    prob_spec_rc = jnp.clip(1.0 - t_i_rc, 0.05, 0.95)
    rcoat_refl = is_rcoat & (u_sel < prob_spec_rc)
    rcoat_trans = is_rcoat & ~rcoat_refl
    wi_orig_l = wi_l
    wi_refr, _ = layered.refract_z(wi_l, 1.0 / eta_c)
    wi_l = jnp.where((coat_trans | rcoat_trans)[..., None], wi_refr, wi_l)
    eff = jnp.where(coat_trans | rcoat_trans, mats.nested[mat_id], eff)

    kind = mats.kind[eff]
    albedo = albedo_at(scene, eff, p_world, uv=uv)
    alpha = mats.alpha[eff]
    u2 = u[..., 1:3]
    u3 = jnp.concatenate([u[..., 3:4], u2], axis=-1)

    # ---- leaf candidates ---------------------------------------------
    wo_diffuse_l = warp.square_to_cosine_hemisphere(u2)
    w_diffuse = albedo

    wo_rc_l, w_rc, _ = mf.sample_rough_conductor(u2, wi_l, alpha, albedo)

    # rough plastic: cosine-sample the full eval (weight f*cos/pdf)
    cos_d = jnp.maximum(wo_diffuse_l[..., 2], 1e-6)
    w_rp = mf.eval_rough_plastic(wi_l, wo_diffuse_l, alpha, albedo) * (
        jnp.pi / cos_d
    )[..., None]

    wo_ph_l, w_ph, _ = lobes.sample_phong(
        u3, wi_l, albedo, mats.specular[eff], mats.exponent[eff]
    )
    wo_wd_l, w_wd, _ = lobes.sample_ward(
        u3, wi_l, albedo, mats.specular[eff], alpha, mats.alpha_v[eff]
    )
    wo_dt_l, w_dt, _ = lobes.sample_difftrans(u2, wi_l, albedo)
    wo_pl_l, w_pl, pl_delta = lobes.sample_plastic_smooth(
        u3, wi_l, albedo, mats.eta[eff]
    )
    wo_rd_l, w_rd, _, rd_trans = mf.sample_rough_dielectric(
        u3, wi_l, mats.eta[eff], mats.dist[eff], alpha,
        mats.alpha_v[eff], mode=mode,
    )
    w_rd = w_rd * albedo  # specular reflect/transmit tint

    # delta kinds (mirror/null/dielectric) in world space
    wo_spec, w_spec, eta_ratio_d, is_delta_kind = specular_bounce(
        scene, u[..., 4], eff, d_in, ng_raw
    )
    if mode == "importance":
        # strip the radiance-only 1/eta^2 refraction factor
        # (dielectric.cpp applies it to ERadiance transport only)
        w_spec = jnp.where(
            (kind == DIELECTRIC)[..., None]
            & (jnp.abs(eta_ratio_d - 1.0) > 1e-6)[..., None],
            jnp.ones_like(w_spec), w_spec,
        )

    # ---- select -------------------------------------------------------
    def pick_l(masks_vals, default_l):
        out = default_l
        for mk, val in masks_vals:
            out = jnp.where(mk[..., None], val, out)
        return out

    wo_l = pick_l(
        [(kind == ROUGH_CONDUCTOR, wo_rc_l),
         (kind == PHONG, wo_ph_l),
         (kind == WARD, wo_wd_l),
         (kind == DIFFTRANS, wo_dt_l),
         (kind == PLASTIC, wo_pl_l),
         (kind == ROUGH_DIELECTRIC, wo_rd_l)],
        wo_diffuse_l,  # DIFFUSE + ROUGH_PLASTIC use the cosine lobe
    )
    weight = pick_l(
        [(kind == ROUGH_CONDUCTOR, w_rc),
         (kind == ROUGH_PLASTIC, w_rp),
         (kind == PHONG, w_ph),
         (kind == WARD, w_wd),
         (kind == DIFFTRANS, w_dt),
         (kind == PLASTIC, w_pl),
         (kind == ROUGH_DIELECTRIC, w_rd)],
        w_diffuse,
    )
    # ---- coating exit: refract the nested sample back out -------------
    # (1-Fi) cancels against the transmission selection probability;
    # total internal reflection on exit kills the sample (coating.cpp)
    wo_exit, ok_exit = layered.refract_z(wo_l, eta_c)
    fo_c = lobes.fresnel_dielectric_scalar(
        jnp.abs(wo_exit[..., 2]), eta_c)
    absorb_c = layered.coating_absorption(
        mats.albedo2[mat_id], mats.exponent[mat_id],
        wi_l[..., 2], wo_l[..., 2])
    w_coat_t = weight * (1.0 - fo_c)[..., None] * absorb_c
    wo_coat_r_l = jnp.stack(
        [-wi_l[..., 0], -wi_l[..., 1], wi_l[..., 2]], axis=-1)
    coat_dead = coat_trans & ~ok_exit
    wo_l = jnp.where(coat_trans[..., None], wo_exit, wo_l)
    wo_l = jnp.where((coat_refl | coat_dead)[..., None], wo_coat_r_l,
                     wo_l)
    weight = jnp.where(coat_trans[..., None], w_coat_t, weight)
    weight = jnp.where(coat_refl[..., None], jnp.ones_like(weight),
                       weight)

    # ---- rough coating (roughcoating.cpp:368-470) ---------------------
    # reflection: sample the microfacet lobe at the ORIGINAL wi;
    # weight = F D G / (4|ci|) / (pdf_m jac prob_spec)
    mh_rc, _ = mf.mf_sample(dist_rc0, u2, a_rc0, a_rc0)
    cos_wih_rc = m.dot(wi_orig_l, mh_rc)
    wo_rc_spec = 2.0 * cos_wih_rc[..., None] * mh_rc - wi_orig_l
    fr_rc = lobes.fresnel_dielectric_scalar(jnp.abs(cos_wih_rc), eta_c)
    d_rc = mf.mf_d(dist_rc0, mh_rc, a_rc0, a_rc0)
    g_rc = (mf.mf_g1(dist_rc0, wi_orig_l, mh_rc, a_rc0, a_rc0)
            * mf.mf_g1(dist_rc0, wo_rc_spec, mh_rc, a_rc0, a_rc0))
    fcos_rc = fr_rc * d_rc * g_rc / jnp.maximum(
        4.0 * jnp.abs(wi_orig_l[..., 2]), 1e-9)
    pdf_rc_spec = (mf.mf_pdf(dist_rc0, mh_rc, a_rc0, a_rc0)
                   / jnp.maximum(4.0 * jnp.abs(
                       m.dot(wo_rc_spec, mh_rc)), 1e-9))
    ok_rc_r = (wo_rc_spec[..., 2] * wi_orig_l[..., 2] > 0) \
        & (pdf_rc_spec > 1e-20)
    w_rcoat_r = (fcos_rc / jnp.maximum(
        pdf_rc_spec * prob_spec_rc, 1e-20))[..., None] \
        * jnp.ones((3,), jnp.float32)
    # transmission: nested weight x T_i/p_t x T_o(exit) x absorption
    t_o_rc = mf.rough_transmittance_b(
        mats.rt_table[mat_id], wo_exit[..., 2], a_rc0,
        mats.rt_alpha_max[mat_id])
    w_rcoat_t = weight * (
        t_i_rc / jnp.maximum(1.0 - prob_spec_rc, 1e-6) * t_o_rc
    )[..., None] * absorb_c
    rcoat_dead = (rcoat_trans & ~ok_exit) | (rcoat_refl & ~ok_rc_r)
    wo_l = jnp.where(rcoat_trans[..., None], wo_exit, wo_l)
    wo_l = jnp.where(rcoat_refl[..., None], wo_rc_spec, wo_l)
    weight = jnp.where(rcoat_trans[..., None], w_rcoat_t, weight)
    weight = jnp.where(rcoat_refl[..., None], w_rcoat_r, weight)

    # ---- HK slab: delta transmission vs two-sided cosine lobe ---------
    sig_s_hk = mats.albedo[mat_id]
    sig_a_hk = mats.albedo2[mat_id]
    th_hk = mats.exponent[mat_id]
    g_hk = mats.alpha[mat_id]
    t_delta = layered.hk_delta_transmittance(
        wi_l, sig_s_hk, sig_a_hk, th_hk)
    p_delta = jnp.clip(jnp.mean(t_delta, axis=-1), 1e-3, 0.9)
    hk_delta = is_hk & (u_sel < p_delta)
    hk_scat = is_hk & ~hk_delta
    flip = u[..., 3] < 0.5
    wo_hk_l = jnp.where(
        flip[..., None],
        wo_diffuse_l * jnp.asarray([1.0, 1.0, -1.0]), wo_diffuse_l)
    f_hk = layered.hk_eval(wi_l, wo_hk_l, sig_s_hk, sig_a_hk, th_hk,
                           g_hk)
    pdf_hk = layered.hk_pdf(wi_l, wo_hk_l)
    w_hk = f_hk / jnp.maximum(
        pdf_hk * (1.0 - p_delta), 1e-12)[..., None]
    w_hk_delta = t_delta / p_delta[..., None]
    wo_l = jnp.where(hk_scat[..., None], wo_hk_l, wo_l)
    weight = jnp.where(hk_scat[..., None], w_hk, weight)

    # woven cloth: cosine direction (the default wo), weight f*cos/pdf
    # = eval * pi / cos (irawan.cpp:336-371)
    if scene.weave is not None:
        from alvrl_tpu.bsdf import irawan as irw

        uv_w = uv if uv is not None else jnp.zeros(wi_l.shape[:-1] + (2,))
        f_ir = irw.eval_raw(scene.weave, uv_w, wi_l, wo_diffuse_l)
        w_ir = f_ir * (np.pi / jnp.maximum(
            wo_diffuse_l[..., 2], 1e-6))[..., None]
        weight = jnp.where((kind == IRAWAN)[..., None], w_ir, weight)

    wo_world = m.frame_to_world(s_f, t_f, ng, wo_l)

    smooth_kinds = (
        (kind == DIFFUSE) | (kind == ROUGH_CONDUCTOR)
        | (kind == ROUGH_PLASTIC) | (kind == PHONG) | (kind == WARD)
        | (kind == DIFFTRANS) | (kind == PLASTIC) | (kind == IRAWAN)
        | (kind == ROUGH_DIELECTRIC)
    )
    sampled_delta = (is_delta_kind | ((kind == PLASTIC) & pl_delta)
                     | coat_refl | hk_delta)
    wo = jnp.where(is_delta_kind[..., None], wo_spec, wo_world)
    weight = jnp.where(is_delta_kind[..., None], w_spec, weight)
    eta_ratio = jnp.where(is_delta_kind, eta_ratio_d, 1.0)
    # rough-dielectric refraction changes the relative IOR like the
    # smooth dielectric delta lobe does
    rd_eta = jnp.where(wi_l[..., 2] > 0,
                       1.0 / jnp.maximum(mats.eta[eff], 1e-6),
                       mats.eta[eff])
    eta_ratio = jnp.where((kind == ROUGH_DIELECTRIC) & rd_trans,
                          rd_eta, eta_ratio)

    # plastic's sampled delta lobe: mirror reflection about ng
    wo_pl_spec = m.frame_to_world(s_f, t_f, ng, wo_pl_l)
    wo = jnp.where(((kind == PLASTIC) & pl_delta)[..., None],
                   wo_pl_spec, wo)

    # HK delta transmission continues straight through (hk.cpp:206)
    wo = jnp.where(hk_delta[..., None], d_in, wo)
    weight = jnp.where(hk_delta[..., None], w_hk_delta, weight)

    # mask pass-through (the null component of mask.cpp)
    wo = jnp.where(mask_pass[..., None], d_in, wo)
    weight = jnp.where(mask_pass[..., None], jnp.ones_like(weight), weight)
    eta_ratio = jnp.where(mask_pass, 1.0, eta_ratio)
    is_delta = sampled_delta | mask_pass
    valid = (smooth_kinds | is_delta_kind | mask_pass | is_coat
             | is_rcoat | is_hk) & ~coat_dead & ~rcoat_dead
    # the smooth flag reports the *material*: PLASTIC keeps a smooth
    # base even when the delta coat was sampled
    is_smooth = (smooth_kinds | is_coat | is_rcoat | is_hk) & ~mask_pass
    weight = jnp.where((coat_dead | rcoat_dead)[..., None], 0.0, weight)
    return BSDFSample(
        wo=wo, weight=weight, eta_ratio=eta_ratio,
        is_delta=is_delta, is_smooth=is_smooth, valid=valid,
    )


def _sample_lambert_delta(scene: Scene, u, mat_id, ng, ng_raw, d_in,
                          p_world, mode, uv) -> BSDFSample:
    """sample_from_uniforms for a table of Lambertian and delta kinds:
    the cosine lobe of DIFFUSE and the delta continuations, with the
    full dispatch's uniforms and values."""
    from alvrl_tpu.integrators.vrl.specular import specular_bounce

    kind = scene.materials.kind[mat_id]
    s_f, t_f = m.build_frame(ng)
    wo_l = warp.square_to_cosine_hemisphere(u[..., 1:3])
    albedo = albedo_at(scene, mat_id, p_world, uv=uv)
    wo_spec, w_spec, eta_ratio_d, is_delta = specular_bounce(
        scene, u[..., 4], mat_id, d_in, ng_raw)
    if mode == "importance":
        w_spec = jnp.where(
            (kind == DIELECTRIC)[..., None]
            & (jnp.abs(eta_ratio_d - 1.0) > 1e-6)[..., None],
            jnp.ones_like(w_spec), w_spec,
        )
    is_diffuse = kind == DIFFUSE
    return BSDFSample(
        wo=jnp.where(is_delta[..., None], wo_spec,
                     m.frame_to_world(s_f, t_f, ng, wo_l)),
        weight=jnp.where(is_delta[..., None], w_spec, albedo),
        eta_ratio=jnp.where(is_delta, eta_ratio_d, 1.0),
        is_delta=is_delta, is_smooth=is_diffuse,
        valid=is_diffuse | is_delta,
    )
