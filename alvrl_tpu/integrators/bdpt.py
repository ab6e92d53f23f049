"""Bidirectional path tracer with Veach multiple importance sampling.

Counterpart of src/integrators/bdpt/ (surface transport only — the
reference's bdpt does not support participating media either; its docs
say so and libbidir paths are surface paths). Emitter support: AREA,
POINT, DIRECTIONAL and CONSTANT-environment lights (the reference's
bdpt covers these through PositionSamplingRecord emitters,
src/libbidir/vertex.cpp). DIRECTIONAL is a delta-direction light
vertex (position sampled on a disk of scene-bounding radius behind the
scene, like sampleRay in directional.cpp); CONSTANT is modeled as an
emitting bounding sphere — light subpaths start on it inward, eye
paths that escape hit it (the s = 0 family), and both families share
one area-measure parameterization so the MIS weights close. ENVMAP
(textured) emitters remain outside bdpt (use volpath/ptracer).

Array design: subpaths have STATIC maximum lengths (n_eye, n_light); both
random walks are lax.scans storing struct-of-arrays vertex records
(position, shading normal, material, throughput beta, forward/reverse
area pdfs, delta flag). Every (s, t) connection strategy is an
*unrolled static loop* — all vertex indexing is compile-time constant,
so XLA sees straight-line masked arithmetic, no dynamic control flow.
The MIS weight uses the standard pdf-ratio recurrence (Veach's balance
of all strategies generating the same path; power-heuristic-free 1/(1 +
sum r_i) balance form, as the reference's computeWeight does over
libbidir Path records), with remap-zero handling for delta vertices.

Strategy coverage per camera sample: s = 0 (unidirectional hit of an
area light), s = 1 (next-event estimation), s >= 2 (light subpath
connections), for every eye prefix t >= 1. The light-tracing family
(light subpath splatted through the lens) is by default provided
separately by the `ptracer` integrator and excluded from the MIS sum;
with BDPTConfig.with_light_tracing the eye-pass weights include the
light-tracing alternative and `render_bdpt_lt` adds the splat pass
with the complementary MIS weights — the full Veach mix (round 4,
VERDICT r03 item 10).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from alvrl_tpu.core import struct

from alvrl_tpu.bsdf import api as bsdf_api
from alvrl_tpu.core import math as m
from alvrl_tpu.core import rng, warp
from alvrl_tpu.emitters import emitters as em_mod
from alvrl_tpu.emitters import envmap as envmap_mod
from alvrl_tpu.film import film as film_mod
from alvrl_tpu.geometry import intersect
from alvrl_tpu.scene.scene import Scene
from alvrl_tpu.sensors import perspective


@struct.dataclass
class BDPTConfig:
    n_eye: int = struct.field(pytree_node=False, default=4)    # surface vertices
    n_light: int = struct.field(pytree_node=False, default=4)  # incl. the light vertex
    ray_tile: int = struct.field(pytree_node=False, default=1024)
    # Fold the light-tracing family (light subpath splatted through the
    # lens; Veach t'=0 in this file's surface-vertex numbering) into the
    # MIS mix: the eye pass's weights then include the light-tracing
    # alternative in their denominators, and render_bdpt_lt adds the
    # splat pass carrying the complementary weights (VERDICT r03 item
    # 10; reference: the camera-connection strategies of
    # src/libbidir/pathsampler.cpp / vertex.cpp). Default False keeps
    # the round-3 behavior (families split between bdpt and ptracer).
    with_light_tracing: bool = struct.field(pytree_node=False,
                                            default=False)
    # Environment-family s=0 strategy mode: False statically skips the
    # block (no env emitter — ADVICE r04 #3), "constant" uses the
    # bounding-sphere vertex conventions (CONSTANT emitters), "envmap"
    # the solid-angle infinite-light conventions (importance-sampled
    # ENVMAP light starts, round 5). The public entry points resolve
    # None from the concrete scene (_resolve_env_strategies); None /
    # legacy True inside _connect_all behave as "constant".
    env_strategies: bool | str | None = struct.field(pytree_node=False,
                                                     default=None)


def _resolve_env_strategies(scene: Scene, cfg: BDPTConfig) -> BDPTConfig:
    """Pin cfg.env_strategies from a CONCRETE scene (call outside jit):
    False (no environment emitter — the s=0 env block is statically
    skipped), "constant" (CONSTANT only — bounding-sphere vertex
    conventions), or "envmap" (ENVMAP present — solid-angle infinite-
    light conventions, round 5 / VERDICT r04 item 7)."""
    if cfg.env_strategies is not None:
        return cfg
    import numpy as _np
    kinds = _np.asarray(scene.emitters.kind)
    if bool(_np.any(kinds == em_mod.ENVMAP)):
        mode = "envmap"
    elif bool(_np.any(kinds == em_mod.CONSTANT)):
        mode = "constant"
    else:
        mode = False
    return cfg.replace(env_strategies=mode)


def _area_pdf(pdf_sa, d_vec, ng_to):
    """Solid-angle pdf at the FROM vertex -> area pdf at the TO vertex.
    d_vec points from -> to; ng_to is the TO vertex normal."""
    d2 = jnp.maximum(m.length_sq(d_vec), 1e-12)
    dirn = d_vec * jax.lax.rsqrt(d2)[..., None]
    return pdf_sa * jnp.abs(m.dot(ng_to, dirn)) / d2


def _remap0(x):
    return jnp.where(x > 0.0, x, 1.0)


# ---------------------------------------------------------------------------
# subpath walks
# ---------------------------------------------------------------------------

def _eye_subpath(scene: Scene, key, ray_o, ray_d, n_eye: int,
                 u_steps=None):
    """Random walk from the camera. Stored vertices start at the first
    surface hit. pdf_fwd[0] = 1 (the camera->x1 segment is shared by
    every strategy at a fixed pixel and cancels in the MIS ratios).
    `u_steps` (n_eye, N_SAMPLE_DIMS) drives the walk from explicit
    uniforms (the primary-sample-space entry used by mlt)."""
    if u_steps is None:
        u_steps = jax.random.uniform(
            key, (n_eye, bsdf_api.N_SAMPLE_DIMS))

    def step(carry, u):
        o, d, beta, active, pdf_next = carry
        hit = intersect.intersect_all(o, d, scene.vertices, scene.faces)
        hp = jnp.where(hit.valid[..., None], hit.p, o)
        mat_id = scene.material[jnp.maximum(hit.prim, 0)]
        emit_id = scene.face_emitter[jnp.maximum(hit.prim, 0)]
        v_valid = active & hit.valid

        smp = bsdf_api.sample_from_uniforms(
            scene, u, mat_id, hit.ng, hit.ng_raw, d, hp, mode="radiance")
        pdf_sa = bsdf_api.pdf_smooth(scene, mat_id, hit.ng, -d, smp.wo)
        pdf_sa = jnp.where(smp.is_delta, 1.0, pdf_sa)
        # reverse pdf at THIS vertex toward the previous one
        pdf_rev_sa = bsdf_api.pdf_smooth(scene, mat_id, hit.ng, smp.wo, -d)
        pdf_rev_sa = jnp.where(smp.is_delta, 1.0, pdf_rev_sa)

        out = dict(
            p=hp, ng=hit.ng, ng_raw=hit.ng_raw, mat=mat_id,
            emit=emit_id, beta=beta,
            pdf_fwd=pdf_next,
            # raw solid-angle forward pdf at the PREVIOUS vertex: the
            # env s=0 family re-converts it onto the bounding sphere
            # (the stored pdf_fwd area conversion uses hp, which is the
            # carried origin for escaped steps)
            pdf_fwd_sa=pdf_next,
            # area-measure conversion toward the previous vertex happens
            # at connection time; store the solid-angle reverse pdf
            pdf_rev_sa=pdf_rev_sa,
            delta=smp.is_delta, valid=v_valid,
            # escaped: the walk was live but the ray left the scene —
            # the env s=0 strategy (constant-environment radiance)
            esc=active & ~hit.valid,
            front=m.dot(hit.ng_raw, -d) > 0,
            wi=-d,
        )
        new_beta = beta * smp.weight
        survive = v_valid & smp.valid & ~jnp.all(smp.weight == 0.0)
        return (hp, smp.wo, new_beta, survive, pdf_sa), out

    init = (ray_o, ray_d, jnp.ones((3,)), jnp.bool_(True), jnp.float32(1.0))
    _, vs = jax.lax.scan(step, init, u_steps)
    # convert pdf_fwd (solid angle at the PREVIOUS vertex) to area here:
    # prev position is ray_o for i=0 else vs.p[i-1]
    prev_p = jnp.concatenate([ray_o[None], vs["p"][:-1]], axis=0)
    vs["pdf_fwd"] = jnp.where(
        jnp.arange(n_eye) == 0,
        jnp.ones(n_eye),  # shared camera segment cancels
        _area_pdf(vs["pdf_fwd"], vs["p"] - prev_p, vs["ng"]),
    )
    vs["prev_p"] = prev_p
    return vs


N_LIGHT_START_DIMS = 5  # emitter select + position 2D + direction 2D


def _bounding_sphere(scene: Scene):
    """Scene bounding sphere (center, radius) enclosing geometry AND
    the camera — the shared parameterization for the env/directional
    light-vertex positions, so every bdpt strategy measures them in the
    same area measure."""
    lo, hi = scene.aabb()
    center = 0.5 * (lo + hi)
    cam_pos = scene.camera.to_world[:3, 3]
    r = jnp.maximum(0.5 * jnp.linalg.norm(hi - lo),
                    jnp.linalg.norm(cam_pos - center))
    return center, 1.05 * r


def _light_start(scene: Scene, key, u5=None):
    """Sample the light subpath origin y0 + start direction, with the
    pdf decomposition bidirectional MIS needs. AREA, POINT,
    DIRECTIONAL (delta direction, disk position behind the scene) and
    CONSTANT env (emitting bounding sphere, inward cosine direction)
    kinds. `u5` (5,) drives the sample from explicit uniforms."""
    em = scene.emitters
    if u5 is None:
        u5 = jax.random.uniform(key, (N_LIGHT_START_DIMS,))
    cdf = jnp.cumsum(em.pmf)
    idx = jnp.clip(
        jnp.searchsorted(cdf, u5[0] * cdf[-1]), 0,
        em.pmf.shape[0] - 1,
    )
    kind = em.kind[idx]
    pmf = em.pmf[idx]
    is_area = kind == em_mod.AREA
    is_point = kind == em_mod.POINT
    is_dir = kind == em_mod.DIRECTIONAL
    is_envc = kind == em_mod.CONSTANT
    is_envm = kind == em_mod.ENVMAP
    center, r_env = _bounding_sphere(scene)

    # position on the light
    uv = u5[1:3]
    su = jnp.sqrt(jnp.clip(uv[0], 1e-9, 1.0))
    b0, b1 = 1.0 - su, uv[1] * su
    tri_p = em.position[idx] + b0 * em.tri_e1[idx] + b1 * em.tri_e2[idx]
    n_face = m.normalize(jnp.cross(em.tri_e1[idx], em.tri_e2[idx]))
    area = jnp.maximum(
        0.5 * jnp.linalg.norm(jnp.cross(em.tri_e1[idx], em.tri_e2[idx])),
        1e-12,
    )
    # directional: disk of radius r_env behind the scene, perpendicular
    # to the beam axis (directional.cpp sampleRay)
    axis = em.direction[idx]
    s_d, t_d = m.build_frame(axis)
    r_disk = r_env * su
    phi_d = 2.0 * jnp.pi * uv[1]
    p_dir = (center - axis * (1.5 * r_env)
             + s_d * (r_disk * jnp.cos(phi_d))
             + t_d * (r_disk * jnp.sin(phi_d)))
    # constant env: point on the bounding sphere, inward normal
    n_out = warp.square_to_uniform_sphere(uv)
    p_envc = center + r_env * n_out

    # ENVMAP: importance-sample the INCOMING direction from the map
    # (round 5, VERDICT r04 item 7; reference: envmap.cpp sampleRay via
    # pathsampler.cpp). PBRT-style infinite-light conventions: the y0
    # "position" pdf is the SOLID-ANGLE direction density (pmf *
    # pdf_env), the beam's area density at the first hit is
    # cos / (pi r^2) (parallel rays through the bounding disk).
    d_envm, pdf_envm, rad_envm = envmap_mod.sample_env(em.env, u5[3:5])
    d0_envm = -d_envm          # into the scene
    s_e, t_e = m.build_frame(d0_envm)
    p_envm = (center - d0_envm * (1.5 * r_env)
              + s_e * (r_disk * jnp.cos(phi_d))
              + t_e * (r_disk * jnp.sin(phi_d)))
    disk_pdf = 1.0 / (jnp.pi * r_env * r_env)

    p0 = jnp.where(is_area, tri_p,
                   jnp.where(is_dir, p_dir,
                             jnp.where(is_envc, p_envc,
                                       jnp.where(is_envm, p_envm,
                                                 em.position[idx]))))
    ng0 = jnp.where(is_area, n_face,
                    jnp.where(is_dir, axis,
                              jnp.where(is_envc, -n_out,
                                        jnp.where(is_envm, d0_envm,
                                                  jnp.array(
                                                      [0.0, 0.0, 1.0])))))
    pdf_pos = jnp.where(
        is_area, pmf / area,
        jnp.where(is_dir, pmf / (jnp.pi * r_env * r_env),
                  jnp.where(is_envc,
                            pmf / (4.0 * jnp.pi * r_env * r_env),
                            jnp.where(is_envm,
                                      pmf * jnp.maximum(pdf_envm, 1e-12),
                                      pmf))))  # point: discrete

    # start direction: cosine about ng0 (area + env sphere), uniform
    # sphere (point), or the fixed beam axis (directional: delta)
    u2 = u5[3:5]
    local = warp.square_to_cosine_hemisphere(u2)
    s_f, t_f = m.build_frame(ng0)
    d_cos = m.frame_to_world(s_f, t_f, ng0, local)
    d_sphere = warp.square_to_uniform_sphere(u2)
    use_cos = is_area | is_envc
    axis_eff = jnp.where(is_envm, d0_envm, axis)
    d0 = jnp.where(use_cos, d_cos,
                   jnp.where(is_dir | is_envm, axis_eff, d_sphere))
    cos0 = jnp.abs(m.dot(ng0, d0))
    pdf_dir = jnp.where(use_cos, cos0 / jnp.pi,
                        jnp.where(is_dir, 1.0,  # delta direction
                                  jnp.where(is_envm, disk_pdf,
                                            1.0 / (4.0 * jnp.pi))))

    # beta of the FIRST surface vertex the walk will hit:
    # area/env: Le * cos / (pdf_pos * pdf_dir); point: I/(pmf pdf_dir);
    # directional: E / pdf_pos (the delta direction carries pdf 1);
    # ENVMAP: Le(w) / (pmf pdf_env disk_pdf)
    inten = em.intensity[idx]
    beta1 = jnp.where(
        use_cos, inten * (cos0 / (pdf_pos * jnp.maximum(pdf_dir, 1e-12))),
        jnp.where(is_dir, inten / pdf_pos,
                  jnp.where(is_envm,
                            rad_envm / (jnp.maximum(pdf_pos, 1e-30)
                                        * disk_pdf),
                            inten / (pmf * pdf_dir))),
    )
    beta0 = jnp.where(use_cos, inten / pdf_pos,
                      jnp.where(is_envm,
                                rad_envm / jnp.maximum(pdf_pos, 1e-30),
                                inten / pmf))
    valid = is_area | is_point | is_dir | is_envc | is_envm
    return dict(
        p0=p0, ng0=ng0, d0=d0, idx=idx, is_area=is_area,
        is_point=is_point, is_dir=is_dir, is_envc=is_envc,
        is_envm=is_envm, use_cos=use_cos, axis=axis_eff, center=center,
        r_env=r_env, pdf_pos=pdf_pos, pdf_dir=pdf_dir,
        beta0=beta0, beta1=beta1, valid=valid, area=area, pmf=pmf,
    )


def _light_subpath(scene: Scene, key, n_light: int, u_start=None,
                   u_steps=None):
    """Light random walk: vertex 0 is ON the light; vertices 1.. are
    surface hits (importance transport). `u_start` (5,) and `u_steps`
    (n_light-1, N_SAMPLE_DIMS) drive it from explicit uniforms."""
    if u_start is None:
        k0, k_walk = jax.random.split(key)
        u_start = jax.random.uniform(k0, (N_LIGHT_START_DIMS,))
        u_steps = jax.random.uniform(
            k_walk, (max(n_light - 1, 1), bsdf_api.N_SAMPLE_DIMS))
    ls = _light_start(scene, None, u5=u_start)

    def step(carry, u):
        o, d, beta, active, pdf_next = carry
        hit = intersect.intersect_all(o, d, scene.vertices, scene.faces)
        hp = jnp.where(hit.valid[..., None], hit.p, o)
        mat_id = scene.material[jnp.maximum(hit.prim, 0)]
        v_valid = active & hit.valid

        smp = bsdf_api.sample_from_uniforms(
            scene, u, mat_id, hit.ng, hit.ng_raw, d, hp,
            mode="importance")
        pdf_sa = bsdf_api.pdf_smooth(scene, mat_id, hit.ng, -d, smp.wo)
        pdf_sa = jnp.where(smp.is_delta, 1.0, pdf_sa)
        pdf_rev_sa = bsdf_api.pdf_smooth(scene, mat_id, hit.ng, smp.wo, -d)
        pdf_rev_sa = jnp.where(smp.is_delta, 1.0, pdf_rev_sa)

        out = dict(
            p=hp, ng=hit.ng, mat=mat_id, beta=beta,
            pdf_fwd=pdf_next, pdf_rev_sa=pdf_rev_sa,
            delta=smp.is_delta, valid=v_valid, wi=-d,
        )
        new_beta = beta * smp.weight
        survive = v_valid & smp.valid & ~jnp.all(smp.weight == 0.0)
        return (hp, smp.wo, new_beta, survive, pdf_sa), out

    init = (ls["p0"], ls["d0"], ls["beta1"], ls["valid"], ls["pdf_dir"])
    _, vs = jax.lax.scan(step, init, u_steps)
    prev_p = jnp.concatenate([ls["p0"][None], vs["p"][:-1]], axis=0)
    vs["pdf_fwd"] = _area_pdf(vs["pdf_fwd"], vs["p"] - prev_p, vs["ng"])
    # ENVMAP start: parallel rays through the bounding disk — the first
    # vertex's area density is cos / (pi r^2), WITHOUT the 1/d^2 of the
    # finite-vertex conversion (PBRT's infinite-light PdfLight)
    pf0_env = jnp.abs(m.dot(vs["ng"][0], ls["d0"])) \
        / (jnp.pi * ls["r_env"] * ls["r_env"])
    vs["pdf_fwd"] = vs["pdf_fwd"].at[0].set(
        jnp.where(ls["is_envm"], pf0_env, vs["pdf_fwd"][0]))
    vs["prev_p"] = prev_p
    return ls, vs


# ---------------------------------------------------------------------------
# connections + MIS
# ---------------------------------------------------------------------------

def _visible_tau(scene, a, b):
    from alvrl_tpu.integrators.vrl.integrate import (
        eval_transmittance_between,
    )

    return eval_transmittance_between(scene, a, b)


def _camera_rev_area_pdf(scene, x, ng):
    """Area pdf at x of the camera generating it through a pixel — the
    per-pixel-area convention the ptracer importance uses (validated
    against volpath), so light-tracing and eye strategies share a
    consistent measure in the MIS ratios."""
    cam = scene.camera
    cam_pos = cam.to_world[:3, 3]
    fwd = cam.to_world[:3, 2]
    dvec = x - cam_pos
    r2 = jnp.maximum(m.length_sq(dvec), 1e-12)
    dirn = dvec * jax.lax.rsqrt(r2)[..., None]
    cos_t = jnp.maximum(m.dot(dirn, fwd), 1e-6)
    d_img = cam.width / (2.0 * jnp.tan(jnp.deg2rad(cam.fov_x_deg) * 0.5))
    pdf_sa = (d_img * d_img) / (cos_t ** 3)
    return _area_pdf(pdf_sa, dvec, ng)


def _mis_weight(scene, ls, lv, ev, s, t, pt_rev, ptm_rev, qs_rev, qsm_rev,
                n_eye, n_light, cam_rev_pdf=None):
    """1 / (1 + sum of pdf ratios over alternative strategies).

    Vertex indexing: eye surface vertices ev[0..t-1] (x1..xt in Veach
    numbering; camera excluded), light vertices: ls (y0) + lv[0..s-2]
    (y1..). pt_rev/ptm_rev/qs_rev/qsm_rev are the connection-induced
    area pdfs replacing pdf_rev at x_{t-1}, x_{t-2}, y_{s-1}, y_{s-2}.

    Static s, t => fully unrolled; `remap0` guards delta/zero pdfs
    (PBRT 16.1.1 / mitsuba's pathWeight)."""
    sum_ri = jnp.float32(0.0)

    def eye_rev(i):
        # area pdf_rev of eye vertex i (toward the camera side), with
        # the connection overrides at t-1 and t-2
        if i == t - 1:
            return pt_rev
        if i == t - 2:
            return ptm_rev
        # stored: reverse solid-angle pdf at vertex i+1 toward vertex i
        pdf_sa = ev["pdf_rev_sa"][i + 1]
        return _area_pdf(pdf_sa, ev["p"][i] - ev["p"][i + 1], ev["ng"][i])

    def eye_delta(i):
        return ev["delta"][i]

    # ---- eye side: strategies that extend the light path ----
    ri = jnp.float32(1.0)
    for i in range(t - 1, 0, -1):
        ri = ri * _remap0(eye_rev(i)) / _remap0(ev["pdf_fwd"][i])
        ok = ~eye_delta(i) & ~eye_delta(i - 1)
        sum_ri = sum_ri + jnp.where(ok, ri, 0.0)
    if cam_rev_pdf is not None and t >= 1:
        # the light-tracing alternative (t'=0): the light path absorbs
        # x1 too and splats through the lens. x1's eye-side pdf is the
        # camera's (pdf_fwd[0] stores 1, the "shared segment cancels"
        # convention, so divide explicitly); the pinhole lens is
        # treated as non-delta for this family (PBRT convention).
        ri = ri * _remap0(eye_rev(0)) / _remap0(cam_rev_pdf)
        sum_ri = sum_ri + jnp.where(~eye_delta(0), ri, 0.0)

    # ---- light side ----
    def light_delta(j):
        if j == 0:
            # delta light vertex: point (delta position) or directional
            # (delta direction — no stochastic strategy can generate the
            # beam direction, so the y0 connection family is unique)
            return ls["is_point"] | ls["is_dir"]
        return lv["delta"][j - 1]

    def light_pdf_fwd(j):
        if j == 0:
            return ls["pdf_pos"]
        return lv["pdf_fwd"][j - 1]

    ri = jnp.float32(1.0)
    for j in range(s - 1, -1, -1):
        if j == s - 1:
            rev_j = qs_rev
        elif j == s - 2:
            rev_j = qsm_rev
        else:
            pdf_sa = lv["pdf_rev_sa"][j]
            rev_j = _area_pdf(
                pdf_sa, _light_p(ls, lv, j) - _light_p(ls, lv, j + 1),
                _light_ng(ls, lv, j),
            )
        ri = ri * _remap0(rev_j) / _remap0(light_pdf_fwd(j))
        ok = ~light_delta(j) & (jnp.bool_(True) if j == 0
                                else ~light_delta(j - 1))
        sum_ri = sum_ri + jnp.where(ok, ri, 0.0)

    return 1.0 / (1.0 + sum_ri)


def _light_p(ls, lv, j):
    return ls["p0"] if j == 0 else lv["p"][j - 1]


def _light_ng(ls, lv, j):
    return ls["ng0"] if j == 0 else lv["ng"][j - 1]


def li_bdpt(scene: Scene, ray_o, ray_d, key, cfg: BDPTConfig):
    """BDPT radiance estimate for one camera ray."""
    k_eye, k_light = jax.random.split(key)
    ev = _eye_subpath(scene, k_eye, ray_o, ray_d, cfg.n_eye)
    ls, lv = _light_subpath(scene, k_light, cfg.n_light)
    return _connect_all(scene, ev, ls, lv, cfg)


def n_dims_bdpt(cfg: BDPTConfig) -> int:
    """Primary-sample-space dimension of one BDPT sample: pixel (2) +
    eye walk + light start + light walk."""
    return (2 + cfg.n_eye * bsdf_api.N_SAMPLE_DIMS + N_LIGHT_START_DIMS
            + max(cfg.n_light - 1, 1) * bsdf_api.N_SAMPLE_DIMS)


def li_bdpt_from_uniforms(scene: Scene, u, cfg: BDPTConfig):
    """Deterministic map u in [0,1]^D -> (pixel_x, pixel_y, Li): the
    whole bidirectional estimator driven by one primary-sample vector
    (the path parameterization Metropolis integrators mutate)."""
    cam = scene.camera
    w, h = cam.width, cam.height
    px = jnp.minimum(u[0] * w, w - 1e-3)
    py = jnp.minimum(u[1] * h, h - 1e-3)
    ix, iy = jnp.floor(px), jnp.floor(py)
    ray_o, ray_d = perspective.sample_ray(
        cam, ix, iy, jitter=jnp.stack([px - ix, py - iy], axis=-1)
    )
    nd = bsdf_api.N_SAMPLE_DIMS
    pos = 2
    u_eye = u[pos:pos + cfg.n_eye * nd].reshape(cfg.n_eye, nd)
    pos += cfg.n_eye * nd
    u_ls = u[pos:pos + N_LIGHT_START_DIMS]
    pos += N_LIGHT_START_DIMS
    n_surf = max(cfg.n_light - 1, 1)
    u_lw = u[pos:pos + n_surf * nd].reshape(n_surf, nd)

    ev = _eye_subpath(scene, None, ray_o, ray_d, cfg.n_eye,
                      u_steps=u_eye)
    ls, lv = _light_subpath(scene, None, cfg.n_light, u_start=u_ls,
                            u_steps=u_lw)
    return px, py, _connect_all(scene, ev, ls, lv, cfg)


def _connect_all(scene: Scene, ev, ls, lv, cfg: BDPTConfig):
    """MIS-weighted sum over every (s, t) connection strategy."""
    em = scene.emitters

    total = jnp.zeros((3,))
    cam_rev = None
    if cfg.with_light_tracing:
        cam_rev = _camera_rev_area_pdf(scene, ev["p"][0], ev["ng"][0])

    for t in range(1, cfg.n_eye + 1):
        xt = ev["p"][t - 1]
        ng_t = ev["ng"][t - 1]
        mat_t = ev["mat"][t - 1]
        beta_t = ev["beta"][t - 1]
        wi_t = ev["wi"][t - 1]
        ok_t = ev["valid"][t - 1]

        # ---- s = 0: the eye path hits an area light ----
        emit = ev["emit"][t - 1]
        le = em.intensity[jnp.maximum(emit, 0)]
        hit_light = ok_t & (emit >= 0) & ev["front"][t - 1]
        l_s0 = jnp.where(hit_light[..., None], beta_t * le, 0.0)
        if t == 1:
            w_s0 = jnp.float32(1.0)  # only strategy for direct hits
        else:
            # pdf of sampling this point from the light side
            area_t = jnp.float32(1.0)  # per-face pmf/area
            # reverse pdfs: position pdf of the light + direction pdf
            e1 = em.tri_e1[jnp.maximum(emit, 0)]
            e2 = em.tri_e2[jnp.maximum(emit, 0)]
            a_face = jnp.maximum(0.5 * jnp.linalg.norm(jnp.cross(e1, e2)),
                                 1e-12)
            pmf_face = em.pmf[jnp.maximum(emit, 0)]
            pt_rev = pmf_face / a_face
            d_prev = ev["prev_p"][t - 1] - xt
            cos_l = jnp.abs(m.dot(ng_t, m.normalize(d_prev)))
            ptm_rev = _area_pdf(cos_l / jnp.pi, d_prev,
                                ev["ng"][t - 2])
            w_s0 = _mis_weight(scene, ls, lv, ev, 0, t, pt_rev, ptm_rev,
                               0.0, 0.0, cfg.n_eye, cfg.n_light,
                               cam_rev_pdf=cam_rev)
        if t >= 2:
            total = total + jnp.where(hit_light[..., None],
                                      w_s0 * l_s0, 0.0)
        elif t == 1:
            total = total + l_s0  # t=1,s=0: direct visible light

        # ---- s = 0, environment: the eye ray escaped at step t-1 and
        # sees the constant-environment radiance. The env vertex is the
        # bounding-sphere hit along the escape direction; its pdfs are
        # the same sphere parameterization _light_start samples from,
        # so the weights close over both families. Statically skipped
        # when the resolved config says the scene has no CONSTANT
        # emitter (ADVICE r04 #3). ----
        include_env = cfg.env_strategies is not False
        env_mode = (cfg.env_strategies
                    if cfg.env_strategies in ("constant", "envmap")
                    else "constant")
        esc = ev["esc"][t - 1]
        d_esc = -ev["wi"][t - 1]
        env_rad = em_mod.env_radiance(em, d_esc)  # CONSTANT + ENVMAP
        l_env = beta_t * env_rad  # beta_t = throughput INTO the step
        if not include_env:
            pass
        elif t == 1:
            total = total + jnp.where(esc[..., None], l_env, 0.0)
        elif env_mode == "envmap":
            # infinite-light (solid-angle) conventions, mirroring the
            # ENVMAP _light_start family: the env vertex's origin pdf
            # is the summed direction density of the environment
            # emitters; its beam reaches x_{t-2} with area density
            # |cos| / (pi r^2) (parallel rays); the eye side's pdf of
            # the env vertex is the stored escape solid-angle pdf
            _, r_env = _bounding_sphere(scene)
            pt_rev_e = em_mod.env_nee_pdf(em, d_esc)
            ptm_rev_e = jnp.abs(m.dot(ev["ng"][t - 2], d_esc)) \
                / (jnp.pi * r_env * r_env)
            ev2 = dict(ev)
            ev2["ng"] = ev["ng"].at[t - 1].set(-d_esc)
            ev2["pdf_fwd"] = ev["pdf_fwd"].at[t - 1].set(
                ev["pdf_fwd_sa"][t - 1])
            ev2["delta"] = ev["delta"].at[t - 1].set(False)
            w_env = _mis_weight(scene, ls, lv, ev2, 0, t, pt_rev_e,
                                ptm_rev_e, 0.0, 0.0, cfg.n_eye,
                                cfg.n_light, cam_rev_pdf=cam_rev)
            ok_env = esc & (pt_rev_e > 0)
            total = total + jnp.where(ok_env[..., None],
                                      w_env * l_env, 0.0)
        else:
            center_e, r_env = _bounding_sphere(scene)
            pmf_env = jnp.sum(
                jnp.where(em.kind == em_mod.CONSTANT, em.pmf, 0.0))
            o_prev = ev["prev_p"][t - 1]  # = x_{t-2}
            oc = o_prev - center_e
            bq = m.dot(oc, d_esc)
            cq = m.length_sq(oc) - r_env * r_env
            t_hit = -bq + jnp.sqrt(jnp.maximum(bq * bq - cq, 1e-9))
            p_env = o_prev + d_esc * jnp.maximum(t_hit, 1e-3)[..., None]
            ng_env = m.normalize(center_e - p_env)  # inward
            pt_rev_e = pmf_env / (4.0 * jnp.pi * r_env * r_env)
            cos_in = jnp.maximum(m.dot(ng_env, -d_esc), 0.0)
            d_prev2 = o_prev - p_env
            ptm_rev_e = _area_pdf(cos_in / jnp.pi, d_prev2,
                                  ev["ng"][t - 2])
            # forward pdf of the escaped segment re-measured on the
            # sphere (the stored area conversion used the carried
            # origin, see _eye_subpath's pdf_fwd_sa note)
            pdf_fwd_env = _area_pdf(ev["pdf_fwd_sa"][t - 1],
                                    p_env - o_prev, ng_env)
            ev2 = dict(ev)
            ev2["p"] = ev["p"].at[t - 1].set(p_env)
            ev2["ng"] = ev["ng"].at[t - 1].set(ng_env)
            ev2["pdf_fwd"] = ev["pdf_fwd"].at[t - 1].set(pdf_fwd_env)
            ev2["delta"] = ev["delta"].at[t - 1].set(False)
            w_env = _mis_weight(scene, ls, lv, ev2, 0, t, pt_rev_e,
                                ptm_rev_e, 0.0, 0.0, cfg.n_eye,
                                cfg.n_light, cam_rev_pdf=cam_rev)
            ok_env = esc & (pmf_env > 0)
            total = total + jnp.where(ok_env[..., None],
                                      w_env * l_env, 0.0)

        # predecessor of xt: the camera for t=1 (its reverse pdf only
        # feeds the excluded t'=1 light-tracing strategy — the eye-side
        # MIS loop is empty at t=1, so the override value is unused)
        ng_prev = ev["ng"][t - 2] if t >= 2 else ng_t

        # ---- s = 1: connect to a fresh point on the light (NEE) ----
        dvec = ls["p0"] - xt
        d2 = jnp.maximum(m.length_sq(dvec), 1e-12)
        dirn_pt = dvec * jax.lax.rsqrt(d2)[..., None]
        # directional: the connection direction is the (delta) beam
        # axis, and visibility runs to a pseudo-point outside the scene
        # along it — NOT toward the sampled disk point
        beam = ls["is_dir"] | ls["is_envm"]
        dirn = jnp.where(beam[..., None], -ls["axis"], dirn_pt)
        vis_b = jnp.where(beam[..., None],
                          xt - ls["axis"] * (2.0 * ls["r_env"]),
                          ls["p0"])
        tau = _visible_tau(scene, xt, vis_b)
        f_eye = bsdf_api.eval_smooth(scene, mat_t, ng_t, wi_t, dirn,
                                     p_world=xt)
        cos_l = jnp.maximum(m.dot(ls["ng0"], -dirn), 0.0)
        # radiance toward xt per kind: area/env sphere carry the
        # geometric cos/d^2, point its 1/d^2 falloff, the beam families
        # (directional, ENVMAP) plain irradiance / solid-angle NEE
        val_area = ls["beta0"] * (cos_l / d2)[..., None]
        val_point = ls["beta0"] / d2[..., None]
        val = jnp.where(ls["use_cos"][..., None], val_area,
                        jnp.where(beam[..., None], ls["beta0"],
                                  val_point))
        l_s1 = beta_t * f_eye * tau * val
        # MIS pdfs for the s=1 connection. Directional: the light
        # generates xt through its disk-position choice — area density
        # pdf_pos projected onto the receiver (pmf/(pi R^2) |cos|).
        # ENVMAP: same parallel-beam geometry but pdf_pos holds the
        # direction density, so the area density at xt is
        # |cos| / (pi r^2) (no pmf — it lives in the y0 origin pdf).
        pt_rev_s1 = jnp.where(
            ls["is_dir"],
            ls["pdf_pos"] * jnp.abs(m.dot(ng_t, ls["axis"])),
            jnp.where(
                ls["is_envm"],
                jnp.abs(m.dot(ng_t, ls["axis"]))
                / (jnp.pi * ls["r_env"] * ls["r_env"]),
                _area_pdf(
                    jnp.where(ls["use_cos"], cos_l / jnp.pi,
                              1.0 / (4 * jnp.pi)),
                    -dvec, ng_t,
                ),
            ),
        )
        d_prev = ev["prev_p"][t - 1] - xt
        ptm_rev_s1 = _area_pdf(
            bsdf_api.pdf_smooth(scene, mat_t, ng_t, dirn,
                                m.normalize(d_prev)),
            d_prev, ng_prev,
        )
        # ENVMAP y0 lives in the solid-angle measure (its origin pdf is
        # a direction density): the eye side's alternative pdf for it
        # is the plain BSDF solid-angle pdf, no area conversion
        qs_sa = bsdf_api.pdf_smooth(scene, mat_t, ng_t, wi_t, dirn)
        qs_rev_s1 = jnp.where(
            ls["is_envm"], qs_sa,
            _area_pdf(qs_sa, dvec, ls["ng0"]),
        )
        w_s1 = _mis_weight(scene, ls, lv, ev, 1, t, pt_rev_s1, ptm_rev_s1,
                           qs_rev_s1, 0.0, cfg.n_eye, cfg.n_light,
                           cam_rev_pdf=cam_rev)
        ok_s1 = ok_t & ls["valid"] & ~ev["delta"][t - 1]
        total = total + jnp.where(ok_s1[..., None], w_s1 * l_s1, 0.0)

        # ---- s >= 2: connect to light subpath surface vertices ----
        for s in range(2, cfg.n_light + 1):
            ys = lv["p"][s - 2]
            ng_s = lv["ng"][s - 2]
            mat_s = lv["mat"][s - 2]
            beta_s = lv["beta"][s - 2]
            wi_s = lv["wi"][s - 2]
            ok_s = lv["valid"][s - 2]

            dvec = ys - xt
            d2 = jnp.maximum(m.length_sq(dvec), 1e-12)
            dirn = dvec * jax.lax.rsqrt(d2)[..., None]
            tau = _visible_tau(scene, xt, ys)
            f_eye = bsdf_api.eval_smooth(scene, mat_t, ng_t, wi_t, dirn,
                                         p_world=xt)
            f_lig = bsdf_api.eval_smooth(scene, mat_s, ng_s, wi_s, -dirn,
                                         p_world=ys)
            # both evals carry their own connection cosine -> G = V/d^2
            l_st = beta_t * f_eye * f_lig * tau * beta_s / d2[..., None]

            pt_rev = _area_pdf(
                bsdf_api.pdf_smooth(scene, mat_s, ng_s, wi_s, -dirn),
                -dvec, ng_t,
            )
            d_prev = ev["prev_p"][t - 1] - xt
            ptm_rev = _area_pdf(
                bsdf_api.pdf_smooth(scene, mat_t, ng_t, dirn,
                                    m.normalize(d_prev)),
                d_prev, ng_prev,
            )
            qs_rev = _area_pdf(
                bsdf_api.pdf_smooth(scene, mat_t, ng_t, wi_t, dirn),
                dvec, ng_s,
            )
            d_prev_l = lv["prev_p"][s - 2] - ys
            qsm_rev = _area_pdf(
                bsdf_api.pdf_smooth(scene, mat_s, ng_s, -dirn,
                                    m.normalize(d_prev_l)),
                d_prev_l, _light_ng(ls, lv, s - 2),
            )
            w_st = _mis_weight(scene, ls, lv, ev, s, t, pt_rev, ptm_rev,
                               qs_rev, qsm_rev, cfg.n_eye, cfg.n_light,
                               cam_rev_pdf=cam_rev)
            ok_st = (ok_t & ok_s & ~ev["delta"][t - 1]
                     & ~lv["delta"][s - 2])
            total = total + jnp.where(ok_st[..., None], w_st * l_st, 0.0)

    return total


def render_bdpt(scene: Scene, key, spp: int = 8,
                cfg: BDPTConfig = BDPTConfig()):
    """Full-frame BDPT render (center rays, like render_volpath).

    Resolves cfg.env_strategies from the concrete scene before jitting
    so area/point-light-only scenes skip the s=0 environment strategy's
    per-prefix MIS block entirely (ADVICE r04 #3)."""
    if not isinstance(scene.emitters.kind, jax.core.Tracer):
        cfg = _resolve_env_strategies(scene, cfg)
    return _render_bdpt_jit(scene, key, spp, cfg)


@partial(jax.jit, static_argnames=("cfg", "spp"))
def _render_bdpt_jit(scene: Scene, key, spp: int = 8,
                     cfg: BDPTConfig = BDPTConfig()):
    cam = scene.camera
    w, h = cam.width, cam.height
    px, py = jnp.meshgrid(jnp.arange(w), jnp.arange(h))
    px = px.reshape(-1)
    py = py.reshape(-1)
    ray_o, ray_d = perspective.sample_ray(cam, px, py)
    n = px.shape[0]
    tile = cfg.ray_tile

    def one_spp(i):
        def tile_fn(args):
            t_idx, o_t, d_t = args
            keys = jax.vmap(
                lambda j: rng.fold(key, i, t_idx, j)
            )(jnp.arange(o_t.shape[0]))
            return jax.vmap(
                lambda o, d, k: li_bdpt(scene, o, d, k, cfg)
            )(o_t, d_t, keys)

        n_tiles = -(-n // tile)
        pad = n_tiles * tile - n
        o_p = jnp.pad(ray_o, ((0, pad), (0, 0)))
        d_p = jnp.pad(ray_d, ((0, pad), (0, 0)), constant_values=1.0)
        li = jax.lax.map(
            tile_fn,
            (jnp.arange(n_tiles),
             o_p.reshape(n_tiles, tile, 3),
             d_p.reshape(n_tiles, tile, 3)),
        )
        return li.reshape(-1, 3)[:n]

    li = jax.lax.map(one_spp, jnp.arange(spp)).mean(axis=0)
    img, wgt = film_mod.splat_box(w, h, px, py, li)
    return film_mod.develop(img, wgt)


# ---------------------------------------------------------------------------
# Light-tracing pass (the t'=0 splat family) with MIS weights — folded
# into the full estimator by render_bdpt_lt.
# ---------------------------------------------------------------------------


def _lt_splat_one(scene: Scene, key, cfg: BDPTConfig):
    """One light subpath; returns per-strategy splat records
    (pixel x/y, MIS-weighted value, on-screen mask) for s = 2..n_light.
    s = 1 (the light itself directly visible) stays with the eye
    pass's unweighted t=1/s=0 strategy (both families cover that
    2-vertex path; exactly one is rendered)."""
    from alvrl_tpu.integrators.ptracer import _camera_splat_value

    ls, lv = _light_subpath(scene, key, cfg.n_light)
    cam_pos = scene.camera.to_world[:3, 3]
    xs, ys_, vals, oks = [], [], [], []
    for s in range(2, cfg.n_light + 1):
        y = lv["p"][s - 2]
        ng_s = lv["ng"][s - 2]
        mat_s = lv["mat"][s - 2]
        beta_s = lv["beta"][s - 2]
        wi_s = lv["wi"][s - 2]
        ok_s = lv["valid"][s - 2] & ~lv["delta"][s - 2] & ls["valid"]
        dc = m.normalize(cam_pos - y)
        f = bsdf_api.eval_smooth(scene, mat_s, ng_s, wi_s, dc, p_world=y)
        x_pix, y_pix, value, on = _camera_splat_value(
            scene, y, f * beta_s)
        # MIS: alternatives re-generate this path with the eye side
        # absorbing y_{s-1} (camera pdf) and y_{s-2} (BSDF pdf at
        # y_{s-1} with the camera direction incoming)
        qs_rev = _camera_rev_area_pdf(scene, y, ng_s)
        d_prev = lv["prev_p"][s - 2] - y
        qsm_rev = _area_pdf(
            bsdf_api.pdf_smooth(scene, mat_s, ng_s, dc,
                                m.normalize(d_prev)),
            d_prev, _light_ng(ls, lv, s - 2),
        )
        w = _mis_weight(scene, ls, lv, None, s, 0, 0.0, 0.0,
                        qs_rev, qsm_rev, cfg.n_eye, cfg.n_light)
        xs.append(x_pix)
        ys_.append(y_pix)
        vals.append(w * value)
        oks.append(ok_s & on)
    return (jnp.stack(xs), jnp.stack(ys_), jnp.stack(vals),
            jnp.stack(oks))


def render_bdpt_lt(scene: Scene, key, spp: int = 8,
                   cfg: BDPTConfig = BDPTConfig(),
                   num_particles: int = None):
    """Full BDPT including the light-tracing family: the eye pass with
    with_light_tracing MIS weights plus the lens-splat pass with the
    complementary weights (normalized per particle, the ptracer
    convention validated against volpath)."""
    if not isinstance(scene.emitters.kind, jax.core.Tracer):
        cfg = _resolve_env_strategies(scene, cfg)
    return _render_bdpt_lt_jit(scene, key, spp, cfg, num_particles)


@partial(jax.jit, static_argnames=("cfg", "spp", "num_particles"))
def _render_bdpt_lt_jit(scene: Scene, key, spp: int = 8,
                        cfg: BDPTConfig = BDPTConfig(),
                        num_particles: int = None):
    cfg_lt = cfg.replace(with_light_tracing=True)
    cam = scene.camera
    w, h = cam.width, cam.height
    if num_particles is None:
        num_particles = w * h * spp // 2
    k_eye, k_lt = jax.random.split(key)
    img_eye = render_bdpt(scene, k_eye, spp, cfg_lt)

    keys = jax.random.split(k_lt, num_particles)
    xs, ys_, vals, oks = jax.vmap(
        lambda k: _lt_splat_one(scene, k, cfg_lt))(keys)
    px = jnp.clip(xs.reshape(-1).astype(jnp.int32), 0, w - 1)
    py = jnp.clip(ys_.reshape(-1).astype(jnp.int32), 0, h - 1)
    v = vals.reshape(-1, 3)
    ok = oks.reshape(-1)
    img_lt = jnp.zeros((h, w, 3))
    img_lt = img_lt.at[py, px].add(jnp.where(ok[..., None], v, 0.0))
    return img_eye + img_lt / num_particles
