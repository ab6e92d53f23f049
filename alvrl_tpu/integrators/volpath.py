"""Volumetric path tracer + the VRL ground-truth oracle.

Counterpart of the branch-modified `volpath` plugin
(src/integrators/path/volpath.cpp:76-460). With default flags it is the
reference's VRL-validation oracle: a volumetric path tracer restricted to
exactly the path family the VRL integrator produces
(`onlyVRLpaths`/`vrlVolToVol`/`vrlVolToSurf`/`onlySingleScatter`),
so an equal-transport A/B against the VRL renderer is the correctness
test (SURVEY §4). With only_vrl_paths=False it is a standard volumetric
path tracer with next-event estimation (the `volpath` component).

Gating semantics are reproduced exactly as coded — including the C++
operator-precedence quirk `!rRec.depth==2` (volpath.cpp:144-190) which
makes the "previous vertex must be volume/diffuse" gate apply at *every*
depth >= 2, not only at depth 2. We must match the code, not the intent,
since this defines the family being compared.

Array design: one lax.scan over bounce depth, vmapped over rays; all
per-vertex branching is masked arithmetic.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from alvrl_tpu.core import struct

from alvrl_tpu.core import math as m
from alvrl_tpu.core import rng
from alvrl_tpu.film import film as film_mod
from alvrl_tpu.geometry import intersect
from alvrl_tpu.integrators.vrl.integrate import eval_transmittance_between
from alvrl_tpu.media import api as mapi
from alvrl_tpu.media import phase as ph
from alvrl_tpu.scene.scene import Scene
from alvrl_tpu.sensors import perspective


@struct.dataclass
class VolpathConfig:
    max_depth: int = struct.field(pytree_node=False, default=16)
    rr_depth: int = struct.field(pytree_node=False, default=5)
    only_vrl_paths: bool = struct.field(pytree_node=False, default=True)
    vrl_vol_to_vol: bool = struct.field(pytree_node=False, default=True)
    vrl_vol_to_surf: bool = struct.field(pytree_node=False, default=True)
    single_scatter: bool = struct.field(pytree_node=False, default=False)
    # extra walk iterations for null-boundary pass-throughs (which do
    # not consume depth) in scenes with per-shape nested media
    null_crossings: int = struct.field(pytree_node=False, default=8)
    # emitter MIS (the reference volpath's miWeight between NEE and
    # BSDF/phase sampling); active only for the plain tracer — the
    # onlyVRLpaths oracle keeps its validated single-strategy gating
    mis: bool = struct.field(pytree_node=False, default=True)
    # ERadianceNoEmission: drop directly-visible (depth-1) emission —
    # used by callers that account for it separately (the irradiance
    # cache's gather rays, irrcache.cpp:311-312)
    first_emission: bool = struct.field(pytree_node=False, default=True)


def _nee_point_light(scene: Scene, key, p, med_id=None):
    """Next-event estimation against the emitter table: returns
    (direction (3,), attenuated value (3,), nee solid-angle pdf,
    misable). Counterpart of Scene::sampleAttenuatedEmitterDirect;
    pdf/misable feed the MIS weights (delta emitters: pdf 0, weight 1
    since BSDF/phase sampling cannot hit them). `med_id` is the medium
    at p when the scene uses per-shape nested media."""
    from alvrl_tpu.emitters import emitters as em_mod

    lo, hi = scene.aabb()
    radius = 0.5 * jnp.linalg.norm(hi - lo)
    u3 = rng.uniform(key, (3,))
    dirn, val, dist, pdf_sa, misable = em_mod.nee_u_pdf(
        scene.emitters, u3, p, radius)
    endpoint = p + dist[..., None] * dirn
    if scene.media is not None:
        from alvrl_tpu.media import table as mtbl

        tau = mtbl.eval_transmittance_nested(
            scene, p, endpoint,
            jnp.int32(0) if med_id is None else med_id,
        )
    else:
        tau = eval_transmittance_between(scene, p, endpoint)
    return dirn, val * tau, pdf_sa, misable


def li_volpath(scene: Scene, ray_o, ray_d, key, cfg: VolpathConfig):
    """Radiance for a single eye ray (vmap over a batch externally).

    When scene.media is set (per-shape nested media, media/table.py)
    the walker tracks its current medium id and every surface event
    switches it to the interior/exterior medium of the crossed face —
    the reference's per-shape medium references + the null-interface
    medium switching of Scene::evalTransmittance."""
    nested = scene.media is not None
    use_mis = cfg.mis and not cfg.only_vrl_paths
    if use_mis:
        from alvrl_tpu.bsdf import api as bsdf_api_mis
        from alvrl_tpu.emitters import emitters as em_mis
    if nested:
        from alvrl_tpu.media import table as mtbl
    # oriented grid media (kkay/microflake) look up a local fiber
    # direction at every medium vertex
    oriented = (not nested) and (not mapi.is_homogeneous(scene.medium)) \
        and scene.medium.phase_kind in (ph.KKAY, ph.MICROFLAKE)
    if oriented:
        from alvrl_tpu.media import heterogeneous as gmed

    state = dict(
        ray_o=ray_o,
        ray_d=ray_d,
        throughput=jnp.ones((3,)),
        li=jnp.zeros((3,)),
        depth=jnp.int32(1),
        eta=jnp.float32(1.0),
        active=jnp.bool_(True),
        first_ok=jnp.bool_(not cfg.only_vrl_paths),
        second_ok=jnp.bool_(not cfg.only_vrl_paths),
        prev_volume=jnp.bool_(False),
        prev_diffuse=jnp.bool_(False),
        med_id=jnp.int32(0),
        prev_pdf=jnp.float32(0.0),
        prev_delta=jnp.bool_(True),  # camera vertex: no NEE preceded
    )

    def step(state, k):
        k_dist, k_nee, k_phase, k_bsdf, k_rr, k_spec = jax.random.split(k, 6)
        depth = state["depth"]
        # explicit depth bound: with nested media the scan runs longer
        # than max_depth (null crossings are free), so the depth budget
        # must terminate lanes itself
        active = state["active"] & (depth <= cfg.max_depth)
        med = (mtbl.medium_at(scene.media, state["med_id"]) if nested
               else scene.medium)

        # onlyVRLpaths early exit (volpath.cpp:148-149)
        if cfg.only_vrl_paths:
            active = active & ~(
                (depth > 2) & ~(state["first_ok"] & state["second_ok"])
            )

        hit = intersect.intersect_all(
            state["ray_o"], state["ray_d"], scene.vertices, scene.faces
        )
        # Sanitize the miss case: hit.p would be o + inf*d (inf/NaN) and
        # poison masked arithmetic downstream.
        hit_p = jnp.where(hit.valid[..., None], hit.p, state["ray_o"])
        dist_surf = jnp.where(hit.valid, hit.t, jnp.float32(1e30))
        ms = mapi.sample_distance_seg(
            med, k_dist, state["ray_o"], state["ray_d"], dist_surf
        )

        medium_event = ms.success & active
        surface_event = (~ms.success) & hit.valid & active
        escape = (~ms.success) & (~hit.valid) & active

        # environment radiance on escape (volpath.cpp:277-289): gated by
        # first&&second under onlyVRLpaths; attenuated by the medium
        # (w_pass is tau/pdfFailure over the escape segment)
        from alvrl_tpu.emitters.emitters import env_radiance

        env_l = env_radiance(scene.emitters, state["ray_d"])
        # emission queries are dropped after the first scatter
        # (ERadianceNoEmission) — NEE covers the env beyond depth 1
        env_gate = escape & (depth == 1)
        w_env = jnp.float32(1.0)
        if cfg.only_vrl_paths:
            env_gate = escape & state["first_ok"] & state["second_ok"]
        elif use_mis:
            # MIS against env NEE: emission is counted at EVERY depth,
            # weighted by the sampling-strategy balance (volpath.cpp's
            # miWeight on the escaped ray)
            env_gate = escape
            p_env = em_mis.env_nee_pdf(scene.emitters, state["ray_d"])
            w_env = jnp.where(
                state["prev_delta"] | (depth == 1), 1.0,
                state["prev_pdf"]
                / jnp.maximum(state["prev_pdf"] + p_env, 1e-30),
            )
        if not cfg.first_emission:
            env_gate = env_gate & (depth != 1)
        li_env = jnp.where(
            env_gate[..., None],
            state["throughput"] * ms.w_pass * env_l * w_env,
            0.0,
        )

        # ---------------- medium vertex ------------------------------
        # Sanitize: at non-medium events ms.p carries the 3e30 no-
        # interaction sentinel; squaring it in NEE distances overflows
        # to inf and the masked NaN poisons reverse-mode (0 * NaN).
        p_med = jnp.where(medium_event[..., None], ms.p, state["ray_o"])
        first_ok_med = state["first_ok"] | (
            (depth == 1) & jnp.bool_(cfg.vrl_vol_to_vol)
        )
        second_ok_med = state["second_ok"] | (depth == 2)
        tp_med = state["throughput"] * ms.w_scatter

        # luminaire sampling at the medium vertex
        nee_dir, nee_val, p_nee_m, misable_m = _nee_point_light(
            scene, k_nee, p_med,
            med_id=state["med_id"] if nested else None,
        )
        orient = gmed.lookup_orientation(med, p_med) if oriented else None
        pp = med.phase_params  # mixture/oriented params; None otherwise
        phase_val = ph.eval_phase(
            med.phase_kind, med.g, -state["ray_d"], nee_dir,
            orientation=orient, pp=pp,
        )
        if use_mis:
            p_dir_m = ph.pdf_phase(
                med.phase_kind, med.g, -state["ray_d"], nee_dir,
                orientation=orient, pp=pp,
            )
            w_nee_m = jnp.where(
                misable_m,
                p_nee_m / jnp.maximum(p_nee_m + p_dir_m, 1e-30), 1.0)
        else:
            w_nee_m = jnp.float32(1.0)
        nee_contrib = tp_med * nee_val * (phase_val * w_nee_m)[..., None]
        if cfg.only_vrl_paths:
            prev_gate = (
                (state["prev_volume"] | state["prev_diffuse"])
                & (~state["prev_diffuse"] | jnp.bool_(cfg.vrl_vol_to_surf))
                & (~state["prev_volume"] | jnp.bool_(cfg.vrl_vol_to_vol))
            )
            nee_ok_med = (depth != 1) & prev_gate
        else:
            nee_ok_med = jnp.bool_(True)
        if cfg.single_scatter:
            # single-scatter mode: EIndirectMediumRadiance stripped at the
            # first medium vertex, so only depth-1 NEE survives
            nee_ok_med = nee_ok_med & (depth == 1)
        # direct-radiance query type is cleared after the first scatter
        # in the standard tracer only via ERadianceNoEmission (emission
        # queries; NEE stays on), so no extra gate here.
        li_med = jnp.where(
            (medium_event & nee_ok_med)[..., None], nee_contrib, 0.0
        )

        # phase sampling for continuation
        u_sir = (jax.random.uniform(k_phase, (16, 3))
                 if oriented and med.phase_kind == ph.MICROFLAKE else None)
        wo_phase, w_phase, pdf_phase_s = ph.sample_phase(
            med.phase_kind, med.g, -state["ray_d"], rng.uniform2(k_phase),
            orientation=orient, pp=pp, u_sir=u_sir,
        )
        tp_med_cont = tp_med * w_phase[..., None]
        med_continue = medium_event & ~jnp.bool_(cfg.single_scatter)

        # ---------------- surface vertex -----------------------------
        tp_surf_pre = state["throughput"] * ms.w_pass
        mat_id = scene.material[jnp.maximum(hit.prim, 0)]

        # emitted radiance on a direct hit of an area emitter: counted
        # only at depth 1 (after any scattering the query drops emission,
        # ERadianceNoEmission — volpath.cpp:262-263,293-296); under
        # onlyVRLpaths it is additionally gated by first&&second OK
        # (volpath.cpp:152-156), which can never hold at depth 1.
        emit_id = scene.face_emitter[jnp.maximum(hit.prim, 0)]
        front = m.dot(hit.ng_raw, -state["ray_d"]) > 0
        le_gate = surface_event & (emit_id >= 0) & front & (depth == 1)
        w_hit = jnp.float32(1.0)
        if cfg.only_vrl_paths:
            le_gate = le_gate & state["first_ok"] & state["second_ok"]
        elif use_mis:
            # count emission at every depth, MIS-weighted against the
            # NEE strategy that could have sampled the same segment
            le_gate = surface_event & (emit_id >= 0) & front
            cos_face = jnp.maximum(m.dot(hit.ng_raw, -state["ray_d"]),
                                   1e-6)
            p_nee_hit = em_mis.hit_emitter_nee_pdf(
                scene.emitters, emit_id, hit.t, cos_face)
            w_hit = jnp.where(
                state["prev_delta"] | (depth == 1), 1.0,
                state["prev_pdf"]
                / jnp.maximum(state["prev_pdf"] + p_nee_hit, 1e-30),
            )
        if not cfg.first_emission:
            le_gate = le_gate & (depth != 1)
        le_val = scene.emitters.intensity[jnp.maximum(emit_id, 0)]
        li_emit = jnp.where(
            le_gate[..., None], tp_surf_pre * le_val * w_hit, 0.0
        )

        # luminaire sampling at the surface (smooth BSDFs only)
        from alvrl_tpu.bsdf import api as bsdf_api
        from alvrl_tpu.integrators.vrl.integrate import bsdf_eval_smooth
        from alvrl_tpu.textures.procedural import interp_uv

        uv_tex = interp_uv(scene.face_uv, hit.prim, hit.uv)
        if nested:
            # the NEE segment leaves the surface on the light's side
            lo_s, hi_s = scene.aabb()
            rad_s = 0.5 * jnp.linalg.norm(hi_s - lo_s)
            from alvrl_tpu.emitters import emitters as em_mod_

            probe_dir, _, _ = em_mod_.nee(
                scene.emitters, k_nee, hit_p, rad_s
            )
            med_surf = mtbl.medium_after_surface(
                scene, jnp.maximum(hit.prim, 0), probe_dir
            )
        nee_dir_s, nee_val_s, p_nee_s, misable_s = _nee_point_light(
            scene, k_nee, hit_p,
            med_id=med_surf if nested else None,
        )
        bsdf_val = bsdf_eval_smooth(
            scene, mat_id, hit.ng, -state["ray_d"], nee_dir_s,
            p_world=hit_p, uv=uv_tex,
        )
        if use_mis:
            p_dir_s = bsdf_api_mis.pdf_smooth(
                scene, mat_id, hit.ng, -state["ray_d"], nee_dir_s,
                uv=uv_tex)
            w_nee_s = jnp.where(
                misable_s,
                p_nee_s / jnp.maximum(p_nee_s + p_dir_s, 1e-30), 1.0)
            bsdf_val = bsdf_val * w_nee_s[..., None]
        # BSDF sampling through the central material dispatch (delta
        # lobes draw from the same key tree; k_spec is retired)
        smp = bsdf_api.sample(
            scene, k_bsdf, mat_id, hit.ng, hit.ng_raw, state["ray_d"],
            hit_p, mode="radiance", uv=uv_tex,
        )
        del k_spec
        wo_bsdf, w_bsdf = smp.wo, smp.weight
        is_delta, is_smooth = smp.is_delta, smp.is_smooth

        nee_ok_surf = is_smooth
        if cfg.only_vrl_paths:
            nee_ok_surf = nee_ok_surf & state["first_ok"] & state["second_ok"]
        li_surf = jnp.where(
            (surface_event & nee_ok_surf)[..., None],
            tp_surf_pre * nee_val_s * bsdf_val,
            0.0,
        )

        eta_ratio = smp.eta_ratio
        tp_surf_cont = tp_surf_pre * w_bsdf
        surf_continue = (
            surface_event & smp.valid & ~jnp.all(w_bsdf == 0.0)
        )

        first_ok_surf = state["first_ok"] | (
            jnp.bool_(cfg.vrl_vol_to_surf) & (depth == 1) & is_smooth
        )

        # ---------------- merge --------------------------------------
        li = state["li"] + li_med + li_surf + li_emit + li_env
        new_o = jnp.where(medium_event[..., None], p_med, hit_p)
        new_d = jnp.where(medium_event[..., None], wo_phase, wo_bsdf)
        new_tp = jnp.where(
            medium_event[..., None], tp_med_cont, tp_surf_cont
        )
        survive = med_continue | surf_continue
        survive = survive & ~escape

        first_ok = jnp.where(
            medium_event, first_ok_med,
            jnp.where(surface_event, first_ok_surf, state["first_ok"]),
        )
        new_eta = jnp.where(
            surface_event & is_delta, state["eta"] * eta_ratio, state["eta"]
        )
        # 'undo' initial specular vertices (volpath.cpp:377-380): a delta
        # bounce at depth 1 does not advance the depth counter; null
        # boundary pass-throughs never do (they are medium interfaces,
        # not scattering events — Scene::evalTransmittance semantics)
        from alvrl_tpu.scene.scene import NULL as _NULL

        is_null_mat = scene.materials.kind[mat_id] == _NULL
        depth_inc = jnp.where(
            surface_event & (
                is_null_mat | (is_delta & (depth == 1))
            ), 0, 1,
        )
        second_ok = jnp.where(medium_event, second_ok_med, state["second_ok"])
        prev_volume = jnp.where(
            medium_event, True, jnp.where(surface_event, False, state["prev_volume"])
        )
        prev_diffuse = jnp.where(
            surface_event, is_smooth,
            jnp.where(medium_event, False, state["prev_diffuse"]),
        )

        # Russian roulette (volpath.cpp:443-452)
        # q is an importance denominator -> detached (detached-
        # sampling estimator; also keeps 1/q residuals off dead lanes)
        q = jax.lax.stop_gradient(
            jnp.minimum(jnp.max(new_tp) * new_eta ** 2, 0.95))
        do_rr = depth >= cfg.rr_depth
        u = rng.uniform(k_rr)
        rr_kill = do_rr & (u >= q)
        rr_scale = jnp.where(do_rr & ~rr_kill, 1.0 / jnp.maximum(q, 1e-30), 1.0)
        survive = survive & ~rr_kill

        if nested:
            med_after = mtbl.medium_after_surface(
                scene, jnp.maximum(hit.prim, 0), new_d
            )
            new_med_id = jnp.where(
                surface_event, med_after, state["med_id"]
            )
        else:
            new_med_id = state["med_id"]

        if use_mis:
            p_fwd_s = bsdf_api_mis.pdf_smooth(
                scene, mat_id, hit.ng, -state["ray_d"], wo_bsdf,
                uv=uv_tex)
            new_prev_pdf = jnp.where(
                medium_event, pdf_phase_s,
                jnp.where(surface_event, p_fwd_s, state["prev_pdf"]))
            new_prev_delta = jnp.where(
                medium_event, False,
                jnp.where(surface_event, is_delta,
                          state["prev_delta"]))
        else:
            new_prev_pdf = state["prev_pdf"]
            new_prev_delta = state["prev_delta"]

        new_state = dict(
            ray_o=new_o,
            ray_d=new_d,
            throughput=new_tp * rr_scale,
            li=li,
            depth=depth + depth_inc,
            eta=new_eta,
            active=survive,
            first_ok=first_ok,
            second_ok=second_ok,
            prev_volume=prev_volume,
            prev_diffuse=prev_diffuse,
            med_id=new_med_id,
            prev_pdf=new_prev_pdf,
            prev_delta=new_prev_delta,
        )
        # Freeze everything except li on inactive lanes.
        froze = jax.tree_util.tree_map(
            lambda n, o: jnp.where(_bmask(active, n), n, o), new_state, state
        )
        froze["li"] = li  # li accumulations are already masked by events
        return froze, None

    n_steps = cfg.max_depth + (cfg.null_crossings if nested else 0)
    keys = jax.random.split(key, n_steps)
    final, _ = jax.lax.scan(step, state, keys)

    li = final["li"]
    if cfg.only_vrl_paths:
        li = jnp.where(final["first_ok"] & final["second_ok"], li, 0.0)
    return li


def _bmask(mask, arr):
    extra = arr.ndim - mask.ndim
    return mask.reshape(mask.shape + (1,) * extra)


@partial(jax.jit, static_argnames=("cfg", "spp", "ray_tile"))
def render_volpath(scene: Scene, key, spp: int = 16, cfg: VolpathConfig = VolpathConfig(), ray_tile: int = 4096):
    """Render with the (restricted) volumetric path tracer, `spp` samples
    per pixel at pixel centers (matching the VRL renderer's deterministic
    center rays so images are comparable per-pixel)."""
    from alvrl_tpu.media import api as _mapi

    scene = _mapi.prepare_scene(scene)
    cam = scene.camera
    w, h = cam.width, cam.height
    px, py = jnp.meshgrid(jnp.arange(w), jnp.arange(h))
    px = px.reshape(-1)
    py = py.reshape(-1)
    ray_o, ray_d = perspective.sample_ray(cam, px, py)
    n = px.shape[0]

    def one_spp(i):
        def tile_fn(args):
            t_idx, o_t, d_t = args
            keys = jax.vmap(
                lambda j: rng.fold(key, i, t_idx, j)
            )(jnp.arange(o_t.shape[0]))
            return jax.vmap(
                lambda o, d, k: li_volpath(scene, o, d, k, cfg)
            )(o_t, d_t, keys)

        n_tiles = -(-n // ray_tile)
        pad = n_tiles * ray_tile - n
        o_p = jnp.pad(ray_o, ((0, pad), (0, 0)))
        d_p = jnp.pad(ray_d, ((0, pad), (0, 0)), constant_values=1.0)
        li = jax.lax.map(
            tile_fn,
            (
                jnp.arange(n_tiles),
                o_p.reshape(n_tiles, ray_tile, 3),
                d_p.reshape(n_tiles, ray_tile, 3),
            ),
        )
        return li.reshape(-1, 3)[:n]

    li = jax.lax.map(one_spp, jnp.arange(spp)).mean(axis=0)
    img, wgt = film_mod.splat_box(w, h, px, py, li)
    return film_mod.develop(img, wgt)
