"""VRL generation by volumetric photon tracing.

Array-native counterpart of vrlTracer (src/integrators/vrl/vrlTracer.h):
the reference traces particles *serially on the master* until
vrlTargetNum VRLs are stored (vrlTracer.h:13-52) — a known scalability
gap. Here `trace` runs a fixed budget of particles as one vmapped
`lax.scan` over bounce depth: every particle advances its random walk in
lockstep, emitting at most one VRL per (particle, depth) slot into a
fixed-capacity buffer.

Per-step semantics mirror traceOneParticle (vrlTracer.h:91-230):
  * sample emitter position + uniform-sphere direction
    (point.cpp:82-112: weight = intensity * 4pi);
  * alternate medium-distance sampling vs surface hits;
  * a medium scatter multiplies throughput by
    transmittance * sigma_s / pdfSuccess and a phase sample (weight 1),
    ends the current VRL (short: at the scatter point; long: at the next
    surface) and starts a new one at the scatter point;
  * a surface hit multiplies by transmittance / pdfFailure and the BSDF
    sample weight, ends the current VRL at the surface and starts a new
    one there;
  * Russian roulette after rr_depth with q = min(max(tp) * eta^2, 0.95).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from alvrl_tpu.core import struct

from alvrl_tpu.core import math as m
from alvrl_tpu.core import rng
from alvrl_tpu.geometry import intersect
from alvrl_tpu.integrators.vrl.vrl import VRLs
from alvrl_tpu.media import api as mapi
from alvrl_tpu.media import phase as ph
from alvrl_tpu.scene.scene import Scene


@struct.dataclass
class TracerConfig:
    max_depth: int = struct.field(pytree_node=False, default=16)
    rr_depth: int = struct.field(pytree_node=False, default=5)
    short_vrls: bool = struct.field(pytree_node=False, default=True)
    # Score-function surrogate for the phase-sampling distribution's
    # parameter dependence: multiply the throughput by
    # phase(g; wi, wo)/stop_grad(phase(...)) at each phase sample. The
    # factor is 1 in value; its derivative is d/dg log phase — exactly
    # the REINFORCE term the detached-sampling estimator drops (HG
    # sampling is a perfect importance sampler, so the g-dependence
    # lives entirely in the sampling distribution). Combined with the
    # detached free-flight weights (media/api.py) this makes the FULL
    # trace->render pipeline gradient unbiased for sigma_a/sigma_s/g/
    # intensity, with sampled geometry (positions, directions) detached
    # for stability (the pathwise chains measured to explode).
    score_phase: bool = struct.field(pytree_node=False, default=True)


def _sample_emission(scene: Scene, key):
    """Sample an emission event: emitter by pmf, then a position and
    direction per emitter kind (alvrl_tpu.emitters.emitters)."""
    from alvrl_tpu.emitters import emitters as em_mod

    lo, hi = scene.aabb()
    center = 0.5 * (lo + hi)
    radius = 0.5 * jnp.linalg.norm(hi - lo)
    return em_mod.sample_emission(scene.emitters, key, center, radius)


def _sample_bsdf_importance(scene: Scene, key, mat_id, ng, ng_raw, wi, p,
                            uv=None):
    """Sample the BSDF at a surface hit in importance-transport mode
    (EImportance: dielectric refraction carries NO 1/eta^2 factor —
    dielectric.cpp applies it to ERadiance only). Thin wrapper over the
    central material dispatch (alvrl_tpu.bsdf.api.sample).
    Returns (wo_world, weight(3,), eta_ratio, valid)."""
    from alvrl_tpu.bsdf import api as bsdf_api

    s = bsdf_api.sample(scene, key, mat_id, ng, ng_raw, wi, p,
                        mode="importance", uv=uv)
    return s.wo, s.weight, s.eta_ratio, s.valid


from functools import partial


@partial(jax.jit, static_argnames=("num_particles", "cfg"))
def trace(scene: Scene, key, num_particles: int, cfg: TracerConfig = TracerConfig()) -> VRLs:
    """Trace `num_particles` light paths; returns a VRLs buffer with
    capacity num_particles * max_depth (masked)."""
    keys = jax.random.split(key, num_particles)
    starts, ends, powers, valids = jax.vmap(
        lambda k: _trace_one(scene, k, cfg)
    )(keys)
    flat = lambda a: a.reshape((-1,) + a.shape[2:])
    return VRLs(
        start=flat(starts),
        end=flat(ends),
        power=flat(powers),
        valid=flat(valids),
        particle_count=jnp.float32(num_particles),
    )


def _trace_one(scene: Scene, key, cfg: TracerConfig):
    """One particle's bounded random walk, as a lax.scan over depth.

    Emits per-depth VRL slots (start, end, power, valid)."""
    k_emit, k_walk = jax.random.split(key)
    pos, d, weight = _sample_emission(scene, k_emit)

    med = scene.medium

    state = dict(
        ray_o=pos,
        ray_d=d,
        cur_start=pos,
        cur_power=weight,          # beta of the VRL being built
        beta=weight,               # throughput * emitted power
        tp=jnp.ones((3,)),         # unitless throughput (for RR)
        eta=jnp.float32(1.0),
        active=~jnp.all(weight == 0.0),
    )

    def step(state, inp):
        depth, k = inp
        k_dist, k_phase, k_bsdf, k_rr = jax.random.split(k, 4)

        hit = intersect.intersect_all(
            state["ray_o"], state["ray_d"], scene.vertices, scene.faces
        )
        # sanitize the miss case (o + inf*d) so masked lanes stay finite
        hit = hit._replace(
            p=jnp.where(hit.valid[..., None], hit.p, state["ray_o"])
        )
        dist_surf = jnp.where(hit.valid, hit.t, jnp.float32(1e30))
        ms = mapi.sample_distance_seg(
            med, k_dist, state["ray_o"], state["ray_d"], dist_surf
        )

        active = state["active"]
        medium_event = ms.success & active
        surface_event = (~ms.success) & hit.valid & active

        # --- medium scattering ---------------------------------------
        # sanitize the no-interaction sentinel position (reverse-mode
        # 0 * NaN poisoning through masked distance math — see volpath)
        p_scatter = jnp.where(medium_event[..., None], ms.p,
                              state["ray_o"])
        factor_med = ms.w_scatter
        wo_phase, w_phase, _ = ph.sample_phase(
            med.phase_kind, med.g, -state["ray_d"], rng.uniform2(k_phase),
            pp=med.phase_params,
        )
        # geometry detached: the sampled direction's pathwise d(wo)/dg
        # chain is replaced by the score surrogate below
        wo_phase = jax.lax.stop_gradient(wo_phase)
        if cfg.score_phase and med.phase_kind == ph.HG:
            ph_val = ph.eval_phase(
                med.phase_kind, med.g, -state["ray_d"], wo_phase,
                pp=med.phase_params)
            ratio = ph_val / jax.lax.stop_gradient(
                jnp.maximum(ph_val, 1e-30))
            w_phase = w_phase * ratio
        beta_med = state["beta"] * factor_med * w_phase[..., None]
        tp_med = state["tp"] * factor_med * w_phase[..., None]
        if cfg.short_vrls:
            endpoint = p_scatter
            med_store_ok = jnp.bool_(True)
        else:
            endpoint = hit.p
            med_store_ok = hit.valid  # long VRLs abort on infinite segments
                                      # (vrlTracer.h:159-166)

        # --- surface scattering --------------------------------------
        factor_surf = ms.w_pass
        mat_id = scene.material[jnp.maximum(hit.prim, 0)]
        from alvrl_tpu.textures.procedural import interp_uv

        uv_tex = interp_uv(scene.face_uv, hit.prim, hit.uv)
        wo_bsdf, w_bsdf, eta_ratio, bsdf_valid = _sample_bsdf_importance(
            scene, k_bsdf, mat_id, hit.ng, hit.ng_raw, state["ray_d"],
            hit.p, uv=uv_tex,
        )
        beta_surf = state["beta"] * factor_surf * w_bsdf
        tp_surf = state["tp"] * factor_surf * w_bsdf
        bsdf_dead = surface_event & (~bsdf_valid | jnp.all(w_bsdf == 0.0))

        # --- store the VRL ending at this event ----------------------
        store_end = jnp.where(medium_event[..., None], endpoint, hit.p)
        seg_len = m.distance(state["cur_start"], store_end)
        store = (
            (medium_event & med_store_ok) | surface_event
        ) & (seg_len > 0.0) & ~jnp.all(state["cur_power"] == 0.0)
        out = dict(
            start=state["cur_start"],
            end=store_end,
            power=state["cur_power"],
            valid=store,
        )

        # --- next state ----------------------------------------------
        # positions/directions detached (detached-sampling contract;
        # powers and the score surrogates carry all theta dependence)
        new_o = jax.lax.stop_gradient(
            jnp.where(medium_event[..., None], p_scatter, hit.p))
        new_d = jax.lax.stop_gradient(
            jnp.where(medium_event[..., None], wo_phase, wo_bsdf))
        new_beta = jnp.where(medium_event[..., None], beta_med, beta_surf)
        new_tp = jnp.where(medium_event[..., None], tp_med, tp_surf)
        survive = (medium_event & med_store_ok) | (surface_event & ~bsdf_dead)

        new_eta = jnp.where(surface_event, state["eta"] * eta_ratio, state["eta"])
        # Russian roulette (vrlTracer.h:218-228)
        q = jax.lax.stop_gradient(
            jnp.minimum(jnp.max(new_tp) * new_eta ** 2, 0.95))
        do_rr = depth >= cfg.rr_depth
        u = rng.uniform(k_rr)
        rr_kill = do_rr & (u >= q)
        rr_scale = jnp.where(do_rr & ~rr_kill, 1.0 / jnp.maximum(q, 1e-30), 1.0)
        survive = survive & ~rr_kill

        new_state = dict(
            ray_o=new_o,
            ray_d=new_d,
            cur_start=new_o,
            cur_power=new_beta * rr_scale,
            beta=new_beta * rr_scale,
            tp=new_tp * rr_scale,
            eta=new_eta,
            active=survive,
        )
        # Freeze state on lanes that were already inactive this step.
        new_state = jax.tree_util.tree_map(
            lambda n, o: jnp.where(_bmask(active, n), n, o), new_state, state
        )
        return new_state, out

    depths = jnp.arange(1, cfg.max_depth + 1)
    step_keys = jax.random.split(k_walk, cfg.max_depth)
    _, outs = jax.lax.scan(step, state, (depths, step_keys))
    return outs["start"], outs["end"], outs["power"], outs["valid"]


def _bmask(mask, arr):
    """Broadcast a scalar/batch bool mask against arr's trailing dims."""
    extra = arr.ndim - mask.ndim
    return mask.reshape(mask.shape + (1,) * extra)
