"""PSSMLT — primary-sample-space Metropolis light transport.

Counterpart of src/integrators/pssmlt/ (Kelemen et al. 2002 as
implemented by the reference). The path integral is reparameterized
over the primary sample cube [0,1]^D: a deterministic map turns a
fixed-length uniform vector into an eye path (same estimator family as
the `volpath` tracer with NEE at every vertex — homogeneous media,
the full material table via bsdf.api.sample_from_uniforms). A Markov
chain mutates the vector with Kelemen's symmetric log-exponential
small steps plus large-step restarts; acceptance is the luminance
ratio; both states deposit luminance-normalized contributions.

Array design: the reference runs a handful of chains on worker threads
(pssmlt_proc.cpp); here MANY independent chains advance in lockstep —
one vmap over chains, one lax.scan over mutations, film deposits by
segment_sum — turning an inherently sequential algorithm into a wide
data-parallel one. The normalization constant b = E[I] is estimated
from the large-step proposals (the standard Kelemen estimator).

Media note: restricted to homogeneous media — Woodcock tracking
consumes a data-dependent number of uniforms and has no fixed-dim
primary-sample mapping (media.api.sample_distance_seg_u raises).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from alvrl_tpu.core import struct

from alvrl_tpu.bsdf import api as bsdf_api
from alvrl_tpu.core import math as m
from alvrl_tpu.core import spectrum
from alvrl_tpu.emitters import emitters as em_mod
from alvrl_tpu.geometry import intersect
from alvrl_tpu.integrators.vrl.integrate import eval_transmittance_between
from alvrl_tpu.media import api as mapi
from alvrl_tpu.media import phase as ph
from alvrl_tpu.scene.scene import Scene
from alvrl_tpu.sensors import perspective


@struct.dataclass
class PSSMLTConfig:
    max_depth: int = struct.field(pytree_node=False, default=8)
    n_chains: int = struct.field(pytree_node=False, default=256)
    n_mutations: int = struct.field(pytree_node=False, default=256)
    p_large: float = struct.field(pytree_node=False, default=0.3)
    s1: float = struct.field(pytree_node=False, default=1.0 / 1024.0)
    s2: float = struct.field(pytree_node=False, default=1.0 / 64.0)


# per-depth uniform layout: 2 dist + 3 nee + 2 phase + 5 bsdf = 12
_D_DIST, _D_NEE, _D_PHASE, _D_BSDF = 0, 2, 5, 7
DIMS_PER_DEPTH = 7 + bsdf_api.N_SAMPLE_DIMS


def n_dims(cfg: PSSMLTConfig) -> int:
    return 2 + cfg.max_depth * DIMS_PER_DEPTH


def li_from_uniforms(scene: Scene, u, cfg: PSSMLTConfig):
    """Deterministic primary-sample map: u in [0,1]^D -> (pixel_x,
    pixel_y, Li (3,)). The estimator family matches volpath with
    only_vrl_paths=False (NEE at every vertex, emission at depth 1,
    environment on escape)."""
    cam = scene.camera
    w, h = cam.width, cam.height
    px = jnp.minimum((u[0] * w), w - 1e-3)
    py = jnp.minimum((u[1] * h), h - 1e-3)
    ix, iy = jnp.floor(px), jnp.floor(py)
    ray_o, ray_d = perspective.sample_ray(
        cam, ix, iy, jitter=jnp.stack([px - ix, py - iy], axis=-1)
    )
    med = scene.medium
    lo, hi = scene.aabb()
    radius = 0.5 * jnp.linalg.norm(hi - lo)

    state = dict(
        ray_o=ray_o, ray_d=ray_d,
        throughput=jnp.ones((3,)),
        li=jnp.zeros((3,)),
        active=jnp.bool_(True),
    )

    def step(state, ud):
        """One bounce consuming the per-depth uniform slice ud."""
        depth, ud = ud
        active = state["active"]
        hit = intersect.intersect_all(
            state["ray_o"], state["ray_d"], scene.vertices, scene.faces
        )
        hit_p = jnp.where(hit.valid[..., None], hit.p, state["ray_o"])
        dist_surf = jnp.where(hit.valid, hit.t, jnp.float32(1e30))
        ms = mapi.sample_distance_seg_u(
            med, ud[_D_DIST:_D_DIST + 2], state["ray_o"], state["ray_d"],
            dist_surf,
        )
        medium_event = ms.success & active
        surface_event = (~ms.success) & hit.valid & active
        escape = (~ms.success) & (~hit.valid) & active

        # environment on escape (emission query only at depth 1)
        env_l = em_mod.env_radiance(scene.emitters, state["ray_d"])
        li_env = jnp.where(
            (escape & (depth == 1))[..., None],
            state["throughput"] * ms.w_pass * env_l, 0.0,
        )

        # ---- medium vertex ----
        tp_med = state["throughput"] * ms.w_scatter
        # sanitize the no-interaction sentinel position (see volpath)
        p_med = jnp.where(medium_event[..., None], ms.p, state["ray_o"])
        nee_dir, nee_val, nee_dist = em_mod.nee_u(
            scene.emitters, ud[_D_NEE:_D_NEE + 3], p_med, radius
        )
        endpoint = p_med + nee_dist[..., None] * nee_dir
        tau_nee = eval_transmittance_between(scene, p_med, endpoint)
        phase_val = ph.eval_phase(
            med.phase_kind, med.g, -state["ray_d"], nee_dir,
            pp=med.phase_params,
        )
        li_med = jnp.where(
            medium_event[..., None],
            tp_med * nee_val * tau_nee * phase_val[..., None], 0.0,
        )
        wo_phase, w_phase, _ = ph.sample_phase(
            med.phase_kind, med.g, -state["ray_d"],
            ud[_D_PHASE:_D_PHASE + 2], pp=med.phase_params,
        )
        tp_med_cont = tp_med * w_phase[..., None]

        # ---- surface vertex ----
        tp_surf = state["throughput"] * ms.w_pass
        mat_id = scene.material[jnp.maximum(hit.prim, 0)]
        emit_id = scene.face_emitter[jnp.maximum(hit.prim, 0)]
        front = m.dot(hit.ng_raw, -state["ray_d"]) > 0
        le_gate = surface_event & (emit_id >= 0) & front & (depth == 1)
        le_val = scene.emitters.intensity[jnp.maximum(emit_id, 0)]
        li_emit = jnp.where(le_gate[..., None], tp_surf * le_val, 0.0)

        smp = bsdf_api.sample_from_uniforms(
            scene, ud[_D_BSDF:_D_BSDF + bsdf_api.N_SAMPLE_DIMS],
            mat_id, hit.ng, hit.ng_raw, state["ray_d"], hit_p,
            mode="radiance",
        )
        nee_dir_s, nee_val_s, nee_dist_s = em_mod.nee_u(
            scene.emitters, ud[_D_NEE:_D_NEE + 3], hit_p, radius
        )
        endpoint_s = hit_p + nee_dist_s[..., None] * nee_dir_s
        tau_nee_s = eval_transmittance_between(scene, hit_p, endpoint_s)
        bsdf_val = bsdf_api.eval_smooth(
            scene, mat_id, hit.ng, -state["ray_d"], nee_dir_s,
            p_world=hit_p,
        )
        li_surf = jnp.where(
            (surface_event & smp.is_smooth)[..., None],
            tp_surf * nee_val_s * tau_nee_s * bsdf_val, 0.0,
        )

        li = state["li"] + li_med + li_surf + li_emit + li_env
        new_o = jnp.where(medium_event[..., None], p_med, hit_p)
        new_d = jnp.where(medium_event[..., None], wo_phase, smp.wo)
        new_tp = jnp.where(
            medium_event[..., None], tp_med_cont, tp_surf * smp.weight
        )
        survive = medium_event | (
            surface_event & smp.valid & ~jnp.all(smp.weight == 0.0)
        )
        new_state = dict(
            ray_o=new_o, ray_d=new_d, throughput=new_tp,
            li=li, active=survive,
        )
        froze = jax.tree_util.tree_map(
            lambda n, o: jnp.where(
                active.reshape(active.shape + (1,) * (n.ndim - active.ndim)),
                n, o,
            ), new_state, state,
        )
        froze["li"] = li
        return froze, None

    depths = jnp.arange(1, cfg.max_depth + 1)
    u_steps = u[2:].reshape(cfg.max_depth, DIMS_PER_DEPTH)
    final, _ = jax.lax.scan(step, state, (depths, u_steps))
    return px, py, final["li"]


def _kelemen_mutate(u, k, cfg: PSSMLTConfig):
    """Symmetric log-exponential small-step mutation, wrapped to [0,1)
    (Kelemen et al. 2002, the reference's pssmlt_sampler.cpp)."""
    d = u.shape[0]
    k1, k2, k3 = jax.random.split(k, 3)
    r = jax.random.uniform(k1, (d,))
    mag = cfg.s2 * jnp.exp(-jnp.log(cfg.s2 / cfg.s1) * r)
    sign = jnp.where(jax.random.uniform(k2, (d,)) < 0.5, -1.0, 1.0)
    out = u + sign * mag
    return out - jnp.floor(out)


@partial(jax.jit, static_argnames=("cfg",))
def render_pssmlt(scene: Scene, key, cfg: PSSMLTConfig = PSSMLTConfig()):
    """Metropolis render: returns the (H, W, 3) image estimate."""
    cam = scene.camera
    w, h = cam.width, cam.height
    d = n_dims(cfg)

    k_init, k_run = jax.random.split(key)
    u0 = jax.random.uniform(k_init, (cfg.n_chains, d))

    def eval_u(u):
        px, py, li = li_from_uniforms(scene, u, cfg)
        lum = spectrum.luminance(li)
        pix = (py.astype(jnp.int32) * w + px.astype(jnp.int32))
        return pix, li, lum

    pix0, li0, lum0 = jax.vmap(eval_u)(u0)

    def chain_step(carry, k):
        u, pix, li, lum = carry
        k1, k2, k3, k4 = jax.random.split(k, 4)
        large = jax.random.uniform(k1, (cfg.n_chains,)) < cfg.p_large
        u_large = jax.random.uniform(k2, (cfg.n_chains, d))
        u_small = jax.vmap(
            lambda uu, kk: _kelemen_mutate(uu, kk, cfg)
        )(u, jax.random.split(k3, cfg.n_chains))
        u_prop = jnp.where(large[:, None], u_large, u_small)
        pix_p, li_p, lum_p = jax.vmap(eval_u)(u_prop)

        a = jnp.minimum(1.0, lum_p / jnp.maximum(lum, 1e-12))
        a = jnp.where(lum <= 1e-12, 1.0, a)  # dead chains always move
        accept = jax.random.uniform(k4, (cfg.n_chains,)) < a

        # luminance-normalized deposits for BOTH states (expected-value
        # splatting, pssmlt.cpp)
        w_cur = jnp.where(lum > 1e-12, (1.0 - a) / lum, 0.0)
        w_prop = jnp.where(lum_p > 1e-12, a / lum_p, 0.0)
        dep_pix = jnp.stack([pix, pix_p], axis=-1)         # (C, 2)
        dep_val = jnp.stack(
            [li * w_cur[:, None], li_p * w_prop[:, None]], axis=-2
        )                                                   # (C, 2, 3)

        u_n = jnp.where(accept[:, None], u_prop, u)
        pix_n = jnp.where(accept, pix_p, pix)
        li_n = jnp.where(accept[:, None], li_p, li)
        lum_n = jnp.where(accept, lum_p, lum)
        # b estimate from large-step proposals
        b_sum = jnp.sum(jnp.where(large, lum_p, 0.0))
        b_cnt = jnp.sum(large)
        return (u_n, pix_n, li_n, lum_n), (dep_pix, dep_val, b_sum, b_cnt)

    keys = jax.random.split(k_run, cfg.n_mutations)
    _, (dep_pix, dep_val, b_sums, b_cnts) = jax.lax.scan(
        chain_step, (u0, pix0, li0, lum0), keys
    )
    b = jnp.sum(b_sums) / jnp.maximum(jnp.sum(b_cnts), 1.0)

    flat_pix = dep_pix.reshape(-1)
    flat_val = dep_val.reshape(-1, 3)
    img = jax.ops.segment_sum(flat_val, flat_pix, num_segments=w * h)
    n_mut = cfg.n_mutations * cfg.n_chains
    img = img * (b * (w * h) / jnp.float32(n_mut))
    return img.reshape(h, w, 3)
