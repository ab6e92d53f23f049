"""Instant radiosity with virtual point lights (the `vpl` plugin).

Counterpart of src/integrators/vpl/vpl.cpp (268 LoC) and the VPL
generator src/librender/vpl.cpp:237. The reference renders each VPL in
a separate OpenGL pass with shadow maps (libhw); the Array re-design is a
dense (pixel x VPL) gather sweep — the same shape as the VRL transfer
matrix and the photon-map estimate — with per-pair analytic shadow rays
instead of rasterized shadow maps.

Semantics kept from the reference:
  * VPL generation is a surface random walk from the emitters, one VPL
    deposited per diffuse bounce, power = incident flux estimate
    (generateVPLs, src/librender/vpl.cpp).
  * Geometry-term clamping against the 1/d^2 singularity: distances are
    clamped below `clamp * scene_radius` (vpl.cpp `m_clamping`).
  * Direct illumination is evaluated exactly by next-event estimation
    against the real emitter table (the reference's luminaire VPLs have
    the same expectation; an exact NEE term has strictly lower
    variance, so we use it instead of sampling emitter VPLs).

Media are ignored (the reference vpl integrator is the surface-only
GL preview path).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from alvrl_tpu.core import struct

from alvrl_tpu.bsdf import api as bsdf_api
from alvrl_tpu.core import math as m
from alvrl_tpu.core import rng
from alvrl_tpu.geometry import intersect
from alvrl_tpu.integrators.surface import vacuumize
from alvrl_tpu.integrators.vrl.tracer import (
    TracerConfig,
    _sample_bsdf_importance,
    _sample_emission,
)
from alvrl_tpu.scene.scene import DIFFUSE, Scene
from alvrl_tpu.sensors import perspective


@struct.dataclass
class VPLSet:
    """Fixed-capacity struct-of-arrays VPL buffer (vpl.h VPL records)."""

    pos: jax.Array      # (N, 3) surface position
    ng: jax.Array       # (N, 3) shading-side geometric normal
    wi: jax.Array       # (N, 3) direction the light ARRIVED from
    power: jax.Array    # (N, 3) incident flux estimate before scattering
    mat: jax.Array      # (N,) material id at the VPL
    valid: jax.Array    # (N,) bool
    n_paths: jax.Array  # scalar f32: traced light paths (normalizer)


@partial(jax.jit, static_argnames=("n_paths", "cfg"))
def generate_vpls(scene: Scene, key, n_paths: int,
                  cfg: TracerConfig = TracerConfig()) -> VPLSet:
    """Light-path random walk depositing a VPL per diffuse surface
    vertex (generateVPLs, src/librender/vpl.cpp:237). Runs over the
    vacuumized scene: the reference VPL walk does not sample media."""
    scene = vacuumize(scene)

    def one(key):
        k_emit, k_walk = jax.random.split(key)
        pos, d, weight = _sample_emission(scene, k_emit)
        state = dict(
            ray_o=pos, ray_d=d, beta=weight, tp=jnp.ones((3,)),
            active=~jnp.all(weight == 0.0),
        )

        def step(state, inp):
            depth, k = inp
            k_bsdf, k_rr = jax.random.split(k)
            hit = intersect.intersect_all(
                state["ray_o"], state["ray_d"], scene.vertices, scene.faces
            )
            hit = hit._replace(
                p=jnp.where(hit.valid[..., None], hit.p, state["ray_o"])
            )
            active = state["active"] & hit.valid
            mat_id = scene.material[jnp.maximum(hit.prim, 0)]
            is_diffuse = scene.materials.kind[mat_id] == DIFFUSE
            out = dict(
                pos=hit.p, ng=hit.ng, wi=-state["ray_d"],
                power=state["beta"], mat=mat_id,
                valid=active & is_diffuse,
            )
            wo, w_bsdf, _, bsdf_valid = _sample_bsdf_importance(
                scene, k_bsdf, mat_id, hit.ng, hit.ng_raw,
                state["ray_d"], hit.p,
            )
            new_beta = state["beta"] * w_bsdf
            new_tp = state["tp"] * w_bsdf
            survive = active & bsdf_valid & ~jnp.all(w_bsdf == 0.0)
            q = jnp.minimum(jnp.max(new_tp), 0.95)
            do_rr = depth >= cfg.rr_depth
            rr_kill = do_rr & (rng.uniform(k_rr) >= q)
            rr_scale = jnp.where(
                do_rr & ~rr_kill, 1.0 / jnp.maximum(q, 1e-30), 1.0
            )
            new_state = dict(
                ray_o=hit.p, ray_d=wo, beta=new_beta * rr_scale,
                tp=new_tp * rr_scale,
                active=survive & ~rr_kill,
            )
            new_state = jax.tree_util.tree_map(
                lambda n, o: jnp.where(
                    state["active"].reshape(
                        state["active"].shape
                        + (1,) * (n.ndim - state["active"].ndim)
                    ), n, o,
                ),
                new_state, state,
            )
            return new_state, out

        depths = jnp.arange(1, cfg.max_depth + 1)
        keys = jax.random.split(k_walk, cfg.max_depth)
        _, outs = jax.lax.scan(step, state, (depths, keys))
        return outs

    outs = jax.vmap(one)(jax.random.split(key, n_paths))
    flat = lambda a: a.reshape((-1,) + a.shape[2:])
    return VPLSet(
        pos=flat(outs["pos"]), ng=flat(outs["ng"]), wi=flat(outs["wi"]),
        power=flat(outs["power"]), mat=flat(outs["mat"]),
        valid=flat(outs["valid"]), n_paths=jnp.float32(n_paths),
    )


def _gather_vpls(scene: Scene, vpls: VPLSet, q_pos, q_ng, q_mat, q_wo,
                 q_valid, min_dist2, chunk: int):
    """Sum over all VPLs of f_x * G * V * f_vpl * P / n_paths for a
    batch of shading points (the per-VPL accumulation loop of
    vpl.cpp:drawVPL, with analytic shadow rays replacing shadow maps)."""
    opaque = scene.opaque_faces()
    n = vpls.pos.shape[0]
    pad = (-n) % chunk

    def padded(a):
        if pad == 0:
            return a
        width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, width)

    v_pos = padded(vpls.pos).reshape(-1, chunk, 3)
    v_ng = padded(vpls.ng).reshape(-1, chunk, 3)
    v_wi = padded(vpls.wi).reshape(-1, chunk, 3)
    v_pow = padded(vpls.power).reshape(-1, chunk, 3)
    v_mat = padded(vpls.mat).reshape(-1, chunk)
    v_ok = padded(vpls.valid).reshape(-1, chunk)

    def body(acc, inp):
        cp, cn, cwi, cpow, cmat, cok = inp
        delta = cp[None, :, :] - q_pos[:, None, :]       # (B, C, 3)
        d2 = jnp.sum(delta * delta, axis=-1)
        dirn = delta / jnp.sqrt(jnp.maximum(d2, 1e-20))[..., None]
        # f at the shading point: wi toward eye, wo toward the VPL
        f_x = bsdf_api.eval_smooth(
            scene, q_mat[:, None], q_ng[:, None, :],
            q_wo[:, None, :], dirn, p_world=q_pos[:, None, :],
        )
        # f at the VPL: wi = arrival direction, wo toward the point
        f_v = bsdf_api.eval_smooth(
            scene, cmat[None, :], cn[None, :, :],
            cwi[None, :, :], -dirn, p_world=cp[None, :, :],
        )
        g = 1.0 / jnp.maximum(d2, min_dist2)             # clamped 1/d^2
        blocked = intersect.occluded(
            jnp.broadcast_to(q_pos[:, None, :], delta.shape).reshape(-1, 3),
            jnp.broadcast_to(cp[None, :, :], delta.shape).reshape(-1, 3),
            scene.vertices, scene.faces, face_mask=opaque,
        ).reshape(d2.shape)
        w = jnp.where(cok[None, :] & ~blocked, g, 0.0)
        contrib = jnp.sum(
            cpow[None, :, :] * f_x * f_v * w[..., None], axis=1
        )
        return acc + contrib, None

    acc0 = jnp.zeros(q_pos.shape[:-1] + (3,))
    acc, _ = jax.lax.scan(
        body, acc0, (v_pos, v_ng, v_wi, v_pow, v_mat, v_ok)
    )
    return jnp.where(
        q_valid[..., None], acc / jnp.maximum(vpls.n_paths, 1.0), 0.0
    )


@partial(jax.jit, static_argnames=("spp", "chunk"))
def render_vpl(scene: Scene, vpls: VPLSet, key, spp: int = 1,
               clamp: float = 0.05, chunk: int = 512):
    """Instant-radiosity render: exact NEE direct term + VPL indirect
    term at the primary hit. `clamp` is the minimum geometry distance
    as a fraction of the scene radius (vpl.cpp m_clamping)."""
    scene = vacuumize(scene)
    cam = scene.camera
    w, h = cam.width, cam.height
    lo, hi = scene.aabb()
    radius = 0.5 * jnp.linalg.norm(hi - lo)
    min_dist2 = (clamp * radius) ** 2

    px, py = jnp.meshgrid(jnp.arange(w), jnp.arange(h), indexing="xy")
    px = px.reshape(-1).astype(jnp.float32)
    py = py.reshape(-1).astype(jnp.float32)

    def one_spp(k):
        k_jit, k_nee = jax.random.split(k)
        jitter = jax.random.uniform(k_jit, (px.shape[0], 2))
        o, d = perspective.sample_ray(cam, px, py, jitter=jitter)
        hit = intersect.intersect_all(o, d, scene.vertices, scene.faces)
        q_pos = jnp.where(hit.valid[..., None], hit.p, o)
        q_mat = scene.material[jnp.maximum(hit.prim, 0)]
        q_wo = -d

        # emitted radiance seen directly (area emitters are geometry)
        emit_id = scene.face_emitter[jnp.maximum(hit.prim, 0)]
        front = jnp.sum(hit.ng_raw * q_wo, axis=-1) > 0
        le_ok = hit.valid & (emit_id >= 0) & front
        le = jnp.where(
            le_ok[..., None],
            scene.emitters.intensity[jnp.maximum(emit_id, 0)], 0.0,
        )

        # exact direct illumination (NEE), per-pixel sample
        from alvrl_tpu.emitters import emitters as em_mod

        dirn, val, dist = jax.vmap(
            lambda kk, pp: em_mod.nee(scene.emitters, kk, pp, radius)
        )(jax.random.split(k_nee, q_pos.shape[0]), q_pos)
        endpoint = q_pos + dist[..., None] * dirn
        blocked = intersect.occluded(
            q_pos, endpoint, scene.vertices, scene.faces,
            face_mask=scene.opaque_faces(),
        )
        f_direct = bsdf_api.eval_smooth(
            scene, q_mat, hit.ng, q_wo, dirn, p_world=q_pos
        )
        direct = jnp.where(
            (hit.valid & ~blocked)[..., None], val * f_direct, 0.0
        )

        indirect = _gather_vpls(
            scene, vpls, q_pos, hit.ng, q_mat, q_wo, hit.valid,
            min_dist2, chunk,
        )
        return le + direct + indirect

    img = jnp.zeros((px.shape[0], 3))
    for i, k in enumerate(jax.random.split(key, spp)):
        img = img + one_spp(k)
    return (img / spp).reshape(h, w, 3)
