"""ERPT — energy redistribution path tracing (the `erpt` plugin).

Counterpart of src/integrators/erpt/ (Cline, Talbot, Egbert 2005 as
carried by the reference). A plain path-tracing pass finds where the
energy is; each bright sample's energy is then *redistributed* over its
neighborhood in path space by short Metropolis chains making local
mutations only, which trades PT's salt-and-pepper noise for smooth
low-frequency error.

Array re-design (vs the reference's per-thread chains over libbidir
path-space mutations, erpt_proc.cpp): paths live in primary sample
space — the same deterministic `li_from_uniforms` map as PSSMLT — and
chains are seeded by *importance resampling* the seed pass (categorical
by luminance), which is exactly equilibrium-distributed seeding, so the
estimator stays unbiased. All chains advance in lockstep: one vmap over
chains, one lax.scan over mutation steps, expected-value deposits for
both current and proposed states (the reference deposits on acceptance
only; the expected-value splat has the same mean, lower variance).
Mutations are Kelemen small steps only (no large-step restarts —
redistribution is local by construction; the reference's lens/caustic
perturbations play this role).

Normalization: the seed pass itself is the PT estimate of total image
energy, so no separate b estimate is needed — each chain step deposits
exactly one luminance quantum q = total_seed_energy * (W*H/S) / (C*L).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from alvrl_tpu.core import struct

from alvrl_tpu.core import spectrum
from alvrl_tpu.integrators.pssmlt import (
    PSSMLTConfig,
    _kelemen_mutate,
    li_from_uniforms,
    n_dims,
)
from alvrl_tpu.scene.scene import Scene


@struct.dataclass
class ERPTConfig:
    max_depth: int = struct.field(pytree_node=False, default=8)
    n_seeds: int = struct.field(pytree_node=False, default=4096)
    n_chains: int = struct.field(pytree_node=False, default=512)
    chain_length: int = struct.field(pytree_node=False, default=64)
    s1: float = struct.field(pytree_node=False, default=1.0 / 1024.0)
    s2: float = struct.field(pytree_node=False, default=1.0 / 64.0)

    def pss(self) -> PSSMLTConfig:
        return PSSMLTConfig(
            max_depth=self.max_depth, s1=self.s1, s2=self.s2,
        )


@partial(jax.jit, static_argnames=("cfg",))
def render_erpt(scene: Scene, key, cfg: ERPTConfig = ERPTConfig()):
    """Energy-redistribution render: (H, W, 3) image estimate."""
    cam = scene.camera
    w, h = cam.width, cam.height
    pss = cfg.pss()
    d = n_dims(pss)

    k_seed, k_pick, k_run = jax.random.split(key, 3)

    def eval_u(u):
        px, py, li = li_from_uniforms(scene, u, pss)
        lum = spectrum.luminance(li)
        pix = py.astype(jnp.int32) * w + px.astype(jnp.int32)
        return pix, li, lum

    # ---- seed pass (plain PT over the uniform cube) ----
    u_seed = jax.random.uniform(k_seed, (cfg.n_seeds, d))
    _, _, lum_seed = jax.vmap(eval_u)(u_seed)
    e_total = jnp.sum(lum_seed)

    # ---- equilibrium chain starts: resample seeds by luminance ----
    logits = jnp.log(jnp.maximum(lum_seed, 1e-30))
    idx = jax.random.categorical(k_pick, logits, shape=(cfg.n_chains,))
    u0 = u_seed[idx]
    pix0, li0, lum0 = jax.vmap(eval_u)(u0)

    # per chain-step luminance quantum
    q = e_total * (w * h / cfg.n_seeds) / (cfg.n_chains * cfg.chain_length)

    def chain_step(carry, k):
        u, pix, li, lum = carry
        k1, k2 = jax.random.split(k)
        u_prop = jax.vmap(
            lambda uu, kk: _kelemen_mutate(uu, kk, pss)
        )(u, jax.random.split(k1, cfg.n_chains))
        pix_p, li_p, lum_p = jax.vmap(eval_u)(u_prop)

        a = jnp.minimum(1.0, lum_p / jnp.maximum(lum, 1e-12))
        a = jnp.where(lum <= 1e-12, 1.0, a)
        accept = jax.random.uniform(k2, (cfg.n_chains,)) < a

        w_cur = jnp.where(lum > 1e-12, (1.0 - a) / lum, 0.0)
        w_prop = jnp.where(lum_p > 1e-12, a / lum_p, 0.0)
        dep_pix = jnp.stack([pix, pix_p], axis=-1)
        dep_val = jnp.stack(
            [li * w_cur[:, None], li_p * w_prop[:, None]], axis=-2
        )

        u_n = jnp.where(accept[:, None], u_prop, u)
        pix_n = jnp.where(accept, pix_p, pix)
        li_n = jnp.where(accept[:, None], li_p, li)
        lum_n = jnp.where(accept, lum_p, lum)
        return (u_n, pix_n, li_n, lum_n), (dep_pix, dep_val)

    keys = jax.random.split(k_run, cfg.chain_length)
    _, (dep_pix, dep_val) = jax.lax.scan(
        chain_step, (u0, pix0, li0, lum0), keys
    )
    img = jax.ops.segment_sum(
        dep_val.reshape(-1, 3), dep_pix.reshape(-1), num_segments=w * h
    )
    return (img * q).reshape(h, w, 3)
