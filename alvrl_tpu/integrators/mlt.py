"""MLT — Metropolis light transport over the bidirectional estimator.

Counterpart of src/integrators/mlt/ (Veach-style MLT: Metropolis
sampling whose target is the full path-space contribution function,
seeded and proposed through bidirectional path sampling). The
reference mutates paths directly in path space (bidirectional /
lens / caustic / multi-chain mutations from libbidir, mlt_proc.cpp);
that vocabulary of hand-crafted mutations exists to keep proposals
ergodic and cheap on a CPU.

Array re-design: the chain walks the primary sample cube of the
*bidirectional* estimator (bdpt.li_bdpt_from_uniforms) — the same
target distribution family (every (s, t) strategy, Veach-MIS-weighted)
with Kelemen small-step/large-step proposals instead of path-space
surgery. Large steps are exactly the reference's bidirectional
mutation (an independent BDPT resample); small steps perturb the
pixel + both subpaths jointly, which subsumes the lens/caustic
perturbations' role. Thousands of chains advance in lockstep under
vmap + lax.scan (the reference runs a few chains on threads).

The normalization constant b = E[I] comes from the large-step
proposals (Kelemen's estimator), so the image is unbiased for the
strategies BDPT covers (t >= 2; the t = 1 light-tracing family lives
in `ptracer`, as documented in bdpt.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from alvrl_tpu.core import struct

from alvrl_tpu.core import spectrum
from alvrl_tpu.integrators.bdpt import (
    BDPTConfig,
    li_bdpt_from_uniforms,
    n_dims_bdpt,
)
from alvrl_tpu.integrators.pssmlt import PSSMLTConfig, _kelemen_mutate
from alvrl_tpu.scene.scene import Scene


@struct.dataclass
class MLTConfig:
    n_eye: int = struct.field(pytree_node=False, default=4)
    n_light: int = struct.field(pytree_node=False, default=4)
    n_chains: int = struct.field(pytree_node=False, default=256)
    n_mutations: int = struct.field(pytree_node=False, default=256)
    p_large: float = struct.field(pytree_node=False, default=0.3)
    s1: float = struct.field(pytree_node=False, default=1.0 / 1024.0)
    s2: float = struct.field(pytree_node=False, default=1.0 / 64.0)

    def bdpt(self) -> BDPTConfig:
        return BDPTConfig(n_eye=self.n_eye, n_light=self.n_light)

    def _mutator(self) -> PSSMLTConfig:
        return PSSMLTConfig(s1=self.s1, s2=self.s2)


@partial(jax.jit, static_argnames=("cfg",))
def render_mlt(scene: Scene, key, cfg: MLTConfig = MLTConfig()):
    """Metropolis render over bidirectional path space: (H, W, 3)."""
    import jax as _jax

    from alvrl_tpu.integrators.bdpt import _resolve_env_strategies

    cam = scene.camera
    w, h = cam.width, cam.height
    bcfg = cfg.bdpt()
    # pin the env-family mode from the concrete scene (round 5: the
    # ENVMAP conventions differ from CONSTANT's; a wrong mode would
    # make the Metropolis target's MIS weights inconsistent with the
    # sampling family)
    if not isinstance(scene.emitters.kind, _jax.core.Tracer):
        bcfg = _resolve_env_strategies(scene, bcfg)
    mcfg = cfg._mutator()
    d = n_dims_bdpt(bcfg)

    k_init, k_run = jax.random.split(key)
    u0 = jax.random.uniform(k_init, (cfg.n_chains, d))

    def eval_u(u):
        px, py, li = li_bdpt_from_uniforms(scene, u, bcfg)
        lum = spectrum.luminance(li)
        pix = py.astype(jnp.int32) * w + px.astype(jnp.int32)
        return pix, li, lum

    pix0, li0, lum0 = jax.vmap(eval_u)(u0)

    def chain_step(carry, k):
        u, pix, li, lum = carry
        k1, k2, k3, k4 = jax.random.split(k, 4)
        large = jax.random.uniform(k1, (cfg.n_chains,)) < cfg.p_large
        u_large = jax.random.uniform(k2, (cfg.n_chains, d))
        u_small = jax.vmap(
            lambda uu, kk: _kelemen_mutate(uu, kk, mcfg)
        )(u, jax.random.split(k3, cfg.n_chains))
        u_prop = jnp.where(large[:, None], u_large, u_small)
        pix_p, li_p, lum_p = jax.vmap(eval_u)(u_prop)

        a = jnp.minimum(1.0, lum_p / jnp.maximum(lum, 1e-12))
        a = jnp.where(lum <= 1e-12, 1.0, a)
        accept = jax.random.uniform(k4, (cfg.n_chains,)) < a

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
        b_sum = jnp.sum(jnp.where(large, lum_p, 0.0))
        b_cnt = jnp.sum(large)
        return (u_n, pix_n, li_n, lum_n), (dep_pix, dep_val, b_sum, b_cnt)

    keys = jax.random.split(k_run, cfg.n_mutations)
    _, (dep_pix, dep_val, b_sums, b_cnts) = jax.lax.scan(
        chain_step, (u0, pix0, li0, lum0), keys
    )
    b = jnp.sum(b_sums) / jnp.maximum(jnp.sum(b_cnts), 1.0)

    img = jax.ops.segment_sum(
        dep_val.reshape(-1, 3), dep_pix.reshape(-1), num_segments=w * h
    )
    n_mut = cfg.n_mutations * cfg.n_chains
    img = img * (b * (w * h) / jnp.float32(n_mut))
    return img.reshape(h, w, 3)
