"""The fused pair kernel's custom VJP: the gradient of the reference
estimator at the kernel's own uniforms."""

import jax
import jax.numpy as jnp
import numpy as np

from alvrl_tpu.core import rng
from alvrl_tpu.integrators.vrl import integrate
from alvrl_tpu.integrators.vrl.integrate import VRLConfig
from alvrl_tpu.ops import pair_kernel as pk
from tests.pair_kernel_utils import BLOCK, setup_scene


def test_kernel_vjp_matches_reference_grad():
    cfg = VRLConfig(vol_vol_samples=1, vol_surf_samples=1, vrl_chunk=16)
    scene, vrls, rays = setup_scene(g=0.5)
    seed = rng.seed_bits(jax.random.key(3))

    def loss(fn, sigma_a, sigma_s, g, power):
        med = scene.medium.replace(sigma_a=sigma_a, sigma_s=sigma_s, g=g)
        return jnp.sum(fn(scene.replace(medium=med), power) ** 2)

    kern = lambda sc, p: pk.pair_sum(cfg, sc, *rays, vrls.start, vrls.end,
                                     p, vrls.valid, seed, interpret=True,
                                     block=BLOCK)
    ref = lambda sc, p: integrate.pair_sum(
        sc, *rays, vrls.start[None], vrls.end[None], p[None],
        vrls.valid[None], seed, cfg)
    params = (scene.medium.sigma_a, scene.medium.sigma_s, scene.medium.g,
              vrls.power)
    argnums = tuple(range(len(params)))
    gk = jax.grad(lambda *p: loss(kern, *p), argnums)(*params)
    gr = jax.grad(lambda *p: loss(ref, *p), argnums)(*params)
    for a, b in zip(gk, gr):
        assert float(jnp.abs(b).max()) > 0
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6 * float(jnp.abs(b).max()))
