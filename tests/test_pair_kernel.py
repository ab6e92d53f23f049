"""The fused pair kernel (ops.pair_kernel) against its plain reference,
unclustered.

On the CPU the kernel runs in the Pallas interpreter; both sides then use
the same hash uniforms and the same XLA arithmetic, so they agree to
summation-order rounding. The `gpu`-marked test compiles the kernel for
the card and skips elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alvrl_tpu.core import rng
from alvrl_tpu.integrators.vrl import integrate
from alvrl_tpu.integrators.vrl.integrate import VRLConfig
from alvrl_tpu.media import phase as ph
from alvrl_tpu.ops import pair_kernel as pk
from tests.pair_kernel_utils import BLOCK, assert_close, setup_scene

CASES = {
    "isotropic": dict(),
    "hg_g08": dict(g=0.8),
    "rayleigh": dict(phase_kind=ph.RAYLEIGH),
    "one_vrl": dict(n_vrls=1),
    "vol_surf_only_long": dict(
        cfg=VRLConfig(vol_vol_samples=0, vol_surf_samples=3,
                      short_vrls=False)),
    "rays_not_block_multiple": dict(w=5, h=7),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_reference(case):
    kw = dict(CASES[case])
    cfg = kw.pop("cfg", VRLConfig(vrl_chunk=16))
    scene, vrls, rays = setup_scene(**kw)
    # some VRLs invalid: they must contribute nothing
    valid = vrls.valid.at[1::3].set(False)
    seed = rng.seed_bits(jax.random.key(3))
    out = pk.pair_sum(cfg, scene, *rays, vrls.start, vrls.end, vrls.power,
                      valid, seed, interpret=True, block=BLOCK)
    ref = integrate.pair_sum(scene, *rays, vrls.start[None], vrls.end[None],
                             vrls.power[None], valid[None], seed, cfg)
    assert float(jnp.abs(ref).sum()) > 0
    assert_close(out, ref)


@pytest.mark.gpu
def test_kernel_on_gpu_matches_reference(gpu):
    """The kernel compiled for the card, against the XLA reference at the
    same uniforms. fp32 with another summation order and other
    transcendentals: per-ray sums agree to 1e-3 relative (floor 1e-6 of
    the mean) except where a last-bit difference flips a discrete
    decision (a shadow segment grazing a triangle edge), which at most
    one ray in a thousand may show."""
    cfg = VRLConfig()
    scene, vrls, rays = setup_scene(w=64, h=64, n_vrls=64)
    seed = rng.seed_bits(jax.random.key(3))
    out = pk.pair_sum(cfg, scene, *rays, vrls.start, vrls.end, vrls.power,
                      vrls.valid, seed)
    with jax.default_matmul_precision("highest"):
        ref = integrate.pair_sum(scene, *rays, vrls.start[None],
                                 vrls.end[None], vrls.power[None],
                                 vrls.valid[None], seed, cfg)
    out, ref = np.asarray(out), np.asarray(ref)
    tol = 1e-3 * np.abs(ref) + 1e-6 * np.abs(ref).mean()
    assert (np.abs(out - ref) > tol).mean() <= 1e-3
    assert abs(out.mean() - ref.mean()) <= 1e-4 * abs(ref.mean())
