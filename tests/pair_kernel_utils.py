"""Shared set-up of the pair-kernel tests."""

import jax
import jax.numpy as jnp
import numpy as np

from alvrl_tpu.integrators.vrl import tracer
from alvrl_tpu.integrators.vrl import vrl as vrl_mod
from alvrl_tpu.integrators.vrl.integrator import trace_eye_rays
from alvrl_tpu.media import phase as ph
from alvrl_tpu.scene import presets
from alvrl_tpu.sensors import perspective

# the interpreter's block shape: smaller than the card's, same code path
BLOCK = (16, 16, 4)


def setup_scene(w=8, h=8, g=0.0, phase_kind=ph.HG, n_vrls=37):
    """(scene, vrls, ray args) for an 8x8 Cornell smoke frame; 37 VRLs is
    not a multiple of the VRL tile."""
    scene = presets.cornell_smoke(width=w, height=h, g=g)
    if phase_kind != ph.HG:
        scene = scene.replace(
            medium=scene.medium.replace(phase_kind=phase_kind))
    raw = tracer.trace(scene, jax.random.key(0), 16,
                       tracer.TracerConfig(max_depth=4))
    vrls = vrl_mod.compact(raw, 64, slots_per_particle=4)
    vrls = vrls.replace(start=vrls.start[:n_vrls], end=vrls.end[:n_vrls],
                        power=vrls.power[:n_vrls], valid=vrls.valid[:n_vrls])
    px, py = jnp.meshgrid(jnp.arange(w), jnp.arange(h))
    o, d = perspective.sample_ray(scene.camera, px.reshape(-1),
                                  py.reshape(-1))
    hit = trace_eye_rays(scene, o, d)
    return scene, vrls, (o, d, hit.p, hit.valid, hit.ng, hit.mat)


def assert_close(out, ref):
    """Same uniforms and arithmetic on the CPU: summation order only."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert np.isfinite(out).all()
    tol = 1e-4 * np.abs(ref) + 1e-6 * np.abs(ref).mean()
    assert (np.abs(out - ref) <= tol).all(), np.abs(out - ref).max()
