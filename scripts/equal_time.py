"""Equal-time convergence comparison: clustered ALVRL vs unclustered VRL.

The paper's headline claim (and the reference's expected convergence
gain factor log, Preprocessor.cpp:470-486): for a fixed wall-clock
budget, adaptive clustering trades per-pass quality for many more
passes and wins on MSE. We measure MSE against a long volpath oracle.

Usage: python scripts/equal_time.py [seconds_budget]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import scripts._cache  # noqa: F401

import jax
import numpy as np

from alvrl_tpu.integrators import volpath
from alvrl_tpu.integrators.vrl import alvrl, cluster as cl, integrator, tracer, vrl as vrl_mod
from alvrl_tpu.integrators.vrl.integrate import VRLConfig
from alvrl_tpu.io import image as image_io


def main():
    budget = float(sys.argv[1]) if len(sys.argv) > 1 else 20.0
    oracle_path = sys.argv[2] if len(sys.argv) > 2 else "/tmp/oracle64.npy"
    W = int(sys.argv[3]) if len(sys.argv) > 3 else 64
    n_vrls = int(sys.argv[4]) if len(sys.argv) > 4 else 512
    n_particles = max(n_vrls // 4, 64)
    scene_mod = __import__("alvrl_tpu.scene.presets", fromlist=["presets"])
    scene = scene_mod.cornell_smoke(width=W, height=W)
    cfg = VRLConfig(vrl_chunk=128)
    tcfg = tracer.TracerConfig(max_depth=12)

    # Reference image: 'self' = a self-converged unclustered render (both
    # estimators share the same limit; an external volpath oracle's own
    # noise otherwise floors the MSE comparison), else a .npy path from
    # scripts/make_oracle.py.
    if oracle_path == "self":
        acc = None
        n_ref = 256
        for i in range(n_ref):
            raw = tracer.trace(scene, jax.random.key(5000 + i),
                               n_particles, tcfg)
            vr = vrl_mod.compact(raw, n_vrls, slots_per_particle=12)
            img = np.asarray(jax.block_until_ready(
                integrator.render_with_vrls(
                    scene, vr, jax.random.key(6000 + i), cfg)))
            acc = img if acc is None else acc + img
        oracle = acc / n_ref
    else:
        oracle = np.load(oracle_path)

    def run_unclustered():
        acc, n = None, 0
        # warm up compiles outside the budget
        raw = tracer.trace(scene, jax.random.key(0), 128, tcfg)
        img = integrator.render_with_vrls(
            scene, vrl_mod.compact(raw, 512, slots_per_particle=12),
            jax.random.key(0), cfg)
        jax.block_until_ready(img)
        t0 = time.time()
        while time.time() - t0 < budget:
            raw = tracer.trace(scene, jax.random.key(100 + n), n_particles, tcfg)
            vr = vrl_mod.compact(raw, n_vrls, slots_per_particle=12)
            img = integrator.render_with_vrls(
                scene, vr, jax.random.key(200 + n), cfg)
            img = np.asarray(jax.block_until_ready(img))
            acc = img if acc is None else acc + img
            n += 1
        return acc / n, n

    def run_clustered():
        cparams = cl.ClusterParams(target_num_slices=64,
                                   target_pixel_undersampling=32.0)
        params = alvrl.ALVRLParams(
            vrl_target_num=n_vrls, num_particles=n_particles,
            cluster=cparams)
        img, _, _ = alvrl.render_alvrl(scene, jax.random.key(0), params,
                                       cfg, tcfg)
        jax.block_until_ready(img)
        acc, n = None, 0
        t0 = time.time()
        while time.time() - t0 < budget:
            p = alvrl.ALVRLParams(
                vrl_target_num=n_vrls, num_particles=n_particles,
                seed=300 + n, cluster=cparams)
            img, _, _ = alvrl.render_alvrl(
                scene, jax.random.key(300 + n), p, cfg, tcfg)
            img = np.asarray(jax.block_until_ready(img))
            acc = img if acc is None else acc + img
            n += 1
        return acc / n, n

    un_img, un_n = run_unclustered()
    cl_img, cl_n = run_clustered()
    mse_un = image_io.rms(un_img, oracle) ** 2
    mse_cl = image_io.rms(cl_img, oracle) ** 2
    print(f"budget {budget}s:")
    print(f"  unclustered: {un_n} passes, MSE {mse_un:.5f}")
    print(f"  clustered:   {cl_n} passes, MSE {mse_cl:.5f}")
    print(f"  equal-time gain factor (MSE ratio): {mse_un / mse_cl:.2f}x")


if __name__ == "__main__":
    main()
