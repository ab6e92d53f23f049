"""Measured clustered-vs-unclustered crossover on the HETEROGENEOUS
benchmark scene (VERDICT round-2 item 3: the claim that clustering wins
in the expensive-per-pair regime was a projection; this measures it).

Both arms run the grid-medium XLA path:
  * unclustered: every pixel vs every VRL (render_with_vrls)
  * clustered:   Adaptive LightSlice (render_alvrl)
Equal-time MSE against a self-converged unclustered reference
(integrator.cpp:361-378 equal-work methodology).

Usage: python scripts/crossover_hetero.py [budget_s] [W] [n_vrls]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import scripts._cache  # noqa: F401

import jax
import numpy as np

from alvrl_tpu.integrators.vrl import alvrl, cluster as cl, integrator, tracer, vrl as vrl_mod
from alvrl_tpu.integrators.vrl.integrate import VRLConfig
from alvrl_tpu.scene import presets


def main():
    budget = float(sys.argv[1]) if len(sys.argv) > 1 else 30.0
    W = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    n_vrls = int(sys.argv[3]) if len(sys.argv) > 3 else 512
    n_ref = int(sys.argv[4]) if len(sys.argv) > 4 else 48
    n_particles = max(n_vrls // 4, 48)
    depth = 10

    scene = presets.cornell_grid_smoke(width=W, height=W)
    cfg = VRLConfig(vrl_chunk=128)
    tcfg = tracer.TracerConfig(max_depth=depth)

    def trace_pass(i):
        raw = tracer.trace(scene, jax.random.key(5000 + i), n_particles,
                           tcfg)
        return vrl_mod.compact(raw, n_vrls, slots_per_particle=depth)

    def unclustered_pass(i):
        vr = trace_pass(i)
        return np.asarray(jax.block_until_ready(
            integrator.render_with_vrls(
                scene, vr, jax.random.key(6000 + i), cfg)))

    # self-converged reference
    print(f"building reference ({n_ref} unclustered passes)...",
          file=sys.stderr)
    acc = None
    for i in range(n_ref):
        img = unclustered_pass(10_000 + i)
        acc = img if acc is None else acc + img
    oracle = acc / n_ref

    def mse(img):
        return float(((img - oracle) ** 2).mean())

    # --- unclustered arm -------------------------------------------------
    unclustered_pass(0)  # warm
    acc, n = None, 0
    t0 = time.time()
    while time.time() - t0 < budget:
        img = unclustered_pass(n + 1)
        acc = img if acc is None else acc + img
        n += 1
    mse_u = mse(acc / n)
    print(f"unclustered: {n} passes in {time.time()-t0:.1f}s "
          f"MSE {mse_u:.3e}")

    # --- clustered arm ---------------------------------------------------
    params = alvrl.ALVRLParams(
        vrl_target_num=n_vrls, num_particles=n_particles,
        cluster=cl.ClusterParams(
            target_num_slices=128,
            target_pixel_undersampling=float(max(W * W // 2048, 32))),
    )
    si = alvrl.build_slice_info(scene, params)
    img, _, _ = alvrl.render_alvrl(
        scene, jax.random.key(1), params, cfg=cfg, tracer_cfg=tcfg, slice_info=si)  # warm
    jax.block_until_ready(img)
    acc, n = None, 0
    t0 = time.time()
    while time.time() - t0 < budget:
        img, _, _ = alvrl.render_alvrl(
            scene, jax.random.key(100 + n), params, cfg=cfg,
            tracer_cfg=tcfg, slice_info=si)
        img = np.asarray(jax.block_until_ready(img))
        acc = img if acc is None else acc + img
        n += 1
    mse_c = mse(acc / n)
    print(f"clustered:   {n} passes in {time.time()-t0:.1f}s "
          f"MSE {mse_c:.3e}")
    print(f"crossover summary W={W} n_vrls={n_vrls} budget={budget}s: "
          f"unclustered {mse_u:.3e} vs clustered {mse_c:.3e} "
          f"-> {'CLUSTERED' if mse_c < mse_u else 'UNCLUSTERED'} wins")


if __name__ == "__main__":
    main()
