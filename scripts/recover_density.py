"""Density-field recovery by gradient descent on the voxels.

Recovers a config-4-style plume density grid from rendered images with
exact per-voxel gradients: jax.grad through render_with_vrls (the
grid-medium XLA path: supersampled-NN density lookups, cumulative-OD
tables and the U<->V quadrature, all differentiated by JAX AD), then an
Adam step on log-density.

Four fixed views (front, two sides, top), relative-MSE image loss
(without the normalization the near-emitter pixels dominate), Adam on
log-density, Dirichlet smoothness prior, VRLs retraced every few steps
from the CURRENT density estimate (gradients through tracing are
detached — the detached-sampling contract). Reference semantics for
what is being differentiated: the reference's
src/medium/heterogeneous.cpp:546-663 inside vrlIntegrator.cpp:603-785.

Usage: python scripts/recover_density.py [--steps N] [--res R]
       [--size S] [--out data/recover_density_result.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import scripts._cache  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np

from alvrl_tpu.integrators.vrl import tracer, vrl as vrl_mod
from alvrl_tpu.integrators.vrl.integrate import VRLConfig
from alvrl_tpu.integrators.vrl.integrator import render_with_vrls
from alvrl_tpu.scene import presets
from alvrl_tpu.scene.presets import look_at
from alvrl_tpu.scene.scene import Camera

N_VRLS = 256
N_PARTICLES = 64
RETRACE_EVERY = 8


def make_views(w, h):
    return [
        Camera(to_world=look_at([0, 0, -0.99], [0, 0, 1], [0, 1, 0]),
               fov_x_deg=jnp.float32(90.0), width=w, height=h),
        Camera(to_world=look_at([-0.99, 0, 0.0], [1, 0, 0.0], [0, 1, 0]),
               fov_x_deg=jnp.float32(90.0), width=w, height=h),
        Camera(to_world=look_at([0.99, 0, 0.0], [-1, 0, 0.0], [0, 1, 0]),
               fov_x_deg=jnp.float32(90.0), width=w, height=h),
        Camera(to_world=look_at([0, 0.95, 0.2], [0, -1, 0.2], [0, 0, 1]),
               fov_x_deg=jnp.float32(90.0), width=w, height=h),
    ]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--res", type=int, default=16)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--smooth", type=float, default=2e-3,
                    help="Dirichlet (squared-difference) smoothness "
                         "weight: regularizes the ill-posed few-view "
                         "problem")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "..", "data",
        "recover_density_result.json"))
    args = ap.parse_args()

    cfg = VRLConfig(vol_vol_samples=2, vol_surf_samples=2)
    base = presets.cornell_grid_smoke(width=args.size, height=args.size,
                                      grid_res=args.res)
    med_true = base.medium
    dens_true = np.asarray(med_true.density, np.float32)
    views = make_views(args.size, args.size)
    scenes_true = [base.replace(camera=c) for c in views]

    # ---- targets: average of several passes with the true density ----
    print("rendering targets...", file=sys.stderr)
    targets = []
    t0 = time.time()
    for vi, sc in enumerate(scenes_true):
        acc = None
        n_pass = 6
        for p in range(n_pass):
            vr = vrl_mod.compact(
                tracer.trace(sc, jax.random.key(1000 + p), N_PARTICLES,
                             tracer.TracerConfig(max_depth=10)),
                N_VRLS, slots_per_particle=8)
            img = render_with_vrls(
                sc, vr, jax.random.key(2000 + 10 * vi + p), cfg)
            acc = img if acc is None else acc + img
        targets.append(acc / n_pass)
    jax.block_until_ready(targets)
    print(f"targets in {time.time() - t0:.1f}s", file=sys.stderr)

    # ---- loss/grad per view (jitted once; density is an argument)
    def make_loss(vi):
        sc_v = scenes_true[vi]

        def f(density, vrls, key):
            med = med_true.replace(density=density)
            sc = sc_v.replace(medium=med)
            img = render_with_vrls(sc, vrls, key, cfg)
            # relative MSE: without the normalization the handful of
            # near-emitter pixels dominate and deep/dim voxels get no
            # gradient signal
            t = targets[vi]
            return jnp.mean(((img - t) / (t + 0.1)) ** 2)

        return jax.jit(jax.value_and_grad(f))

    grad_fns = [make_loss(vi) for vi in range(len(views))]

    # ---- Adam on log-density (positivity + multiplicative updates:
    # high-density peaks grow geometrically instead of by fixed
    # increments, and near-zero regions cannot go negative) ----
    LOG_MIN, LOG_MAX = np.log(1e-3), np.log(20.0)
    theta = np.full(dens_true.shape,
                    np.log(max(float(dens_true.mean()), 1e-3)),
                    np.float32)
    dens = np.exp(theta).astype(np.float32)
    m_t = np.zeros_like(dens)
    v_t = np.zeros_like(dens)
    b1, b2, eps = 0.9, 0.999, 1e-8

    def rel_err(d):
        return float(np.linalg.norm(d - dens_true)
                     / max(np.linalg.norm(dens_true), 1e-12))

    def corr(d):
        dc = d - d.mean()
        tc = dens_true - dens_true.mean()
        return float((dc * tc).sum()
                     / max(np.sqrt((dc ** 2).sum() * (tc ** 2).sum()),
                           1e-12))

    def dirichlet_grad(d):
        """grad of sum over axes of (d[i+1]-d[i])^2 (numpy, host)."""
        g = np.zeros_like(d)
        for ax in range(3):
            diff = np.diff(d, axis=ax)
            lo = [slice(None)] * 3
            hi = [slice(None)] * 3
            lo[ax] = slice(0, -1)
            hi[ax] = slice(1, None)
            g[tuple(lo)] -= 2.0 * diff
            g[tuple(hi)] += 2.0 * diff
        return g

    hist = []
    t_dev = 0.0
    vrls = None
    print(f"init rel_err {rel_err(dens):.4f}", file=sys.stderr)
    t_start = time.time()
    for step in range(args.steps):
        if step % RETRACE_EVERY == 0:
            sc_cur = scenes_true[0].replace(
                medium=med_true.replace(density=jnp.asarray(dens)))
            vrls = vrl_mod.compact(
                tracer.trace(sc_cur, jax.random.key(step), N_PARTICLES,
                             tracer.TracerConfig(max_depth=10)),
                N_VRLS, slots_per_particle=8)

        t0 = time.time()
        loss_tot = 0.0
        g_dens = args.smooth * dirichlet_grad(dens)
        for vi, gf in enumerate(grad_fns):
            lv, g_v = gf(jnp.asarray(dens), vrls,
                         jax.random.key(7000 + 31 * step + vi))
            loss_tot += float(lv)
            g_dens = g_dens + np.asarray(g_v)
        t_dev += time.time() - t0
        g = g_dens * dens  # chain to log-space

        m_t = b1 * m_t + (1 - b1) * g
        v_t = b2 * v_t + (1 - b2) * g * g
        mh = m_t / (1 - b1 ** (step + 1))
        vh = v_t / (1 - b2 ** (step + 1))
        lr = args.lr * (0.2 + 0.8 * 0.5
                        * (1 + np.cos(np.pi * step / args.steps)))
        theta = np.clip(theta - lr * mh / (np.sqrt(vh) + eps),
                        LOG_MIN, LOG_MAX).astype(np.float32)
        dens = np.exp(theta).astype(np.float32)

        if step % 10 == 0 or step == args.steps - 1:
            re = rel_err(dens)
            co = corr(dens)
            hist.append(dict(step=step, loss=loss_tot, rel_err=re,
                             corr=co))
            print(f"step {step:4d} loss {loss_tot:.3e} "
                  f"rel_err {re:.4f} corr {co:.3f}", file=sys.stderr)

    wall = time.time() - t_start
    result = dict(
        steps=args.steps, res=args.res, size=args.size,
        views=len(views), n_vrls=N_VRLS,
        init_rel_err=hist[0]["rel_err"] if hist else None,
        final_rel_err=rel_err(dens), final_corr=corr(dens),
        final_loss=hist[-1]["loss"],
        wall_s=wall, per_step_ms=1e3 * wall / args.steps,
        device_grad_ms=1e3 * t_dev / args.steps,
        history=hist,
    )
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    np.savez(os.path.join(os.path.dirname(args.out),
                          "recover_density_fields.npz"),
             recovered=dens, truth=dens_true)
    print(json.dumps({k: v for k, v in result.items()
                      if k != "history"}))


if __name__ == "__main__":
    main()
