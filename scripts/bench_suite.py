"""Full BASELINE benchmark suite (configs 1-5, BASELINE.json).

Runs each config on the attached device and emits one JSON line per
config (bench.py remains the driver's single-line entry point; this is
the complete evidence suite).

Usage: python scripts/bench_suite.py [config_numbers...]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import scripts._cache  # noqa: F401  (persistent compile cache)

import jax
import numpy as np


def _timed(fn, n=3):
    out = fn()
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return out, (time.time() - t0) / n


def config1():
    """Cornell + homogeneous isotropic, 128x128, unclustered."""
    from alvrl_tpu.integrators.vrl import integrator, tracer, vrl as vrl_mod
    from alvrl_tpu.integrators.vrl.integrate import VRLConfig
    from alvrl_tpu.scene import presets

    scene = presets.cornell_smoke(width=128, height=128)
    raw = tracer.trace(scene, jax.random.key(0), 128,
                       tracer.TracerConfig(max_depth=12))
    vrls = vrl_mod.compact(raw, 512, slots_per_particle=12)
    cfg = VRLConfig()
    img, dt = _timed(lambda: integrator.render_with_vrls(
        scene, vrls, jax.random.key(1), cfg))
    evals = 128 * 128 * 512 * 4
    return {
        "config": 1, "metric": "vrl_pair_sample_evals_per_s_per_chip",
        "value": evals / dt, "pass_seconds": dt,
        "rays_per_s": 128 * 128 / dt,
        "image_mean": float(np.asarray(img).mean()),
    }


def config2():
    """Same scene, Adaptive LightSlice clustering enabled."""
    from alvrl_tpu.integrators.vrl import alvrl, cluster as cl
    from alvrl_tpu.integrators.vrl.integrate import VRLConfig
    from alvrl_tpu.scene import presets

    scene = presets.cornell_smoke(width=128, height=128)
    params = alvrl.ALVRLParams(
        vrl_target_num=512, num_particles=128,
        cluster=cl.ClusterParams(target_num_slices=100,
                                 target_pixel_undersampling=64.0),
    )
    t0 = time.time()
    si = alvrl.build_slice_info(scene, params)
    img, vrls, info = alvrl.render_alvrl(
        scene, jax.random.key(0), params, slice_info=si)
    jax.block_until_ready(img)
    cold = time.time() - t0
    # steady state: a progressive render pays this per pass (slices
    # cached, kernels compiled)
    t0 = time.time()
    img, vrls, info = alvrl.render_alvrl(
        scene, jax.random.key(1), params, slice_info=si)
    jax.block_until_ready(img)
    warm = time.time() - t0
    reps = float((info.slice_weights > 0).sum(axis=1).mean())
    return {
        "config": 2, "metric": "clustered_pass_seconds", "value": warm,
        "first_pass_seconds": cold,
        "avg_reps_per_slice": reps,
        "undersampling_factor": 512 / max(reps, 1e-9),
        "image_mean": float(np.asarray(img).mean()),
    }


def config3():
    """Anisotropic HG g=0.8, 256x256."""
    from alvrl_tpu.integrators.vrl import integrator, tracer, vrl as vrl_mod
    from alvrl_tpu.integrators.vrl.integrate import VRLConfig
    from alvrl_tpu.scene import presets

    scene = presets.cornell_smoke_hg(width=256, height=256, g=0.8)
    raw = tracer.trace(scene, jax.random.key(0), 128,
                       tracer.TracerConfig(max_depth=12))
    vrls = vrl_mod.compact(raw, 512, slots_per_particle=12)
    cfg = VRLConfig(vol_vol_samples=2, vol_surf_samples=2)
    img, dt = _timed(lambda: integrator.render_with_vrls(
        scene, vrls, jax.random.key(1), cfg))
    evals = 256 * 256 * 512 * 4
    return {
        "config": 3, "metric": "vrl_pair_sample_evals_per_s_per_chip",
        "value": evals / dt, "pass_seconds": dt,
        "image_mean": float(np.asarray(img).mean()),
    }


def config4():
    """Heterogeneous grid smoke, 512x512, clustered."""
    from alvrl_tpu.integrators.vrl import alvrl, cluster as cl
    from alvrl_tpu.integrators.vrl.integrate import VRLConfig
    from alvrl_tpu.integrators.vrl.tracer import TracerConfig
    from alvrl_tpu.scene import presets

    scene = presets.cornell_grid_smoke(width=512, height=512)
    params = alvrl.ALVRLParams(
        vrl_target_num=512, num_particles=192,
        cluster=cl.ClusterParams(target_num_slices=128,
                                 target_pixel_undersampling=128.0),
    )
    t0 = time.time()
    si = alvrl.build_slice_info(scene, params)
    img, vrls, info = alvrl.render_alvrl(
        scene, jax.random.key(0), params,
        cfg=VRLConfig(vrl_chunk=128), tracer_cfg=TracerConfig(max_depth=10), slice_info=si,
    )
    jax.block_until_ready(img)
    cold = time.time() - t0
    t0 = time.time()
    img, vrls, info = alvrl.render_alvrl(
        scene, jax.random.key(1), params,
        cfg=VRLConfig(vrl_chunk=128), tracer_cfg=TracerConfig(max_depth=10), slice_info=si,
    )
    jax.block_until_ready(img)
    warm = time.time() - t0
    return {
        "config": 4, "metric": "hetero_clustered_pass_seconds",
        "value": warm, "first_pass_seconds": cold,
        "rays_per_s": 512 * 512 / warm,
        "image_mean": float(np.asarray(img).mean()),
    }


def config5():
    """1024x1024 + gradient check w.r.t. sigma_t/albedo/g vs finite
    differences (on a downscaled copy: FD needs 2 renders/param)."""
    from alvrl_tpu.integrators.vrl import integrator, tracer, vrl as vrl_mod
    from alvrl_tpu.integrators.vrl.integrate import VRLConfig
    from alvrl_tpu.scene import presets

    # throughput at full resolution
    scene = presets.cornell_smoke(width=1024, height=1024)
    raw = tracer.trace(scene, jax.random.key(0), 128,
                       tracer.TracerConfig(max_depth=12))
    vrls = vrl_mod.compact(raw, 512, slots_per_particle=12)
    cfg = VRLConfig()
    img, dt = _timed(lambda: integrator.render_with_vrls(
        scene, vrls, jax.random.key(1), cfg), n=1)
    evals = 1024 * 1024 * 512 * 4

    # gradient check on a small copy (deterministic keys -> FD is exact
    # up to float precision)
    import jax.numpy as jnp

    small = presets.cornell_smoke(width=32, height=32)
    # sigma/g checks: a FIXED VRL buffer (render-step gradients are
    # exact; tracer-side sampling is detached by design — see
    # media/homogeneous.sample_distance)
    vr_fixed = tracer.trace(small, jax.random.key(0), 32,
                            tracer.TracerConfig(max_depth=8))
    key = jax.random.key(2)
    grads_ok = {}
    for pname in ["sigma_a", "sigma_s", "g", "intensity"]:
        def f(x):
            med = small.medium
            em = small.emitters
            if pname == "sigma_a":
                med = med.replace(sigma_a=med.sigma_a + x)
            elif pname == "sigma_s":
                med = med.replace(sigma_s=med.sigma_s + x)
            elif pname == "g":
                med = med.replace(g=med.g + x)
            else:
                em = em.replace(intensity=em.intensity * (1.0 + x))
            sc = small.replace(medium=med, emitters=em)
            if pname == "intensity":
                vr = tracer.trace(sc, jax.random.key(0), 32,
                                  tracer.TracerConfig(max_depth=8))
            else:
                vr = vr_fixed
            img = integrator.render_with_vrls(
                sc, vr, key, VRLConfig(vrl_chunk=64), ray_tile=1024)
            return jnp.mean(img)

        g_ad = float(jax.grad(f)(jnp.float32(0.0)))
        eps = 2e-3
        g_fd = (float(f(jnp.float32(eps))) - float(f(jnp.float32(-eps)))) / (2 * eps)
        rel = abs(g_ad - g_fd) / max(abs(g_fd), 1e-9)
        grads_ok[pname] = {"ad": g_ad, "fd": g_fd, "rel_err": rel}

    return {
        "config": 5, "metric": "vrl_pair_sample_evals_per_s_per_chip",
        "value": evals / dt, "pass_seconds": dt,
        "gradients": grads_ok,
    }


CONFIGS = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}


def main():
    which = [int(a) for a in sys.argv[1:]] or sorted(CONFIGS)
    for c in which:
        t0 = time.time()
        res = CONFIGS[c]()
        res["total_seconds"] = time.time() - t0
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
