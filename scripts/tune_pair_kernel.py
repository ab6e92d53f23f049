"""Time the fused pair kernel against the XLA pair sum on the GPU.

For BASELINE config 1 (Cornell smoke, 128x128 rays, 512 VRLs) and a
1024-wide band of config 5 (1024 x 64 rays, 512 VRLs), this compiles the
kernel for each block shape in BLOCKS, checks it against
integrate.pair_sum at the same hash uniforms, and prints the median of
warm passes for the kernel and for the XLA render path
(integrator.vrl_sum at its default tiling). One JSON line per case.

    python scripts/tune_pair_kernel.py            # on the GPU
    python scripts/tune_pair_kernel.py --interpret  # CPU rehearsal, tiny
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

BLOCKS = [(32, 16, 4), (16, 16, 4), (32, 32, 4), (64, 16, 4), (32, 16, 8),
          (64, 32, 8), (128, 16, 8), (16, 32, 4)]


def _median_time(fn, reps):
    fn().block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn().block_until_ready()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], times


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--interpret", action="store_true")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()

    import jax

    from alvrl_tpu import compile_cache

    compile_cache.enable()
    if jax.devices()[0].platform != "gpu" and not args.interpret:
        sys.exit("no GPU: pass --interpret for a CPU rehearsal")
    import jax.numpy as jnp
    import numpy as np

    from alvrl_tpu.core import rng
    from alvrl_tpu.integrators.vrl import integrate, integrator
    from alvrl_tpu.integrators.vrl import vrl as vrl_mod
    from alvrl_tpu.integrators.vrl.integrate import VRLConfig
    from alvrl_tpu.ops import pair_kernel
    from alvrl_tpu.scene import presets
    from alvrl_tpu.sensors import perspective

    if not args.interpret:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    d0 = jax.devices()[0]
    print(f"device {d0.platform} {d0.device_kind} x{len(jax.devices())}",
          flush=True)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    vrls = vrl_mod.compact(vrl_mod.load_ascii(
        os.path.join(root, "data", "bench_vrls.txt"), particle_count=78.0),
        512)
    cfg = VRLConfig()
    if args.interpret:
        cases = [("tiny", 8, 8, 8)]
        vrls = vrls.replace(start=vrls.start[:48], end=vrls.end[:48],
                            power=vrls.power[:48], valid=vrls.valid[:48])
        blocks = [(16, 16, 4)]
    else:
        cases = [("config1_128x128", 128, 128, 128),
                 ("config5_band_1024x64", 1024, 1024, 64)]
        blocks = BLOCKS

    for name, w, h, rows in cases:
        scene = presets.cornell_smoke(width=w, height=h)
        px, py = jnp.meshgrid(jnp.arange(w), jnp.arange(rows))
        ray_o, ray_d = perspective.sample_ray(scene.camera, px.reshape(-1),
                                              py.reshape(-1))
        hit = integrator.trace_eye_rays(scene, ray_o, ray_d)
        key = jax.random.key(7)
        seed = rng.seed_bits(key)
        hit_args = (ray_o, ray_d, hit.p, hit.valid, hit.ng, hit.mat)
        vrl_args = (vrls.start, vrls.end, vrls.power, vrls.valid)

        @jax.jit
        def reference(scene, o, d, hp, hv, hn, hm, vs, ve, vp, vv, seed):
            with jax.default_matmul_precision("highest"):
                return integrate.pair_sum(scene, o, d, hp, hv, hn, hm,
                                          vs[None], ve[None], vp[None],
                                          vv[None], seed, cfg)

        ref = np.asarray(reference(scene, *hit_args, *vrl_args, seed))
        n_pair_samples = ray_o.shape[0] * vrls.capacity * (
            cfg.vol_vol_samples + cfg.vol_surf_samples)
        xla_path = jax.jit(lambda sc, o, d, k: integrator.li_unclustered(
            sc, o, d, vrls, k, cfg.replace(fused_kernel=False)))
        t_xla, _ = _median_time(lambda: xla_path(scene, ray_o, ray_d, key),
                                args.reps)
        print(json.dumps(dict(case=name, path="xla_li_unclustered",
                              median_s=t_xla,
                              pair_sample_evals_per_s=n_pair_samples / t_xla)),
              flush=True)
        for block in blocks:
            fn = jax.jit(lambda sc, *a, block=block: pair_kernel.pair_sum(
                cfg, sc, *a, interpret=args.interpret, block=block))
            t0 = time.perf_counter()
            out = np.asarray(fn(scene, *hit_args, *vrl_args, seed))
            compile_s = time.perf_counter() - t0
            err = np.abs(out - ref)
            tol = 1e-3 * np.abs(ref) + 1e-6 * np.abs(ref).mean()
            t_k, times = _median_time(
                lambda: fn(scene, *hit_args, *vrl_args, seed), args.reps)
            print(json.dumps(dict(
                case=name, path="kernel", block=block, compile_s=compile_s,
                median_s=t_k, min_s=times[0], max_s=times[-1],
                pair_sample_evals_per_s=n_pair_samples / t_k,
                max_abs_err=float(err.max()),
                rays_over_tol=int((err > tol).sum()),
                mean_rel_diff=float(abs(out.mean() - ref.mean())
                                    / abs(ref.mean())),
            )), flush=True)
    if not args.interpret:
        stats = jax.devices()[0].memory_stats() or {}
        print("peak_bytes_in_use", stats.get("peak_bytes_in_use"))


if __name__ == "__main__":
    main()
