"""Clustered host-stage pipelining benchmark (VERDICT r04 item 6).

Measures N clustered passes two ways on the attached device:
  serial:    N x render_alvrl (trace -> R -> transfer -> host
             clustering -> render, strictly in sequence)
  pipelined: render_alvrl_progressive (pass k+1's R transfer + host
             clustering overlapped with pass k's render; slicing /
             localities amortized across passes)

Prints wall/pass for both and the pipelined stage split. The success
criterion from the VERDICT: pipelined steady-state wall/pass ~
max(device stages, host stages) instead of their sum.

Usage: python scripts/bench_pipeline.py [n_passes] [size] [hetero01]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import scripts._cache  # noqa: F401

import jax

from alvrl_tpu.integrators.vrl import alvrl
from alvrl_tpu.integrators.vrl.integrate import VRLConfig
from alvrl_tpu.scene import presets


def main():
    n_passes = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    size = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    hetero = bool(int(sys.argv[3])) if len(sys.argv) > 3 else False

    if hetero:
        scene = presets.cornell_grid_smoke(width=size, height=size,
                                           grid_res=48)
    else:
        scene = presets.cornell_smoke(width=size, height=size)
    params = alvrl.ALVRLParams(vrl_target_num=2048, num_particles=256)
    cfg = VRLConfig(vol_vol_samples=2, vol_surf_samples=2)
    key = jax.random.key(0)

    # warmup/compile both paths once (one pass each)
    print("warmup (compiles)...", file=sys.stderr)
    t0 = time.time()
    img, vrls, _ = alvrl.render_alvrl(scene, key, params, cfg)
    jax.block_until_ready(img)
    print(f"warmup serial pass: {time.time() - t0:.1f}s",
          file=sys.stderr)

    # serial arm
    t0 = time.time()
    si = alvrl.build_slice_info(scene, params)
    for k in range(n_passes):
        img, vrls, _ = alvrl.render_alvrl(
            scene, jax.random.fold_in(key, k), params, cfg, slice_info=si)
        jax.block_until_ready(img)
    serial_pp = (time.time() - t0) / n_passes
    print(f"serial: {serial_pp * 1e3:.0f} ms/pass", file=sys.stderr)

    # pipelined arm (run twice: the first run may pay table-width
    # recompiles for widths the serial warmup never saw; steady state
    # is the second run)
    tms = {"verbose": 1}
    t0 = time.time()
    img2, _, _ = alvrl.render_alvrl_progressive(
        scene, n_passes, key, params, cfg,
        timings=tms)
    jax.block_until_ready(img2)
    print(f"pipelined cold: {(time.time()-t0)/n_passes*1e3:.0f} ms/pass",
          file=sys.stderr)
    tms = {"verbose": 1}
    t0 = time.time()
    img2, _, _ = alvrl.render_alvrl_progressive(
        scene, n_passes, key, params, cfg,
        timings=tms)
    jax.block_until_ready(img2)
    pipe_pp = (time.time() - t0) / n_passes
    print(f"pipelined: {pipe_pp * 1e3:.0f} ms/pass  "
          f"(stages/pass: enqueue "
          f"{tms['device_enqueue'] / n_passes * 1e3:.0f} ms, transfer "
          f"{tms['transfer'] / n_passes * 1e3:.0f} ms, cluster "
          f"{tms['cluster'] / n_passes * 1e3:.0f} ms, slice once "
          f"{tms['slice'] * 1e3:.0f} ms)", file=sys.stderr)

    mean_ratio = float(abs(img.mean() - img2.mean())
                       / max(float(img.mean()), 1e-9))
    print(json.dumps({
        "n_passes": n_passes, "size": size, "hetero": hetero,
        "serial_ms_per_pass": serial_pp * 1e3,
        "pipelined_ms_per_pass": pipe_pp * 1e3,
        "speedup": serial_pp / pipe_pp,
        "stage_ms": {k: v / n_passes * 1e3 for k, v in tms.items()
                     if k != "slice"},
        "slice_once_ms": tms["slice"] * 1e3,
        "img_mean_rel_diff_vs_serial_last_pass": mean_ratio,
    }))


if __name__ == "__main__":
    main()
