"""Roofline of the VRL pair estimator.

The work per pair-sample is XLA's own count for the plain XLA path
(integrator.li_unclustered -> integrate.pair_contribution) on BASELINE
config-1 shapes; the fused kernel (ops.pair_kernel) computes the same
estimator at the same uniforms. Dividing a measured rate from the GPU
by the card's peaks gives the roofline share; the device-memory bytes
are those of the XLA path, which the kernel no longer moves.

Flop counting is platform independent, so this runs on the CPU:
    python scripts/roofline.py --device-kind "NVIDIA H100 80GB HBM3" \
        --evals-per-s <pair-sample evals/s from a GPU run>
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

# Published peaks by jax device_kind: fp32 outside the tensor cores
# (this integrand is scalar fp32 work) and device-memory bandwidth.
# Source: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(fp32_flops=67e12, mem_bytes_per_s=3.35e12,
                                  source="NVIDIA H100 SXM data sheet"),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device-kind", required=True)
    ap.add_argument("--evals-per-s", type=float, required=True,
                    help="measured pair-sample evals/s on that device")
    args = ap.parse_args()
    if args.device_kind not in PEAKS:
        sys.exit(f"no peaks recorded for device kind {args.device_kind!r}")
    peak = PEAKS[args.device_kind]

    from alvrl_tpu.integrators.vrl import vrl as vrl_mod
    from alvrl_tpu.integrators.vrl.integrate import VRLConfig
    from alvrl_tpu.integrators.vrl import integrator as vint
    from alvrl_tpu.media import api as mapi
    from alvrl_tpu.scene import presets
    from alvrl_tpu.sensors import perspective

    width = height = 128
    n_vrls = 512
    cfg = VRLConfig(vol_vol_samples=2, vol_surf_samples=2, vrl_chunk=128)
    scene = mapi.prepare_scene(
        presets.cornell_smoke(width=width, height=height))

    vrl_path = os.path.join(os.path.dirname(__file__), "..", "data",
                            "bench_vrls.txt")
    vrls = vrl_mod.load_ascii(vrl_path, particle_count=78.0)
    vrls = vrl_mod.compact(vrls, n_vrls)

    key = jax.random.key(1)
    px, py = jnp.meshgrid(jnp.arange(width), jnp.arange(height))
    ray_o, ray_d = perspective.sample_ray(
        scene.camera, px.reshape(-1), py.reshape(-1))

    fn = jax.jit(
        lambda s, o, d, v, k: vint.li_unclustered(s, o, d, v, k, cfg)
    )
    lowered = fn.lower(scene, ray_o, ray_d, vrls, key)
    cost = lowered.compile().cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    flops = float(cost.get("flops", 0.0))
    bytes_hbm = float(cost.get("bytes accessed", 0.0))
    trans = float(cost.get("transcendentals", 0.0))

    n_rays = width * height
    pair_samples = n_rays * n_vrls * (cfg.vol_vol_samples
                                      + cfg.vol_surf_samples)
    f_per_eval = flops / pair_samples
    b_per_eval = bytes_hbm / pair_samples
    sustained = args.evals_per_s * f_per_eval
    out = {
        "device_kind": args.device_kind,
        "peaks": peak,
        "flops_per_pair_sample": f_per_eval,
        "transcendentals_per_pair_sample": trans / pair_samples,
        "mem_bytes_per_pair_sample_xla_path": b_per_eval,
        "arithmetic_intensity_xla_path": f_per_eval / b_per_eval,
        "ridge_flops_per_byte": peak["fp32_flops"] / peak["mem_bytes_per_s"],
        "measured_evals_per_s": args.evals_per_s,
        "sustained_fp32_flops": sustained,
        "fp32_roofline_share": sustained / peak["fp32_flops"],
    }
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
