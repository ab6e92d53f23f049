"""Progressive multi-pass render driver.

Counterpart of ProgressiveMonteCarloIntegrator
(include/mitsuba/render/integrator.h:483-511,
src/librender/integrator.cpp:380-440): render N passes, re-tracing the
VRL set each pass (prepass) and accumulating the film; optionally dump
each pass image with wall/cpu timing and cumulative VRL-evaluation
counts embedded in the filename (dumpPass, integrator.cpp:361-378 +
passFileSuffix, vrlIntegrator.cpp:357-364) — the reference's equal-time
/ equal-work benchmarking machinery.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import jax
import numpy as np

from alvrl_tpu.core import rng
from alvrl_tpu.core.logging import get_logger
from alvrl_tpu.core.stats import STATS
from alvrl_tpu.integrators.vrl import alvrl as alvrl_mod
from alvrl_tpu.integrators.vrl import tracer as tracer_mod
from alvrl_tpu.integrators.vrl import vrl as vrl_mod
from alvrl_tpu.integrators.vrl.integrate import VRLConfig
from alvrl_tpu.integrators.vrl.integrator import render_with_vrls

log = get_logger("progressive")


@dataclass
class ProgressiveConfig:
    max_passes: int = 8
    dump_passes: bool = False
    dump_dir: str = "passes"
    dump_prefix: str = "pass"
    clustered: bool = False
    antialias: bool = True  # fresh sub-pixel jitter each pass
    checkpoint_path: str | None = None  # .npz accumulator for resume


def render_progressive(
    scene,
    key=None,
    prog: ProgressiveConfig = ProgressiveConfig(),
    params: "alvrl_mod.ALVRLParams" = None,
    cfg: VRLConfig = VRLConfig(),
    tracer_cfg: tracer_mod.TracerConfig = tracer_mod.TracerConfig(),
):
    """Accumulate `max_passes` independent VRL passes. Returns the
    averaged image (H, W, 3) as numpy."""
    if params is None:
        params = alvrl_mod.ALVRLParams()
    if key is None:
        key = jax.random.key(params.seed)

    accum = None
    start_pass = 0
    slice_info = None
    if prog.clustered:
        from alvrl_tpu.integrators.vrl.alvrl import build_slice_info

        with STATS.timed("slicing"):
            slice_info = build_slice_info(scene, params)
    # Resume from a checkpoint (the reference approximates this with
    # periodic partial-image flushes + the -x skip flag,
    # mitsuba.cpp:78-127; here the accumulator itself is durable)
    if prog.checkpoint_path and os.path.exists(prog.checkpoint_path):
        ck = np.load(prog.checkpoint_path)
        accum = ck["accum"]
        start_pass = int(ck["next_pass"])
        log.info("resuming at pass %d from %s", start_pass,
                 prog.checkpoint_path)
    c_vrls = STATS.counter("VRL integrator", "VRLs traced")
    c_evals = STATS.counter("VRL integrator", "VRL evaluations (render)")
    n_pix = scene.camera.width * scene.camera.height

    for p in range(start_pass, prog.max_passes):
        k_pass = rng.fold(key, p)
        t0 = time.perf_counter()
        with STATS.timed("pass"):
            if prog.clustered:
                img, vrls, _ = alvrl_mod.render_alvrl(
                    scene, k_pass, params, cfg, tracer_cfg,
                    slice_info=slice_info,
                )
            else:
                k_t, k_r = jax.random.split(k_pass)
                raw = tracer_mod.trace(
                    scene, k_t, params.num_particles, tracer_cfg
                )
                vrls = vrl_mod.compact(
                    raw, params.vrl_target_num,
                    slots_per_particle=tracer_cfg.max_depth,
                )
                img = render_with_vrls(
                    scene, vrls, k_r, cfg, antialias=prog.antialias
                )
            img = np.asarray(jax.block_until_ready(img))
        wall = time.perf_counter() - t0

        n_valid = int(np.asarray(vrls.valid).sum())
        c_vrls.add(n_valid)
        c_evals.add(n_pix * n_valid)
        accum = img if accum is None else accum + img
        log.info(
            "pass %d/%d: %.2fs wall, %d VRLs, mean %.4g",
            p + 1, prog.max_passes, wall, n_valid, float(img.mean()),
        )

        if prog.checkpoint_path:
            np.savez(prog.checkpoint_path, accum=accum, next_pass=p + 1)

        if prog.dump_passes:
            os.makedirs(prog.dump_dir, exist_ok=True)
            suffix = (
                f"_p{p:03d}_wall{wall:.3e}"
                f"_renvrl{c_evals.value:.4e}"
            )
            from alvrl_tpu.io import image as image_io

            image_io.write_npy(
                os.path.join(
                    prog.dump_dir, f"{prog.dump_prefix}{suffix}.npy"
                ),
                accum / (p + 1),
            )

    return accum / prog.max_passes
