"""SDS (specular-diffuse-specular) stress gate — VERDICT r04 item 5.

A glass sphere casts an area-light caustic on the floor; a glass pane
stands between the camera and the caustic, so every eye path to the
caustic is specular-bounded: the S...S | D | S...S family that the
reference's manifold exploration (src/libbidir/manifold.cpp,
mut_manifold.cpp) exists for. PSS-over-BDPT (our MLT) must reproduce
the caustic REGION-wise — per-block z-gates against the path-traced
ground truth inside the caustic crop, not an image mean (a mean-level
test cannot see a mis-weighted caustic that redistributes energy
spatially).

The heavier calibration run lives in scripts/sds_study.py
(data/sds_study.json); this test is a smaller repeatable gate at the
same geometry.
"""

import jax
import numpy as np
import pytest

from alvrl_tpu.integrators import mlt, surface


@pytest.mark.xfail(
    strict=False,
    reason="MEASURED round-5 finding (data/sds_study.json): PSS-over-"
           "BDPT recovers only ~8% of the SDS caustic-crop energy "
           "(max |z| ~ 30) at practical budgets — Kelemen mutations "
           "cannot explore specular-bounded caustic paths. This is "
           "the evidence that the reference's manifold/caustic "
           "mutations (mut_manifold.cpp, manifold.cpp) are "
           "functionally REQUIRED for the SDS family; porting them is "
           "round-6 item 1. The test stays as the canary: it flips to "
           "PASS when a manifold-capable mutator lands.")
def test_sds_caustic_region_mlt_vs_path():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from scripts.sds_study import block_means, sds_scene

    scene = sds_scene(48)
    k_runs = 3
    runs_gt = [
        np.asarray(surface.render_path(scene, jax.random.key(100 + i),
                                       spp=384, max_depth=8,
                                       ray_tile=1152))
        for i in range(k_runs)
    ]
    cfg_m = mlt.MLTConfig(n_eye=5, n_light=4, n_chains=1024,
                          n_mutations=160)
    runs_ml = [
        np.asarray(mlt.render_mlt(scene, jax.random.key(300 + i),
                                  cfg_m))
        for i in range(k_runs)
    ]

    bs = 4
    gt_blocks = np.stack([block_means(r, bs) for r in runs_gt])
    gt_mean = gt_blocks.mean(axis=0)
    hh = gt_mean.shape[0] // 2
    floor_med = np.median(gt_mean[hh:])
    crop = np.zeros_like(gt_mean, bool)
    crop[hh:] = gt_mean[hh:] > 1.5 * floor_med
    # the caustic exists (3-4x floor brightness at the focus; absent
    # before the round-5 sphere/cube winding fix made glass converge)
    assert crop.sum() >= 3, int(crop.sum())

    ml_blocks = np.stack([block_means(r, bs) for r in runs_ml])
    m = ml_blocks.mean(axis=0)
    v = ml_blocks.var(axis=0, ddof=1) / k_runs \
        + gt_blocks.var(axis=0, ddof=1) / k_runs
    z = (m - gt_mean) / np.sqrt(np.maximum(v, 1e-12))
    zc = np.abs(z[crop])
    # region-wise gates (calibrated against scripts/sds_study.py's
    # measured self-noise): no block may sit grossly off, and the
    # crop's total energy must match within a few percent
    assert (zc > 6.0).mean() <= 0.12, (zc.max(), (zc > 6).mean())
    ratio = float(m[crop].mean() / gt_mean[crop].mean())
    assert 0.85 < ratio < 1.15, ratio
