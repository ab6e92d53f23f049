"""Adaptive (error-controlled) meta-integrator.

Counterpart of the `adaptive` plugin (src/integrators/misc/adaptive.cpp):
repeatedly invokes a sub-integrator per pixel until the luminance sample
mean satisfies a relative-error bound with a given confidence (Z-test),
or a maximum sample factor is reached. Semantics preserved:

  * preprocess estimates the average image-plane luminance with random
    samples (adaptive.cpp:131-160, nSamples=10000);
  * quantile = Phi^-1(1 - pValue/2) (adaptive.cpp:162-163);
  * per pixel, after every `base_spp` samples: stop when
      quantile * sqrt(var/n) <= maxError * max(mean, 0.01 * avgLum)
    (adaptive.cpp:252-270), hard cap at maxSampleFactor * base_spp;
  * per-pixel mean/variance by Knuth online update (adaptive.cpp:245-248)
    — here the batched Welford-merge equivalent.

Array-native design: instead of a per-pixel while-loop (divergent,
scalar), sampling proceeds in ROUNDS of base_spp samples for the set of
still-unconverged pixels. Each round compacts the active pixel indices
host-side into a dense ray batch (padded to a power-of-two bucket to
bound recompiles) so device work shrinks with the active set — the
vector-machine version of "pixels that pass the Z-test stop sampling".
"""

from __future__ import annotations

from functools import partial
from statistics import NormalDist

import jax
import jax.numpy as jnp
import numpy as np

from alvrl_tpu.core import rng
from alvrl_tpu.core import spectrum as spec
from alvrl_tpu.scene.scene import Scene
from alvrl_tpu.sensors import perspective


def _default_li(scene, o, d, key):
    from alvrl_tpu.integrators.volpath import VolpathConfig, li_volpath

    return li_volpath(scene, o, d, key, VolpathConfig(max_depth=8))


_LI_TILE = 2048


def _li_tiled(scene: Scene, li_fn, key, o, d):
    """Evaluate li_fn over a flat ray batch in fixed-size tiles
    (explicit pad+reshape; per-ray keys derived from (tile, lane))."""
    n = o.shape[0]
    tile = min(_LI_TILE, n)
    n_t = -(-n // tile)
    pad = n_t * tile - n
    op = jnp.pad(o, ((0, pad), (0, 0)))
    dp = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)

    def tile_fn(args):
        t_idx, o_t, d_t = args
        keys = jax.vmap(lambda j: rng.fold(key, t_idx, j))(
            jnp.arange(tile))
        return jax.vmap(lambda oo, dd, kk: li_fn(scene, oo, dd, kk))(
            o_t, d_t, keys)

    if n_t == 1:
        # single tile: skip the scan (faster, and a multi-tile scan
        # compiled earlier in the process poisons a later length-1 scan
        # of the same body in this jax build's dispatch cache)
        return tile_fn((jnp.int32(0), op, dp))[:n]
    li = jax.lax.map(
        tile_fn,
        (jnp.arange(n_t), op.reshape(n_t, tile, 3),
         dp.reshape(n_t, tile, 3)),
    )
    return li.reshape(-1, 3)[:n]


_AVG_SAMPLES = 10240


def _round_fun(li_fn, base_spp: int, n: int):
    """The sampling-round computation for one (sub-integrator, spp, n)."""

    def f(scene: Scene, px, py, key):
        k1, k2 = jax.random.split(jnp.asarray(key))
        jit_u = jax.random.uniform(k1, (base_spp * n, 2))
        px_r = jnp.tile(px, base_spp)
        py_r = jnp.tile(py, base_spp)
        o, d = perspective.sample_ray(scene.camera, px_r, py_r,
                                      jitter=jit_u)
        li = _li_tiled(scene, li_fn, k2, o, d)
        li = li.reshape(base_spp, n, 3)
        lum = spec.luminance(li)
        return li.sum(0), lum.sum(0), (lum * lum).sum(0)

    return f


class _Round:
    """ONE AOT-compiled fixed-size sampling round per adaptive render.

    Multiple differently-sized instances of this computation in one
    process trip a dispatch bug in the bundled jax build: after a
    second size is traced, executables' parameter lists disagree with
    the dispatch path's argument lists ("Execution supplied 53 buffers
    but compiled program expected 86/96") — under plain jit,
    keep_unused, per-signature jit objects, scene-as-closure, AOT
    compilation, and any compile/warm ordering tried. A single
    fixed-size executable per (scene, li_fn) sidesteps the bug
    entirely — and the fixed batch is not a compromise: instead of
    compacting a shrinking active set, each round PACKS REPEATS of the
    active pixels into the full batch (per-lane keys/jitters are
    already independent), so device utilization stays at 100% and
    unconverged pixels converge in fewer rounds.
    """

    def __init__(self, scene, li_fn, base_spp: int, n: int):
        self.n = n
        self.base_spp = base_spp
        key = jax.random.key(0)
        z = jnp.zeros((n,), jnp.int32)
        self._c = jax.jit(
            _round_fun(li_fn, base_spp, n)
        ).lower(scene, z, z, key).compile()

    def __call__(self, scene, px, py, key):
        return self._c(scene, px, py, key)


def render_adaptive(
    scene: Scene,
    key,
    li_fn=None,
    base_spp: int = 8,
    max_error: float = 0.05,
    p_value: float = 0.05,
    max_sample_factor: int = 32,
    avg_luminance: float | None = None,
    verbose: bool = False,
):
    """Adaptive render -> (image (H, W, 3), spp_map (H, W) int32).

    li_fn(scene, o, d, key) -> (3,) radiance; defaults to the
    volumetric path tracer. base_spp is the reference's
    sampler.sampleCount (>= 8 there); max_sample_factor < 0 means
    unbounded (here: 256 rounds)."""
    if li_fn is None:
        li_fn = _default_li
    cam = scene.camera
    w, h = cam.width, cam.height
    n_pix = w * h
    quantile = NormalDist().inv_cdf(1.0 - p_value / 2.0)
    max_rounds = max_sample_factor if max_sample_factor >= 0 else 256

    top = 1 << max(8, int(np.ceil(np.log2(n_pix))))
    rnd_exec = _Round(scene, li_fn, base_spp, top)

    px_all, py_all = np.meshgrid(np.arange(w), np.arange(h))
    px_all = px_all.reshape(-1).astype(np.int32)
    py_all = py_all.reshape(-1).astype(np.int32)

    if avg_luminance is None:
        # adaptive.cpp preprocess: ~10k random image-plane samples,
        # through the same compiled round
        n_avg_rounds = max(1, -(-_AVG_SAMPLES // (top * base_spp)))
        tot = 0.0
        for i in range(n_avg_rounds):
            k1, k2 = jax.random.split(rng.fold(key, 999, i))
            u = jax.random.uniform(k1, (top, 2))
            apx = jnp.floor(u[:, 0] * w).astype(jnp.int32)
            apy = jnp.floor(u[:, 1] * h).astype(jnp.int32)
            _, s_lum, _ = rnd_exec(scene, apx, apy, k2)
            tot += float(jnp.sum(s_lum))
        avg_luminance = tot / (n_avg_rounds * top * base_spp)

    sum_rgb = np.zeros((n_pix, 3), np.float32)
    sum_lum = np.zeros((n_pix,), np.float32)
    sum_lum2 = np.zeros((n_pix,), np.float32)
    counts = np.zeros((n_pix,), np.int64)
    active = np.arange(n_pix)

    for rnd in range(max_rounds):
        if active.size == 0:
            break
        # pack repeats of the active pixels into the fixed batch
        # (duplicate lanes draw independent jitters/keys; scatter-add
        # accumulation handles the multiplicity). Lanes that would
        # push a pixel past maxSampleFactor are rendered but discarded
        # so the cap holds exactly.
        reps = -(-top // active.size)
        idx = np.tile(active, reps)[:top]
        occ = np.arange(top) // active.size    # occurrence # per lane
        if max_sample_factor >= 0:
            allowed = (max_sample_factor * base_spp
                       - counts[idx]) // base_spp
            keep = occ < np.maximum(allowed, 1)  # >= 1 round each
        else:
            keep = np.ones(top, bool)
        r_rgb, r_lum, r_lum2 = rnd_exec(
            scene, jnp.asarray(px_all[idx]), jnp.asarray(py_all[idx]),
            rng.fold(key, rnd))
        idx_k = idx[keep]
        np.add.at(sum_rgb, idx_k, np.asarray(r_rgb)[keep])
        np.add.at(sum_lum, idx_k, np.asarray(r_lum)[keep])
        np.add.at(sum_lum2, idx_k, np.asarray(r_lum2)[keep])
        np.add.at(counts, idx_k, base_spp)

        n = counts[active].astype(np.float64)
        mean = sum_lum[active] / n
        # unbiased sample variance from raw moments
        var = np.maximum(
            (sum_lum2[active] - n * mean * mean) / np.maximum(n - 1, 1),
            0.0)
        ci_width = quantile * np.sqrt(var / n)
        base = np.maximum(mean, avg_luminance * 0.01)
        over_cap = counts[active] >= max_sample_factor * base_spp \
            if max_sample_factor >= 0 else np.zeros(active.size, bool)
        converged = (ci_width <= max_error * base) | over_cap
        if verbose:
            print(f"round {rnd}: active {active.size}, "
                  f"converged {int(converged.sum())}")
        active = active[~converged]

    img = sum_rgb / np.maximum(counts[:, None], 1)
    return (img.reshape(h, w, 3).astype(np.float32),
            counts.reshape(h, w).astype(np.int32))
