"""Native (C++) backend for the Adaptive LightSlice clustering.

Counterpart of the reference's ClusterRefiner thread fan-out
(src/integrators/vrl/Preprocessor.cpp:722-773): the adaptive refinement
is inherently sequential per slice but embarrassingly parallel across
slices — the numpy implementation in cluster.py (the executable spec)
runs it single-threaded in Python and costs 0.5-2.7 s per warm pass on
the BASELINE configs; this backend runs the identical cost model in
native/cluster_refine.cpp across all cores.

The two backends are statistically equivalent, not bitwise: seed-column
and representative sampling draw from different RNG streams (xoshiro256++
vs numpy PCG64). Everything deterministic — column weights, cluster
variances, split points given seeds, the convergence constant — follows
the same formulas.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "native"))
_LIB_PATH = os.path.join(_NATIVE_DIR, "libalvrl_cluster.so")

_lib = None


def _build():
    """Build the library from native/Makefile at first use. Concurrent
    processes serialize on a lock file; a failed build raises with the
    compiler's output."""
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(_LIB_PATH):
            return
        r = subprocess.run(["make", "-C", _NATIVE_DIR, "libalvrl_cluster.so"],
                           capture_output=True, text=True)
        if r.returncode != 0 or not os.path.exists(_LIB_PATH):
            raise RuntimeError(
                "building native/libalvrl_cluster.so failed:\n"
                + r.stdout + r.stderr)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        _build()
    lib = ctypes.CDLL(_LIB_PATH)
    c_dp = ctypes.POINTER(ctypes.c_double)
    c_ip = ctypes.POINTER(ctypes.c_int64)
    lib.alvrl_cluster_refine.restype = ctypes.c_int64
    lib.alvrl_cluster_refine.argtypes = [
        c_dp, c_dp, c_dp,                      # mean, var, loc_w
        ctypes.c_int64, ctypes.c_int64,        # P, N
        c_ip, ctypes.c_int64, c_ip,            # init_offsets, n_init, init_cols
        ctypes.c_double, ctypes.c_double,      # pu, depth_correction
        ctypes.c_double, ctypes.c_int,         # undersampling, do_refine
        ctypes.c_uint64,                       # seed
        c_ip, c_dp,                            # out_ids, out_ws
        c_ip, c_ip, c_ip,                      # out_cl_offsets/cols/n (nullable)
    ]
    lib.alvrl_cluster_slices.restype = ctypes.c_int64
    lib.alvrl_cluster_slices.argtypes = [
        c_dp, c_dp, ctypes.c_int64, ctypes.c_int64,
        c_ip, c_ip, c_dp, c_dp, ctypes.c_int64,
        c_ip, ctypes.c_int64, c_ip,
        ctypes.c_double, ctypes.c_double, ctypes.c_int,
        c_ip, c_dp, ctypes.c_int64,
        ctypes.c_uint64, ctypes.c_int64,
        c_ip, c_dp, ctypes.c_int64, c_ip,
    ]
    _lib = lib
    return lib


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _as_offsets(clusters):
    offsets = np.zeros(len(clusters) + 1, np.int64)
    for i, c in enumerate(clusters):
        offsets[i + 1] = offsets[i] + len(c)
    cols = (np.concatenate([np.asarray(c, np.int64) for c in clusters])
            if clusters else np.zeros((0,), np.int64))
    return offsets, cols


def refine(mean, var, loc_w, init_clusters, pixel_undersampling,
           depth_correction, undersampling, do_refine, seed,
           want_clusters=False):
    """One Clustering: init -> (refine) -> sample representatives.
    Returns (ids, ws) or (ids, ws, clusters) — ids is None when
    refine() reports zero unclustered variance (caller falls back)."""
    lib = _load()
    mean = np.ascontiguousarray(mean, np.float64)
    var = np.ascontiguousarray(var, np.float64)
    loc_w = np.ascontiguousarray(loc_w, np.float64)
    p, n = mean.shape
    offsets, cols = _as_offsets(init_clusters)
    total = len(cols)
    out_ids = np.zeros(max(total, 1), np.int64)
    out_ws = np.zeros(max(total, 1), np.float64)
    if want_clusters:
        cl_off = np.zeros(total + 2, np.int64)
        cl_cols = np.zeros(max(total, 1), np.int64)
        n_cl = np.zeros(1, np.int64)
        cl_args = (_ip(cl_off), _ip(cl_cols), _ip(n_cl))
    else:
        cl_args = (None, None, None)
    rc = lib.alvrl_cluster_refine(
        _dp(mean), _dp(var), _dp(loc_w), p, n,
        _ip(offsets), len(init_clusters), _ip(cols),
        float(pixel_undersampling), float(depth_correction),
        float(undersampling), int(do_refine), int(seed) & (2**64 - 1),
        _ip(out_ids), _dp(out_ws), *cl_args,
    )
    if rc < 0:
        return (None, None, None) if want_clusters else (None, None)
    ids, ws = out_ids[:rc].copy(), out_ws[:rc].copy()
    if not want_clusters:
        return ids, ws
    k = int(n_cl[0])
    clusters = [cl_cols[cl_off[i]:cl_off[i + 1]].copy() for i in range(k)]
    return ids, ws, clusters


def build_clusters(R_mean, R_var, rows_per_slice, slice_undersampling,
                   global_pixel_undersampling, localities, params, rng):
    """Native build_clusters — same pipeline as cluster.build_clusters
    (global cluster -> fall-back -> threaded per-slice refinement)."""
    lib = _load()
    R_mean = np.ascontiguousarray(R_mean, np.float64)
    R_var = np.ascontiguousarray(R_var, np.float64)
    p_total, n_vrls = R_mean.shape
    seed = int(rng.integers(0, 2**63 - 1))

    # 1) zero-contribution quarantine
    col_total = R_mean.sum(axis=0)
    nonzero = np.nonzero(col_total != 0)[0]
    zero = np.nonzero(col_total == 0)[0]
    uniform_loc = np.full((p_total,), 1.0 / max(p_total, 1))

    if len(nonzero) > 0 and params.global_cluster:
        _, _, vrls_per_cluster = refine(
            R_mean, R_var, uniform_loc, [nonzero],
            global_pixel_undersampling, 1.0,
            params.global_undersampling, 1, seed + 1, want_clusters=True,
        )
        if vrls_per_cluster is None:
            vrls_per_cluster = [nonzero]
    elif len(nonzero) > 0:
        vrls_per_cluster = [nonzero]
    else:
        vrls_per_cluster = []
    if len(zero) > 0:
        vrls_per_cluster = vrls_per_cluster + [zero]

    # 2) global representatives + fall-back refinement
    gc_ids, gc_w = refine(R_mean, R_var, uniform_loc, vrls_per_cluster,
                          global_pixel_undersampling, 1.0, -1.0, 0, seed + 2)
    fb = refine(R_mean, R_var, uniform_loc, vrls_per_cluster,
                global_pixel_undersampling, 1.0,
                params.fallback_undersampling, 1, seed + 3)
    fb_ids, fb_w = (gc_ids, gc_w) if fb[0] is None else fb

    # 3) per-slice refinement (threaded in C++)
    s = len(rows_per_slice)
    if s == 0:
        return [], [], fb_ids, fb_w, gc_ids, gc_w
    rows_cat = []
    locs_cat = []
    row_offsets = np.zeros(s + 1, np.int64)
    for i in range(s):
        rows = [np.asarray(rows_per_slice[i], np.int64)]
        if params.neighbour_weight > 0 and localities[i]:
            nb_w = []
            for (j, dist) in localities[i]:
                rows.append(np.asarray(rows_per_slice[j], np.int64))
                nb_w.append(1.0 / max(dist, 1e-30))
            summed_nb = sum(nb_w)
            slice_w = (summed_nb * (1 - params.neighbour_weight)
                       / params.neighbour_weight)
            norm = 1.0 / (slice_w + summed_nb)
            weights = [np.full(len(rows[0]), slice_w * norm / len(rows[0]))]
            for k, (j, dist) in enumerate(localities[i]):
                weights.append(
                    np.full(len(rows[k + 1]), nb_w[k] * norm / len(rows[k + 1]))
                )
            loc_w = np.concatenate(weights)
        else:
            loc_w = np.full(len(rows[0]), 1.0 / max(len(rows[0]), 1))
        row_idx = np.concatenate(rows)
        rows_cat.append(row_idx)
        locs_cat.append(loc_w)
        row_offsets[i + 1] = row_offsets[i] + len(row_idx)
    slice_rows = np.concatenate(rows_cat)
    slice_loc = np.ascontiguousarray(np.concatenate(locs_cat), np.float64)
    slice_u = np.ascontiguousarray(slice_undersampling, np.float64)

    offsets, cols = _as_offsets(vrls_per_cluster)
    cap = max(n_vrls, len(fb_ids), 1)
    out_ids = np.zeros((s, cap), np.int64)
    out_ws = np.zeros((s, cap), np.float64)
    out_counts = np.zeros(s, np.int64)
    fb_ids64 = np.ascontiguousarray(fb_ids, np.int64)
    fb_w64 = np.ascontiguousarray(fb_w, np.float64)
    rc = lib.alvrl_cluster_slices(
        _dp(R_mean), _dp(R_var), p_total, n_vrls,
        _ip(row_offsets), _ip(slice_rows), _dp(slice_loc), _dp(slice_u), s,
        _ip(offsets), len(vrls_per_cluster), _ip(cols),
        float(params.depth_correction), float(params.local_undersampling),
        int(params.local_refinement),
        _ip(fb_ids64), _dp(fb_w64), len(fb_ids64),
        seed + 5, 0,
        _ip(out_ids), _dp(out_ws), cap, _ip(out_counts),
    )
    if rc != 0:
        raise RuntimeError("alvrl_cluster_slices: output capacity exceeded")
    slice_ids = [out_ids[i, : out_counts[i]].copy() for i in range(s)]
    slice_ws = [out_ws[i, : out_counts[i]].copy() for i in range(s)]
    return slice_ids, slice_ws, fb_ids, fb_w, gc_ids, gc_w
