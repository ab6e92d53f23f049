"""BVH: native binned-SAH build + device traversal.

Array-native replacement for the reference's SAH kd-tree
(gkdtree.h/sahkdtree3.h/skdtree.h): the *build* runs in C++
(native/bvh_builder.cpp, loaded via ctypes — same native-build stance
as the reference, minus the plugin loader), the *traversal* is a
short-stack `lax.while_loop` over flattened node arrays, vmappable over
ray batches.

For benchmark-scale scenes the brute-force vectorized intersector
(geometry.intersect) wins on a vector machine; the BVH is the large-mesh
path (see scene-level dispatch thresholds in callers).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from alvrl_tpu.core import math as m

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libalvrl_native.so")
_lib = None

STACK_DEPTH = 64


def _load_native():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        subprocess.run(
            ["make", "-C", _NATIVE_DIR], check=True, capture_output=True
        )
    _lib = ctypes.CDLL(_LIB_PATH)
    _lib.bvh_build.restype = ctypes.c_int
    _lib.bvh_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    return _lib


class BVH(NamedTuple):
    bounds_lo: jax.Array   # (N, 3)
    bounds_hi: jax.Array   # (N, 3)
    left: jax.Array        # (N,)
    right: jax.Array       # (N,)
    prim_start: jax.Array  # (N,)
    prim_count: jax.Array  # (N,)
    prim_order: jax.Array  # (T,) triangle indices, leaf-contiguous
    # leaf-ordered triangle data (gather once at build time):
    tri_p0: jax.Array      # (T, 3)
    tri_e1: jax.Array
    tri_e2: jax.Array


def build(verts, faces, leaf_size: int = 4) -> BVH:
    """Host-side native build; returns device-ready flat arrays."""
    lib = _load_native()
    verts = np.ascontiguousarray(np.asarray(verts), np.float32)
    faces = np.ascontiguousarray(np.asarray(faces), np.int32)
    t = len(faces)
    cap = max(2 * t, 1)
    out_bounds = np.zeros((cap, 6), np.float32)
    out_meta = np.zeros((cap, 4), np.int32)
    out_order = np.zeros((t,), np.int32)
    n_nodes = lib.bvh_build(
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(verts),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), t, leaf_size,
        out_bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    bounds = out_bounds[:n_nodes]
    meta = out_meta[:n_nodes]
    p0 = verts[faces[out_order][:, 0]]
    p1 = verts[faces[out_order][:, 1]]
    p2 = verts[faces[out_order][:, 2]]
    return BVH(
        bounds_lo=jnp.asarray(bounds[:, 0:3]),
        bounds_hi=jnp.asarray(bounds[:, 3:6]),
        left=jnp.asarray(meta[:, 0]),
        right=jnp.asarray(meta[:, 1]),
        prim_start=jnp.asarray(meta[:, 2]),
        prim_count=jnp.asarray(meta[:, 3]),
        prim_order=jnp.asarray(out_order),
        tri_p0=jnp.asarray(p0),
        tri_e1=jnp.asarray(p1 - p0),
        tri_e2=jnp.asarray(p2 - p0),
    )


def _slab_test(bvh, node, o, inv_d, t_min, t_max):
    lo = (bvh.bounds_lo[node] - o) * inv_d
    hi = (bvh.bounds_hi[node] - o) * inv_d
    near = jnp.minimum(lo, hi)
    far = jnp.maximum(lo, hi)
    t0 = jnp.maximum(jnp.max(near), t_min)
    t1 = jnp.minimum(jnp.min(far), t_max)
    return t0 <= t1


def _leaf_intersect(bvh, node, o, d, t_min, best_t, best_prim, max_leaf):
    start = bvh.prim_start[node]
    count = bvh.prim_count[node]

    def body(k, carry):
        bt, bp = carry
        idx = start + k
        in_leaf = k < count
        p0 = bvh.tri_p0[idx]
        e1 = bvh.tri_e1[idx]
        e2 = bvh.tri_e2[idx]
        pvec = jnp.cross(d, e2)
        det = jnp.dot(e1, pvec)
        inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
        tvec = o - p0
        u = jnp.dot(tvec, pvec) * inv_det
        qvec = jnp.cross(tvec, e1)
        v = jnp.dot(d, qvec) * inv_det
        tt = jnp.dot(e2, qvec) * inv_det
        hit = (
            in_leaf & (jnp.abs(det) > 1e-12)
            & (u >= 0) & (v >= 0) & (u + v <= 1)
            & (tt > t_min) & (tt < bt)
        )
        return (
            jnp.where(hit, tt, bt),
            jnp.where(hit, bvh.prim_order[idx], bp),
        )

    return jax.lax.fori_loop(0, max_leaf, body, (best_t, best_prim))


def intersect(bvh: BVH, o, d, t_min=1e-4, t_max=jnp.inf, max_leaf: int = 8):
    """Closest hit for a single ray (vmap for batches).
    Returns (t, prim_index, valid)."""
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)

    def cond(state):
        sp, _, _, _ = state
        return sp > 0

    def body(state):
        sp, stack, best_t, best_prim = state
        sp = sp - 1
        node = stack[sp]
        hit_box = _slab_test(bvh, node, o, inv_d, t_min, best_t)
        is_leaf = bvh.prim_count[node] > 0

        def leaf_fn(args):
            sp_, stack_, bt, bp = args
            bt2, bp2 = _leaf_intersect(
                bvh, node, o, d, t_min, bt, bp, max_leaf
            )
            return sp_, stack_, bt2, bp2

        def inner_fn(args):
            sp_, stack_, bt, bp = args
            stack_ = stack_.at[sp_].set(bvh.left[node])
            stack_ = stack_.at[sp_ + 1].set(bvh.right[node])
            return sp_ + 2, stack_, bt, bp

        def skip_fn(args):
            return args

        sp, stack, best_t, best_prim = jax.lax.cond(
            hit_box,
            lambda a: jax.lax.cond(is_leaf, leaf_fn, inner_fn, a),
            skip_fn,
            (sp, stack, best_t, best_prim),
        )
        return sp, stack, best_t, best_prim

    stack = jnp.zeros((STACK_DEPTH,), jnp.int32)
    init = (jnp.int32(1), stack, jnp.float32(t_max), jnp.int32(-1))
    _, _, best_t, best_prim = jax.lax.while_loop(cond, body, init)
    valid = best_prim >= 0
    return best_t, best_prim, valid


def occluded(bvh: BVH, p_from, p_to, eps=1e-3, max_leaf: int = 8):
    """Any-hit along the open segment (single ray; vmap for batches).
    Note: unlike the brute-force path this has no per-face opacity mask;
    build the BVH over opaque faces only."""
    delta = p_to - p_from
    dist = m.length(delta)
    d = delta / jnp.maximum(dist, 1e-20)
    lo = eps * jnp.maximum(dist, 1.0)
    t, prim, valid = intersect(
        bvh, p_from, d, t_min=lo, t_max=dist - lo, max_leaf=max_leaf
    )
    return valid
