"""Ray-triangle and ray-scene intersection.

Array-native replacement for the reference's SAH kd-tree + TriAccel SSE
traversal (include/mitsuba/render/{gkdtree,sahkdtree3,skdtree,triaccel}.h).

Design: on a vector machine, divergent per-ray tree traversal is the enemy.
We therefore provide two paths:

  * `intersect_all` / `occluded`: fully vectorized ray x triangle tests
    (Moller-Trumbore) with a masked argmin. For the scene sizes of the
    ALVRL benchmark family (Cornell-box-scale, tens to thousands of
    triangles) this is dense, divergence-free array work.
  * a BVH path (alvrl_tpu.geometry.bvh) for large meshes, traversed with a
    short-stack `lax.while_loop`, used when triangle count exceeds a
    crossover threshold.

All functions broadcast over leading batch dims of the ray.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from alvrl_tpu.core import math as m

INF = jnp.float32(jnp.inf)
RAY_EPS = 1e-4  # mint offset to avoid self-intersection (mitsuba Epsilon)


class Hit(NamedTuple):
    """Closest-hit record (counterpart of mitsuba's Intersection)."""

    t: jax.Array        # hit distance, +inf if none
    prim: jax.Array     # triangle index, -1 if none
    valid: jax.Array    # bool
    p: jax.Array        # hit position (..., 3)
    ng: jax.Array       # geometric normal, oriented toward the ray origin
    ng_raw: jax.Array   # geometric normal as defined by winding
    uv: jax.Array       # barycentric (u, v)


def ray_triangle(o, d, p0, p1, p2):
    """Moller-Trumbore. Returns (t, u, v, hit_mask).

    Shapes: o, d are (..., 3); p0/p1/p2 are (..., 3) broadcastable against
    them (typically (T, 3) against (..., 1, 3)).
    """
    e1 = p1 - p0
    e2 = p2 - p0
    pvec = m.cross(d, e2)
    det = m.dot(e1, pvec)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = o - p0
    u = m.dot(tvec, pvec) * inv_det
    qvec = m.cross(tvec, e1)
    v = m.dot(d, qvec) * inv_det
    t = m.dot(e2, qvec) * inv_det
    hit = (
        (jnp.abs(det) > 1e-12)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
    )
    return t, u, v, hit


def _gather_tri(verts, faces):
    p0 = verts[faces[:, 0]]
    p1 = verts[faces[:, 1]]
    p2 = verts[faces[:, 2]]
    return p0, p1, p2


def intersect_all(o, d, verts, faces, tmin=RAY_EPS, tmax=INF):
    """Closest hit of rays (..., 3) against all triangles.

    Counterpart of Scene::rayIntersectAll (src/librender/scene.cpp:685-760)
    over a triangle soup. Vectorized: each ray tests every triangle.
    """
    p0, p1, p2 = _gather_tri(verts, faces)
    ob = o[..., None, :]
    db = d[..., None, :]
    t, u, v, hit = ray_triangle(ob, db, p0, p1, p2)
    t = jnp.where(hit & (t > tmin) & (t < tmax), t, INF)
    prim = jnp.argmin(t, axis=-1)
    t_best = jnp.take_along_axis(t, prim[..., None], axis=-1)[..., 0]
    valid = jnp.isfinite(t_best)
    prim = jnp.where(valid, prim, -1)

    u_best = jnp.take_along_axis(u, prim[..., None], axis=-1)[..., 0]
    v_best = jnp.take_along_axis(v, prim[..., None], axis=-1)[..., 0]
    p = o + t_best[..., None] * d

    f = faces[jnp.maximum(prim, 0)]
    a, b, c = verts[f[..., 0]], verts[f[..., 1]], verts[f[..., 2]]
    ng_raw = m.normalize(m.cross(b - a, c - a))
    # Orient toward the incoming ray (mitsuba flips the shading frame so
    # that the normal opposes the ray direction for two-sided shading).
    ng = jnp.where(m.dot(ng_raw, d, keepdims=True) > 0, -ng_raw, ng_raw)
    return Hit(
        t=t_best,
        prim=prim,
        valid=valid,
        p=p,
        ng=ng,
        ng_raw=ng_raw,
        uv=jnp.stack([u_best, v_best], axis=-1),
    )


def occluded(p_from, p_to, verts, faces, face_mask=None, eps=1e-3):
    """Any *masked-in* triangle blocking the open segment p_from -> p_to?

    `face_mask` (T,) bool selects which triangles count as blockers
    (used to let shadow rays pass through index-matched null boundaries,
    the semantics of Scene::evalTransmittance, scene.cpp:619-679).
    Segment endpoints are shrunk by `eps` in *relative* units to avoid
    self-intersection at both ends.
    """
    delta = p_to - p_from
    dist = m.length(delta)
    d = delta / jnp.maximum(dist, 1e-20)[..., None]
    p0, p1, p2 = _gather_tri(verts, faces)
    t, _, _, hit = ray_triangle(p_from[..., None, :], d[..., None, :], p0, p1, p2)
    lo = eps * jnp.maximum(dist, 1.0)[..., None]
    hi = dist[..., None] - lo
    blocked = hit & (t > lo) & (t < hi)
    if face_mask is not None:
        blocked = blocked & face_mask
    return jnp.any(blocked, axis=-1)
