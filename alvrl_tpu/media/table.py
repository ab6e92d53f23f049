"""Per-shape media: a table of homogeneous media + nested-boundary
transmittance.

Counterpart of the reference's per-shape interior/exterior medium
references (Shape::setInteriorMedium / scenehandler medium refs) and
the null-interface crossing logic of Scene::evalTransmittance
(scene.cpp:619-679): a transmittance query there repeatedly
re-intersects past index-matched (null) boundaries, switching the
active medium at each crossing; an opaque hit kills the query.

Array re-design: media live in one struct-of-arrays table; the *medium
id* is part of the walker state, and switches are masked gathers — no
object graph. Boundary crossings in the transmittance query become a
fixed-trip-count `lax.scan` over at most `max_crossings` interfaces
(deep nesting beyond that is clamped; typical scenes nest 1-2 levels).

Scope note (mirrors the reference): only HOMOGENEOUS media are
per-shape; a grid medium stays the single global medium of the scene
(the reference's heterogeneous.cpp instances are in practice bound to
one enclosing shape as well).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from alvrl_tpu.core import struct

from alvrl_tpu.core import math as m
from alvrl_tpu.geometry import intersect
from alvrl_tpu.media.homogeneous import HomogeneousMedium
from alvrl_tpu.scene.scene import NULL, Scene


@struct.dataclass
class MediaTable:
    """Homogeneous media as struct-of-arrays; id 0 is the scene's
    default exterior (often vacuum)."""

    sigma_a: jax.Array          # (M, 3)
    sigma_s: jax.Array          # (M, 3)
    g: jax.Array                # (M,)
    sampling_weight: jax.Array  # (M,)


def make_media_table(sigma_a, sigma_s, g=None, sampling_weight=None):
    sigma_a = jnp.asarray(sigma_a, jnp.float32).reshape(-1, 3)
    n = sigma_a.shape[0]
    sigma_s = jnp.asarray(sigma_s, jnp.float32).reshape(n, 3)
    if g is None:
        g = jnp.zeros((n,))
    if sampling_weight is None:
        # the reference's default: max single-scattering albedo,
        # floored at 0.5 (homogeneous.cpp medium sampling weight)
        sigma_t = sigma_a + sigma_s
        albedo = jnp.where(
            sigma_t > 0.0, sigma_s / jnp.maximum(sigma_t, 1e-30), 0.0
        )
        w = jnp.max(albedo, axis=-1)
        sampling_weight = jnp.where(
            w > 0.0, jnp.maximum(w, 0.5), 0.0
        )
    return MediaTable(
        sigma_a=sigma_a,
        sigma_s=sigma_s,
        g=jnp.asarray(g, jnp.float32).reshape(n),
        sampling_weight=jnp.asarray(
            sampling_weight, jnp.float32).reshape(n),
    )


def medium_at(table: MediaTable, med_id) -> HomogeneousMedium:
    """Gather one medium record (dynamic id; BALANCE sampling, HG
    phase). Works on traced scalars inside vmapped walkers."""
    return HomogeneousMedium(
        sigma_a=table.sigma_a[med_id],
        sigma_s=table.sigma_s[med_id],
        g=table.g[med_id],
        sampling_weight=table.sampling_weight[med_id],
    )


def medium_after_surface(scene: Scene, prim, new_d):
    """Medium id on the side of `new_d` after a surface interaction at
    triangle `prim` (null pass-through, refraction, or reflection —
    uniform rule: the outgoing hemisphere picks interior/exterior)."""
    p0 = scene.vertices[scene.faces[prim, 0]]
    p1 = scene.vertices[scene.faces[prim, 1]]
    p2 = scene.vertices[scene.faces[prim, 2]]
    ng_raw = m.normalize(jnp.cross(p1 - p0, p2 - p0))
    going_in = m.dot(new_d, ng_raw) < 0
    return jnp.where(
        going_in, scene.face_med_int[prim], scene.face_med_ext[prim]
    ).astype(jnp.int32)


def eval_transmittance_nested(scene: Scene, p0, p1, med0,
                              max_crossings: int = 8):
    """Spectral transmittance between two points with medium switches
    at null boundaries (Scene::evalTransmittance, scene.cpp:619-679).
    Scalar-lane: vmap externally. Returns 0 on any opaque hit."""
    tbl = scene.media
    delta = p1 - p0
    dist = m.length(delta)
    d = delta / jnp.maximum(dist, 1e-20)
    eps = 1e-3 * jnp.maximum(dist, 1.0)
    kinds = scene.materials.kind[scene.material]

    def body(carry, _):
        t_cur, med, tau, done, blocked = carry
        o = p0 + t_cur[..., None] * d
        remaining = dist - t_cur - eps
        hit = intersect.intersect_all(
            o, d, scene.vertices, scene.faces,
            tmin=eps, tmax=jnp.maximum(remaining, 0.0),
        )
        seg_len = jnp.where(hit.valid, hit.t, dist - t_cur)
        sigma_t = tbl.sigma_a[med] + tbl.sigma_s[med]
        tau_new = tau * jnp.exp(-sigma_t * jnp.maximum(seg_len, 0.0))
        is_null = kinds[jnp.maximum(hit.prim, 0)] == NULL
        opaque_hit = hit.valid & ~is_null & ~done
        med_new = medium_after_surface(scene, jnp.maximum(hit.prim, 0), d)
        carry_out = (
            jnp.where(done, t_cur, t_cur + seg_len),
            jnp.where(done | ~hit.valid, med, med_new),
            jnp.where(done, tau, tau_new),
            done | ~hit.valid | opaque_hit,
            blocked | opaque_hit,
        )
        return carry_out, None

    init = (
        jnp.zeros_like(dist),
        jnp.asarray(med0, jnp.int32),
        jnp.ones(jnp.shape(dist) + (3,)),
        jnp.zeros_like(dist, bool),
        jnp.zeros_like(dist, bool),
    )
    (t_f, _, tau, _, blocked), _ = jax.lax.scan(
        body, init, None, length=max_crossings
    )
    return jnp.where(blocked[..., None], 0.0, tau)
