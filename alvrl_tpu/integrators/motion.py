"""Deformable (keyframe-animated) geometry: motion blur + motion vectors.

Counterpart of two reference features:

  * `deformable` shape (src/shapes/deformable.cpp): keyframed meshes
    intersected at the ray's time by linear vertex interpolation (the
    reference builds a 4D space-time kd-tree; here the time dimension
    dissolves — each sampled shutter time lerps the vertex buffer ONCE
    per pass, a (V, 3) elementwise op, and the regular static-scene
    intersectors run unchanged);
  * `motion` integrator (src/integrators/misc/motion.cpp): screen-space
    motion vectors — R, G = 2D pixel motion of the primary hit toward
    the target-frame time, B = change of camera distance, infinity
    where no motion can be tracked (here: no hit). SCOPE: the primary-
    hit configuration ("d"); the reference's specular-flow tracking
    (manifold-exploration through "rd"/"ttd"... chains, motion.cpp's
    nonlinear solver) is a research feature not ported.

Scenes animate by carrying a second vertex buffer `vertices_t1`
(time-1 keyframe); time 0 = `vertices`. The loader fills it from
per-shape `to_world_t1` transforms (rigid per-shape motion) or a
second mesh file (vertex-level deformation).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from alvrl_tpu.core import rng
from alvrl_tpu.geometry import intersect
from alvrl_tpu.scene.scene import Scene
from alvrl_tpu.sensors import perspective

INF = jnp.float32(np.inf)


def scene_at_time(scene: Scene, t):
    """Scene with vertices linearly interpolated to time t in [0, 1]
    (deformable.cpp's per-ray frame lerp, hoisted per pass)."""
    if scene.vertices_t1 is None:
        return scene
    t = jnp.asarray(t, jnp.float32)
    v = scene.vertices * (1.0 - t) + scene.vertices_t1 * t
    return scene.replace(vertices=v)


@partial(jax.jit, static_argnames=("render_one", "spp"), keep_unused=True)
def render_motion_blur(scene: Scene, key, render_one, spp: int = 16):
    """Shutter-integrated render: spp stratified times in [0, 1], one
    1-spp sub-render per time (each pass sees the scene frozen at its
    time — the accumulation form of distribution motion blur).

    render_one(scene, key) -> (H, W, 3) must be a 1-sample renderer."""
    def one(i):
        u = rng.uniform(rng.fold(key, i, 1))
        t = (i.astype(jnp.float32) + u) / spp
        return render_one(scene_at_time(scene, t), rng.fold(key, i, 2))

    imgs = jax.lax.map(one, jnp.arange(spp))
    return imgs.mean(0)


@partial(jax.jit, static_argnames=(), keep_unused=True)
def render_motion_vectors(scene: Scene, time0=0.0, time1=1.0):
    """Primary-hit motion vectors (motion.cpp, configuration "d"):
    trace pixel-center rays against the scene at time0; re-evaluate
    each hit's triangle barycentrics on the time1 vertices; output
    R, G = pixel-space motion, B = camera-distance change; pixels with
    no hit get +inf (motion.cpp's untrackable-path convention)."""
    cam = scene.camera
    w, h = cam.width, cam.height
    px, py = jnp.meshgrid(jnp.arange(w), jnp.arange(h))
    px = px.reshape(-1)
    py = py.reshape(-1)
    o, d = perspective.sample_ray(cam, px, py)

    s0 = scene_at_time(scene, time0)
    hit = intersect.intersect_all(o, d, s0.vertices, s0.faces)

    # hit point at the target time from the SAME triangle + barycentrics
    s1 = scene_at_time(scene, time1)
    f = scene.faces[jnp.maximum(hit.prim, 0)]
    a1, b1, c1 = s1.vertices[f[..., 0]], s1.vertices[f[..., 1]], \
        s1.vertices[f[..., 2]]
    u, v = hit.uv[..., 0:1], hit.uv[..., 1:2]
    p1 = a1 * (1.0 - u - v) + b1 * u + c1 * v

    cam_o = cam.to_world[:3, 3]
    x0, y0 = perspective.sample_position(cam, hit.p - cam_o)
    x1, y1 = perspective.sample_position(cam, p1 - cam_o)
    dist0 = jnp.linalg.norm(hit.p - cam_o, axis=-1)
    dist1 = jnp.linalg.norm(p1 - cam_o, axis=-1)

    vec = jnp.stack([x1 - x0, y1 - y0, dist1 - dist0], axis=-1)
    vec = jnp.where(hit.valid[:, None], vec, INF)
    return vec.reshape(h, w, 3)
