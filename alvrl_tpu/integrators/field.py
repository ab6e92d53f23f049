"""Field-extraction integrator (AOV renderer).

Counterpart of the `field` plugin (src/integrators/misc/field.cpp):
extracts a named quantity from the camera-ray intersection records and
returns it as an image — used together with `multichannel` to dump
auxiliary channels (depth, normals, UVs, albedo, ids) for computer-
vision-style benchmark data.

Array-native design: one vectorized closest-hit pass over all pixels; the
field select is a static dispatch (each render is jit-compiled for one
field kind), so there is no per-pixel branching.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from alvrl_tpu.geometry import intersect
from alvrl_tpu.scene.scene import NORMALMAP, Scene
from alvrl_tpu.sensors import perspective
from alvrl_tpu.textures import procedural

# field kinds (field.cpp EField)
FIELDS = (
    "position", "relPosition", "distance", "geoNormal", "shNormal",
    "uv", "albedo", "shapeIndex", "primIndex",
)


def _world_to_camera(cam):
    """Inverse of the camera-to-world rigid transform."""
    r = cam.to_world[:3, :3]
    t = cam.to_world[:3, 3]
    rt = r.T
    return rt, -rt @ t


@partial(jax.jit, static_argnames=("field",))
def render_field(scene: Scene, field: str, undefined=0.0):
    """Render the requested field at pixel centers -> (H, W, 3) f32.

    `undefined` is the value written where the ray escapes
    (field.cpp `undefined` parameter). Integer ids are emitted as
    float gray (id broadcast to RGB), matching the reference's
    Spectrum((Float) value) casts.
    """
    if field not in FIELDS:
        raise ValueError(f"unknown field {field!r}; one of {FIELDS}")
    cam = scene.camera
    w, h = cam.width, cam.height
    px, py = jnp.meshgrid(jnp.arange(w), jnp.arange(h))
    px = px.reshape(-1)
    py = py.reshape(-1)
    ray_o, ray_d = perspective.sample_ray(cam, px, py)
    hit = intersect.intersect_all(ray_o, ray_d, scene.vertices, scene.faces)

    if field == "position":
        val = hit.p
    elif field == "relPosition":
        rt, tt = _world_to_camera(cam)
        val = hit.p @ rt.T + tt
    elif field == "distance":
        val = jnp.broadcast_to(hit.t[:, None], hit.p.shape)
    elif field == "geoNormal":
        val = hit.ng_raw
    elif field == "shNormal":
        # shading normal = geometric normal oriented toward the ray,
        # perturbed by the material's normal map where present
        # (normalmap.cpp through bsdf/layered.py)
        from alvrl_tpu.bsdf import layered

        mat_id = scene.material[jnp.maximum(hit.prim, 0)]
        uv = procedural.interp_uv(scene.face_uv, hit.prim, hit.uv)
        ng = hit.ng
        pert = layered.perturbed_normal(scene, mat_id, ng, uv)
        is_nm = scene.materials.kind[mat_id] == NORMALMAP
        val = jnp.where(is_nm[:, None], pert, ng)
    elif field == "uv":
        uv = procedural.interp_uv(scene.face_uv, hit.prim, hit.uv)
        val = jnp.concatenate([uv, jnp.zeros_like(uv[..., :1])], axis=-1)
    elif field == "albedo":
        mat_id = scene.material[jnp.maximum(hit.prim, 0)]
        uv = procedural.interp_uv(scene.face_uv, hit.prim, hit.uv)
        val = procedural.albedo_at(scene, mat_id, hit.p, uv=uv)
    elif field == "shapeIndex":
        sid = scene.face_shape[jnp.maximum(hit.prim, 0)]
        val = jnp.broadcast_to(
            sid.astype(jnp.float32)[:, None], hit.p.shape)
    elif field == "primIndex":
        val = jnp.broadcast_to(
            hit.prim.astype(jnp.float32)[:, None], hit.p.shape)

    und = jnp.broadcast_to(jnp.asarray(undefined, jnp.float32), (3,))
    val = jnp.where(hit.valid[:, None], val, und)
    return val.reshape(h, w, 3)
