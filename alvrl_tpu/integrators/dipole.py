"""Dipole subsurface scattering (the `dipole` Subsurface plugin).

Counterpart of src/subsurface/dipole.cpp (Jensen et al. 2001 BSSRDF
with the classical dipole diffusion profile). The reference gathers
irradiance into an octree of surface samples during preprocess and
evaluates Sum Rd(|xo - xi|) E(xi) A(xi) through a hierarchical query;
the Array re-design keeps the two-stage structure but replaces the
octree with a dense (shading-point x sample-point) masked sweep — the
same shape as the photon-map and VPL gathers, which the VPU executes
faster than divergent tree walks at these sample counts.

singlescatter.cpp note: the single-scattering subsurface term is
covered exactly by the nested-media machinery (a shape-bounded medium
+ volpath with single_scatter=True, media/table.py) and is therefore
not duplicated here.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from alvrl_tpu.core import struct

from alvrl_tpu.bsdf.lobes import fresnel_dielectric_scalar
from alvrl_tpu.core import math as m
from alvrl_tpu.geometry import intersect
from alvrl_tpu.scene.scene import Scene
from alvrl_tpu.sensors import perspective


@struct.dataclass
class DipoleParams:
    """Classical dipole inputs (dipole.cpp parameters)."""

    sigma_s: jax.Array  # (3,) scattering
    sigma_a: jax.Array  # (3,) absorption
    g: jax.Array        # phase mean cosine (similarity-reduced)
    eta: jax.Array      # relative IOR of the boundary


def _fdr(eta):
    """Diffuse Fresnel reflectance approximation (Egan & Hilgeman as
    used by dipole.cpp)."""
    return (-1.440 / (eta * eta) + 0.710 / eta + 0.668 + 0.0636 * eta)


def rd_profile(params: DipoleParams, r):
    """Diffusion profile Rd(r) (dipole.cpp::operator(), spectral)."""
    sig_sp = params.sigma_s * (1.0 - params.g)
    sig_tp = sig_sp + params.sigma_a
    alpha_p = sig_sp / jnp.maximum(sig_tp, 1e-30)
    sigma_tr = jnp.sqrt(3.0 * params.sigma_a * sig_tp)
    fdr = _fdr(params.eta)
    a_coef = (1.0 + fdr) / (1.0 - fdr)
    zr = 1.0 / jnp.maximum(sig_tp, 1e-30)
    zv = zr * (1.0 + 4.0 / 3.0 * a_coef)
    r = jnp.asarray(r)[..., None]
    dr = jnp.sqrt(r * r + zr * zr)
    dv = jnp.sqrt(r * r + zv * zv)
    c1 = zr * (sigma_tr * dr + 1.0) * jnp.exp(-sigma_tr * dr) / (dr ** 3)
    c2 = zv * (sigma_tr * dv + 1.0) * jnp.exp(-sigma_tr * dv) / (dv ** 3)
    return alpha_p / (4.0 * jnp.pi) * (c1 + c2)


def rd_total(params: DipoleParams):
    """Closed-form total diffuse reflectance of the dipole profile
    (the classical albedo-inversion identity; used as a test oracle)."""
    sig_sp = params.sigma_s * (1.0 - params.g)
    sig_tp = sig_sp + params.sigma_a
    alpha_p = sig_sp / jnp.maximum(sig_tp, 1e-30)
    fdr = _fdr(params.eta)
    a_coef = (1.0 + fdr) / (1.0 - fdr)
    s = jnp.sqrt(3.0 * (1.0 - alpha_p))
    return (alpha_p / 2.0) * (1.0 + jnp.exp(-4.0 / 3.0 * a_coef * s)) \
        * jnp.exp(-s)


def sample_surface_points(scene: Scene, face_mask, key, n_samples: int):
    """Area-weighted sample points on the masked triangles: returns
    (points (S, 3), normals (S, 3), area-weights (S,) = total_area/S)."""
    p0 = scene.vertices[scene.faces[:, 0]]
    p1 = scene.vertices[scene.faces[:, 1]]
    p2 = scene.vertices[scene.faces[:, 2]]
    cr = jnp.cross(p1 - p0, p2 - p0)
    area = 0.5 * jnp.linalg.norm(cr, axis=-1) * face_mask
    total = jnp.sum(area)
    k1, k2 = jax.random.split(key)
    cdf = jnp.cumsum(area)
    u = jax.random.uniform(k1, (n_samples,)) * total
    tri = jnp.clip(jnp.searchsorted(cdf, u), 0, area.shape[0] - 1)
    uv = jax.random.uniform(k2, (n_samples, 2))
    su = jnp.sqrt(jnp.clip(uv[:, 0], 1e-9, 1.0))
    b0 = 1.0 - su
    b1 = uv[:, 1] * su
    pts = (p0[tri] + b0[:, None] * (p1[tri] - p0[tri])
           + b1[:, None] * (p2[tri] - p0[tri]))
    ng = cr[tri] / jnp.maximum(
        jnp.linalg.norm(cr[tri], axis=-1, keepdims=True), 1e-20)
    return pts, ng, jnp.full((n_samples,), total / n_samples)


def irradiance_direct(scene: Scene, pts, ng):
    """Direct irradiance at the sample points from delta emitters
    (dipole.cpp's irradiance samples; the octree preprocess uses the
    same direct estimate by default)."""
    from alvrl_tpu.sensors.meters import _delta_direct

    def one(p, n):
        val, arrive = _delta_direct(scene, p)
        cos = jnp.maximum(jnp.sum(arrive * n, axis=-1), 0.0)
        return jnp.sum(val * cos[..., None], axis=0)

    return jax.vmap(one)(pts, ng)


@partial(jax.jit, static_argnames=("n_samples", "chunk"))
def render_dipole(scene: Scene, face_mask, params: DipoleParams, key,
                  n_samples: int = 2048, chunk: int = 1024):
    """Two-stage dipole render: irradiance sample points on the masked
    faces, then per-pixel Mo = sum Rd(|xo-xi|) E_i A_i with the Fresnel
    transmittance factors of dipole.cpp::Lo. Unmasked faces shade with
    direct lighting (so the fixture is a full image)."""
    cam = scene.camera
    w, h = cam.width, cam.height

    k_pts, k_jit, k_nee = jax.random.split(key, 3)
    pts, ng_s, a_w = sample_surface_points(scene, face_mask, k_pts,
                                           n_samples)
    e_i = irradiance_direct(scene, pts, ng_s)       # (S, 3)

    px, py = jnp.meshgrid(jnp.arange(w), jnp.arange(h), indexing="xy")
    px = px.reshape(-1).astype(jnp.float32)
    py = py.reshape(-1).astype(jnp.float32)
    jitter = jax.random.uniform(k_jit, (px.shape[0], 2))
    o, d = perspective.sample_ray(cam, px, py, jitter=jitter)
    hit = intersect.intersect_all(o, d, scene.vertices, scene.faces)
    q_pos = jnp.where(hit.valid[..., None], hit.p, o)
    is_sss = hit.valid & (face_mask[jnp.maximum(hit.prim, 0)] > 0)

    # Mo sweep over sample chunks
    pad = (-n_samples) % chunk
    pts_c = jnp.pad(pts, ((0, pad), (0, 0))).reshape(-1, chunk, 3)
    ew_c = jnp.pad(e_i * a_w[:, None],
                   ((0, pad), (0, 0))).reshape(-1, chunk, 3)

    def body(acc, inp):
        cp, cew = inp
        r = jnp.linalg.norm(
            q_pos[:, None, :] - cp[None, :, :], axis=-1)
        acc = acc + jnp.sum(rd_profile(params, r) * cew[None], axis=1)
        return acc, None

    mo, _ = jax.lax.scan(
        body, jnp.zeros(q_pos.shape[:-1] + (3,)), (pts_c, ew_c))

    # Lo = (1/pi) * Ft(cos_o) * Mo / (1 - Fdr) (dipole.cpp::Lo)
    cos_o = jnp.abs(jnp.sum(hit.ng * -d, axis=-1))
    ft = 1.0 - fresnel_dielectric_scalar(cos_o, params.eta)
    lo_sss = mo * (ft / jnp.pi / (1.0 - _fdr(params.eta)))[..., None]

    # non-subsurface faces: simple direct shading for context
    from alvrl_tpu.bsdf import api as bsdf_api
    from alvrl_tpu.emitters import emitters as em_mod

    lo_box, hi_box = scene.aabb()
    radius = 0.5 * jnp.linalg.norm(hi_box - lo_box)
    dirn, val, dist = jax.vmap(
        lambda kk, pp: em_mod.nee(scene.emitters, kk, pp, radius)
    )(jax.random.split(k_nee, q_pos.shape[0]), q_pos)
    blocked = intersect.occluded(
        q_pos, q_pos + dist[..., None] * dirn,
        scene.vertices, scene.faces, face_mask=scene.opaque_faces(),
    )
    f_d = bsdf_api.eval_smooth(
        scene, scene.material[jnp.maximum(hit.prim, 0)], hit.ng,
        -d, dirn, p_world=q_pos)
    lo_direct = jnp.where((hit.valid & ~blocked)[..., None],
                          val * f_d, 0.0)

    img = jnp.where(is_sss[..., None], lo_sss, lo_direct)
    return img.reshape(h, w, 3)
