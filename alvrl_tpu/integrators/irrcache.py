"""Irradiance caching (Ward & Heckbert 1988, Tabellion & Lamorlette 2004).

Counterpart of the `irrcache` meta-integrator plus the cache core
(src/integrators/misc/irrcache.cpp, src/librender/irrcache.cpp,
include/mitsuba/render/irrcache.h): diffuse indirect illumination is
computed at a sparse set of cache points by stratified hemispherical
final gathering and interpolated everywhere else with the Tabellion
weight; non-diffuse pixels forward to the sub-integrator. Preserved
semantics (with file:line citations):

  * stratified hemisphere, sin^2(theta) elevation strata, azimuth 2x
    elevation resolution (irrcache.cpp:39-56, M x N = res x 2*res);
  * E = pi/(MN) sum L; rotational gradient -pi/(MN) sum tan(theta) L v_k
    and translational gradient via the Krivanek/Gautron cell formulas
    (librender/irrcache.cpp:78-144);
  * validity radius R0 = min gather distance restricted to rays >= 10
    degrees above the tangent plane (librender/irrcache.cpp:133-136);
    clamped by the gradient magnitude E/|grad| and the screen-space
    footprint [R0_min, R0_max] = [3, 20] x sqrtArea, translational
    gradient scaled by min(1, hMin/R0_min) (misc/irrcache.cpp:283-318);
  * neighbor clamping R0_i <= originalR0_j + |p_i - p_j|
    (librender/irrcache.cpp:148-180);
  * Tabellion weight w = 1 - kappa * max(|p-p2|/(R0/2),
    sqrt(1-n.n2)/0.12326), rejecting back-facing and in-front records
    (irrcache.h:297-320); gradient extrapolation
    E + (n x n2).rGrad + (p2-p).tGrad, clamped >= 0
    (librender/irrcache.cpp:183-215);
  * overture pass then quality *= qualityAdjustment
    (misc/irrcache.cpp:218-243).

Array-native design: the reference fills the cache lazily per pixel
behind an octree (host-sequential); here the overture runs in ROUNDS —
a vectorized coverage test over all candidate pixels picks an uncovered
batch, one device call gathers all of the batch's hemispheres at once,
and records accumulate until every candidate interpolates. Rendering
interpolates with a dense (pixels x records) masked sweep — the octree
search dissolves into vectorized weight evaluation (same design as the
dipole integrator's gather stage).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from alvrl_tpu.core import math as m
from alvrl_tpu.core import rng
from alvrl_tpu.geometry import intersect
from alvrl_tpu.integrators.adaptive import _li_tiled
from alvrl_tpu.integrators.volpath import VolpathConfig, li_volpath
from alvrl_tpu.scene.scene import DIFFUSE, Scene
from alvrl_tpu.sensors import perspective

_FAR = 1e30


@dataclass
class IrradianceCache:
    """Host-side cache record arrays (struct-of-arrays)."""

    p: np.ndarray        # (R, 3) positions
    n: np.ndarray        # (R, 3) shading normals
    E: np.ndarray        # (R, 3) irradiance
    r0: np.ndarray       # (R,) clamped validity radius
    orig_r0: np.ndarray  # (R,) pre-clamp radius (neighbor clamping)
    rgrad: np.ndarray    # (R, 3, 3) rotational gradient [axis, channel]
    tgrad: np.ndarray    # (R, 3, 3) translational gradient
    r0_lo: np.ndarray    # (R,) screen-space clamp lower bound
    r0_hi: np.ndarray    # (R,) screen-space clamp upper bound
    kappa: float         # render-time quality

    @property
    def size(self):
        return self.p.shape[0]


def _default_gather_li(scene, o, d, key):
    """ERadianceNoEmission direct illumination at the gather-ray hit
    (the `direct` sub-integrator under the cache's recursive query,
    misc/irrcache.cpp:311-315)."""
    return li_volpath(
        scene, o, d, key,
        VolpathConfig(max_depth=1, only_vrl_paths=False,
                      first_emission=False),
    )


from functools import lru_cache


@lru_cache(maxsize=32)
def _gather_jit(li_fn, res: int, b: int):
    """Per-(sub-integrator, resolution, batch) jit instance — one
    signature per jit object (see adaptive._round_jit: a shared jitted
    function with a static-callable arg corrupts the fastpath on its
    second signature in this jax build)."""

    @partial(jax.jit, keep_unused=True)
    def f(scene, p, n, key):
        return _gather_impl(scene, p, n, key, li_fn, res)

    return f


def gather_hemispheres(scene: Scene, p, n, key, li_fn, res: int = 8):
    return _gather_jit(li_fn, res, int(p.shape[0]))(scene, p, n, key)


def _gather_impl(scene: Scene, p, n, key, li_fn, res: int = 8):
    """Stratified final gather at points p with normals n.

    Returns (E (B,3), rgrad (B,3,3), tgrad (B,3,3), r0 (B,), hmin (B,)).
    M = res elevation strata, N = 2*res azimuth strata
    (irrcache.cpp:296-297)."""
    M, N = res, 2 * res
    b = p.shape[0]
    k1, k2 = jax.random.split(jnp.asarray(key))
    u = jax.random.uniform(k1, (b, M, N, 2))

    jj = jnp.arange(M, dtype=jnp.float32)[None, :, None]
    kk = jnp.arange(N, dtype=jnp.float32)[None, None, :]
    sin_t2 = (jj + u[..., 0]) / M
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin_t2, 0.0))
    sin_t = jnp.sqrt(sin_t2)
    phi = 2.0 * jnp.pi * (kk + u[..., 1]) / N
    s_f, t_f = m.build_frame(n)  # (B, 3)

    def to_world(x, y, z):
        return (s_f[:, None, None, :] * x[..., None]
                + t_f[:, None, None, :] * y[..., None]
                + n[:, None, None, :] * z[..., None])

    d_world = to_world(sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t)

    scale = jnp.linalg.norm(scene.vertices.max(0) - scene.vertices.min(0))
    o = p + (1e-4 * scale) * n
    o_flat = jnp.broadcast_to(o[:, None, None, :], (b, M, N, 3)).reshape(-1, 3)
    d_flat = d_world.reshape(-1, 3)

    hit = intersect.intersect_all(o_flat, d_flat, scene.vertices, scene.faces)
    dist = jnp.where(hit.valid, hit.t, _FAR).reshape(b, M, N)

    L = _li_tiled(scene, li_fn, k2, o_flat, d_flat).reshape(b, M, N, 3)

    inv_mn = 1.0 / (M * N)
    E = jnp.pi * inv_mn * L.sum((1, 2))

    # cell-center trig per elevation stratum (librender/irrcache.cpp:90-97)
    jf = jnp.arange(M, dtype=jnp.float32)
    cos_tm = jnp.sqrt(1.0 - jf / M)               # cosThetaMinus
    sin_tm = jnp.sqrt(jf / M)                     # sinThetaMinus
    cos_tc = jnp.sqrt(1.0 - (jf + 0.5) / M)       # cell center
    sin_tc = jnp.sqrt((jf + 0.5) / M)
    cos_tp = jnp.sqrt(jnp.maximum(1.0 - (jf + 1.0) / M, 0.0))
    cos_td = cos_tm - cos_tp                      # cosThetaDiff
    tan_tc = sin_tc / jnp.maximum(cos_tc, 1e-12)

    # planar cell vectors per azimuth stratum (irrcache.cpp:60-76)
    kf = jnp.arange(N, dtype=jnp.float32)
    phi_c = 2.0 * jnp.pi * (kf + 0.5) / N
    vk_a = phi_c - 0.5 * jnp.pi
    vkm_a = 2.0 * jnp.pi * kf / N + 0.5 * jnp.pi
    def planar(ang):  # (N,) -> (B, N, 3)
        return (s_f[:, None, :] * jnp.cos(ang)[None, :, None]
                + t_f[:, None, :] * jnp.sin(ang)[None, :, None])
    vk = planar(vk_a)
    vk_minus = planar(vkm_a)
    uk = planar(phi_c)

    # rotational gradient: pi/(MN) sum -tan(theta_j) L_jk v_k
    rg_kc = (L * (-tan_tc)[None, :, None, None]).sum(1)     # (B, N, 3)
    rgrad = jnp.pi * inv_mn * jnp.einsum("bkc,bki->bic", rg_kc, vk)

    # translational gradient, u_k direction (elevation-neighbor cells,
    # j >= 2 as in the reference's `if (j>1)`)
    dL_u = L[:, 1:, :, :] - L[:, :-1, :, :]                 # (B, M-1, N, 3)
    min_d_u = jnp.minimum(dist[:, 1:, :], dist[:, :-1, :])
    factor_u = (2.0 * jnp.pi * (cos_tm[1:] ** 2) * sin_tm[1:])[None, :, None] \
        / (N * jnp.maximum(min_d_u, 1e-12))
    factor_u = jnp.where(min_d_u > 0, factor_u, 0.0)
    mask_j = (jnp.arange(1, M) >= 2).astype(jnp.float32)[None, :, None]
    tg_u_kc = (dL_u * (factor_u * mask_j)[..., None]).sum(1)  # (B, N, 3)
    tgrad = jnp.einsum("bkc,bki->bic", tg_u_kc, uk)

    # translational gradient, v_k direction (azimuth-neighbor cells)
    L_prev = jnp.roll(L, 1, axis=2)
    d_prev = jnp.roll(dist, 1, axis=2)
    min_d_v = jnp.minimum(dist, d_prev)
    factor_v = (cos_tc * cos_td)[None, :, None] \
        / (jnp.maximum(min_d_v, 1e-12)
           * jnp.maximum(sin_tc, 1e-12)[None, :, None])
    factor_v = jnp.where(min_d_v > 0, factor_v, 0.0)
    tg_v_kc = ((L - L_prev) * factor_v[..., None]).sum(1)   # (B, N, 3)
    tgrad = tgrad + jnp.einsum("bkc,bki->bic", tg_v_kc, vk_minus)

    # minimum gather distance, restricted to >= 10 deg elevation
    # (librender/irrcache.cpp:133-136); hMin unrestricted for the
    # gradient scaling
    restricted = jnp.where(cos_t > 0.173, dist, _FAR)
    r0 = restricted.min((1, 2))
    hmin = dist.min((1, 2))
    return E, rgrad, tgrad, r0, hmin


def _pixel_footprint(scene: Scene, t, cos_i):
    """Approximate sqrt of the pixel footprint area at hit distance t
    (the reference computes it from ray differentials,
    misc/irrcache.cpp:285-301; a pinhole footprint is t * pixel angle,
    stretched by the incidence grazing factor)."""
    cam = scene.camera
    pix_ang = 2.0 * np.tan(np.radians(float(cam.fov_x_deg)) / 2.0) \
        / cam.width
    return 2.0 * t * pix_ang / np.sqrt(np.maximum(cos_i, 1e-2))


def _weights(cache_p, cache_n, cache_r0, p2, n2, kappa):
    """Tabellion interpolation weight matrix (P, R) (irrcache.h:297-320)."""
    dp = np.einsum("rc,pc->pr", cache_n, n2)                # n . n2
    diff = p2[:, None, :] - cache_p[None, :, :]             # (P, R, 3)
    d_len = np.linalg.norm(diff, axis=-1)
    in_front = np.einsum(
        "prc,prc->pr", diff, cache_n[None] + n2[:, None]) < -0.05
    e_pi = d_len / (0.5 * cache_r0[None, :])
    e_ni = np.sqrt(np.maximum(1.0 - np.minimum(np.abs(dp), 1.0), 0.0)) \
        / 0.12326
    w = 1.0 - kappa * np.maximum(e_pi, e_ni)
    w = np.where((dp < 0.0) | in_front, 0.0, np.maximum(w, 0.0))
    return w


def _interpolate(cache: IrradianceCache, p2, n2, gradients=True):
    """Interpolated irradiance at query points -> (E (P,3), wsum (P,))."""
    if cache.size == 0:
        return np.zeros((p2.shape[0], 3), np.float32), \
            np.zeros(p2.shape[0], np.float32)
    w = _weights(cache.p, cache.n, cache.r0, p2, n2, cache.kappa)
    E = cache.E[None, :, :]
    if gradients:
        cross_n = np.cross(
            np.broadcast_to(cache.n[None], (p2.shape[0],) + cache.n.shape),
            n2[:, None, :])
        diff = p2[:, None, :] - cache.p[None, :, :]
        E = E + np.einsum("prj,rjc->prc", cross_n, cache.rgrad) \
            + np.einsum("prj,rjc->prc", diff, cache.tgrad)
        E = np.maximum(E, 0.0)
    wsum = w.sum(1)
    Ei = np.einsum("pr,prc->pc", w, E) / np.maximum(wsum[:, None], 1e-20)
    return Ei.astype(np.float32), wsum.astype(np.float32)


def build_cache(
    scene: Scene,
    key,
    li_fn=None,
    resolution: int = 8,
    quality: float = 1.0,
    quality_adjustment: float = 0.5,
    gradients: bool = True,
    batch: int = 128,
    max_rounds: int = 16,
) -> IrradianceCache:
    """Overture pass: cover every diffuse camera-visible point.

    Rounds of (vectorized coverage test -> pick an uncovered, shuffled
    batch -> one batched device hemisphere gather -> insert records with
    the reference's R0 clamps)."""
    if li_fn is None:
        li_fn = _default_gather_li
    cam = scene.camera
    w, h = cam.width, cam.height
    px, py = np.meshgrid(np.arange(w), np.arange(h))
    px = px.reshape(-1)
    py = py.reshape(-1)
    o, d = perspective.sample_ray(cam, jnp.asarray(px), jnp.asarray(py))
    hit = intersect.intersect_all(o, d, scene.vertices, scene.faces)
    mat = np.asarray(scene.material)[np.maximum(np.asarray(hit.prim), 0)]
    kind = np.asarray(scene.materials.kind)[mat]
    cand = np.asarray(hit.valid) & (kind == DIFFUSE)
    c_p = np.asarray(hit.p)[cand]
    c_n = np.asarray(hit.ng)[cand]
    c_t = np.asarray(hit.t)[cand]
    c_cos = np.abs(np.einsum(
        "pc,pc->p", np.asarray(hit.ng)[cand], -np.asarray(d)[cand]))

    cache = IrradianceCache(
        p=np.zeros((0, 3), np.float32), n=np.zeros((0, 3), np.float32),
        E=np.zeros((0, 3), np.float32), r0=np.zeros(0, np.float32),
        orig_r0=np.zeros(0, np.float32),
        rgrad=np.zeros((0, 3, 3), np.float32),
        tgrad=np.zeros((0, 3, 3), np.float32),
        r0_lo=np.zeros(0, np.float32), r0_hi=np.zeros(0, np.float32),
        kappa=quality)
    rs = np.random.default_rng(0)

    for rnd in range(max_rounds):
        _, wsum = _interpolate(cache, c_p, c_n, gradients=False)
        uncovered = np.where(wsum <= 0.0)[0]
        if uncovered.size == 0:
            break
        pick = rs.permutation(uncovered)[:batch]
        n_pick = pick.size
        pad = batch - n_pick
        idx = np.concatenate([pick, np.zeros(pad, pick.dtype)])
        E, rgrad, tgrad, r0, hmin = gather_hemispheres(
            scene, jnp.asarray(c_p[idx]), jnp.asarray(c_n[idx]),
            rng.fold(key, rnd), li_fn, resolution)
        E = np.asarray(E)[:n_pick]
        rgrad = np.asarray(rgrad)[:n_pick]
        tgrad = np.asarray(tgrad)[:n_pick]
        r0 = np.asarray(r0)[:n_pick].copy()
        hmin = np.asarray(hmin)[:n_pick]

        # screen-space clamp bounds (misc/irrcache.cpp:283-301)
        fp = _pixel_footprint(scene, c_t[pick], c_cos[pick])
        r0_min = 3.0 * fp
        r0_max = 20.0 * fp
        if gradients:
            # R0 <= E_c / |tGrad_c| (Krivanek gradient clamp, :305-312)
            gmag = np.linalg.norm(tgrad, axis=1)  # (B, 3) per channel
            ratio = np.where(gmag > 1e-6, E / np.maximum(gmag, 1e-20),
                             np.inf)
            r0 = np.minimum(r0, ratio.min(1))
            # scale tGrad by min(1, hMin/R0_min) (:314-317)
            tgrad = tgrad * np.minimum(
                1.0, hmin / np.maximum(r0_min, 1e-20))[:, None, None]
        else:
            rgrad = np.zeros_like(rgrad)
            tgrad = np.zeros_like(tgrad)

        cache.p = np.concatenate([cache.p, c_p[pick]])
        cache.n = np.concatenate([cache.n, c_n[pick]])
        cache.E = np.concatenate([cache.E, E])
        cache.orig_r0 = np.concatenate([cache.orig_r0, r0])
        cache.rgrad = np.concatenate([cache.rgrad, rgrad])
        cache.tgrad = np.concatenate([cache.tgrad, tgrad])
        cache.r0_lo = np.concatenate([cache.r0_lo, r0_min]) \
            .astype(np.float32)
        cache.r0_hi = np.concatenate([cache.r0_hi, r0_max]) \
            .astype(np.float32)
        # neighbor clamping closure over ALL records
        # (librender/irrcache.cpp:148-180), then the screen bounds
        dmat = np.linalg.norm(
            cache.p[:, None, :] - cache.p[None, :, :], axis=-1)
        r0_all = (cache.orig_r0[None, :] + dmat).min(1)
        cache.r0 = np.clip(r0_all, cache.r0_lo, cache.r0_hi) \
            .astype(np.float32)

    cache.kappa = quality * quality_adjustment
    return cache


def render_irrcache(
    scene: Scene,
    key,
    li_fn=None,
    resolution: int = 8,
    quality: float = 1.0,
    spp_direct: int = 16,
    max_depth_fallback: int = 8,
    indirect_only: bool = False,
    gradients: bool = True,
    cache: IrradianceCache | None = None,
):
    """Irradiance-cached render -> (image (H,W,3), cache).

    Diffuse pixels: direct illumination (sub-integrator) + albedo/pi x
    interpolated cache irradiance. Non-diffuse or uncovered pixels:
    full path-traced fallback (the reference forwards these queries to
    the sub-integrator wholesale, misc/irrcache.cpp:256-284)."""
    from alvrl_tpu.integrators.volpath import render_volpath
    from alvrl_tpu.textures import procedural

    if cache is None:
        cache = build_cache(scene, rng.fold(key, 1), li_fn=li_fn,
                            resolution=resolution, quality=quality)
    cam = scene.camera
    w, h = cam.width, cam.height

    # direct + emitted component (one-vertex sub-integrator render)
    if indirect_only:
        direct = np.zeros((h, w, 3), np.float32)
    else:
        direct = np.asarray(render_volpath(
            scene, rng.fold(key, 2), spp=spp_direct,
            cfg=VolpathConfig(max_depth=1, only_vrl_paths=False)))

    # indirect at camera hits
    px, py = np.meshgrid(np.arange(w), np.arange(h))
    px = px.reshape(-1)
    py = py.reshape(-1)
    o, d = perspective.sample_ray(cam, jnp.asarray(px), jnp.asarray(py))
    hit = intersect.intersect_all(o, d, scene.vertices, scene.faces)
    prim = np.maximum(np.asarray(hit.prim), 0)
    mat = np.asarray(scene.material)[prim]
    kind = np.asarray(scene.materials.kind)[mat]
    diffuse = np.asarray(hit.valid) & (kind == DIFFUSE)

    Ei, wsum = _interpolate(
        cache, np.asarray(hit.p), np.asarray(hit.ng), gradients=gradients)
    covered = diffuse & (wsum > 0)

    uv = procedural.interp_uv(scene.face_uv, hit.prim, hit.uv)
    alb = np.asarray(procedural.albedo_at(
        scene, jnp.asarray(mat), hit.p, uv=uv))
    indirect = np.where(covered[:, None], alb / np.pi * Ei, 0.0)
    img = direct + indirect.reshape(h, w, 3).astype(np.float32)

    # fallback pixels: full path trace (compact -> render -> scatter)
    fb = np.where(~covered & np.asarray(hit.valid))[0]
    if fb.size:
        full_cfg = VolpathConfig(max_depth=max_depth_fallback,
                                 only_vrl_paths=False)
        fb_li = np.asarray(_li_tiled(
            scene,
            lambda s, oo, dd, kk: li_volpath(s, oo, dd, kk, full_cfg),
            rng.fold(key, 3),
            jnp.asarray(np.asarray(o)[fb]), jnp.asarray(np.asarray(d)[fb]),
        ))
        flat = img.reshape(-1, 3)
        flat[fb] = fb_li
        img = flat.reshape(h, w, 3)
    return img, cache
