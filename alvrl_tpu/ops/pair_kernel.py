"""Fused VRL pair sum for NVIDIA GPUs: Pallas through its Triton route.

The XLA path (integrate.pair_sum) writes (rays x VRL chunk x samples)
uniforms and intermediates to device memory, about 1.26 kB per
pair-sample against about 1090 fp32 FLOPs (scripts/roofline.py). This
kernel keeps a pair's whole estimate in registers. One program takes a
block of BLOCK_R eye rays, walks the VRL set in tiles of BLOCK_V inside
a fori_loop, sweeps the triangle list once per tile for all shadow
segments (the list stays in L1/L2 at Cornell scale), and stores its
(3, BLOCK_R) sum once.

The per-pair math is integrate.pair_contribution's for a homogeneous
medium with the balance strategy, an HG or Rayleigh phase, and
Lambertian, null or delta surfaces (`supports`), written as
per-channel scalar fp32. The uniforms come from core.rng's pair hash of
(seed, ray index, VRL index, slot), so the kernel and integrate.pair_sum
draw the same numbers and differ only by fp32 rounding. The gradient is
a custom_vjp whose backward is jax.vjp of integrate.pair_sum at those
uniforms: the gradient of the very estimator the forward pass ran.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from alvrl_tpu.core import rng
from alvrl_tpu.integrators.vrl import integrate
from alvrl_tpu.media import homogeneous as hmed
from alvrl_tpu.media import phase as ph
from alvrl_tpu.scene.scene import DIELECTRIC, DIFFUSE, MIRROR, NULL
from alvrl_tpu.textures.procedural import TEX_NONE

# (rays per program, VRLs per tile, warps per program): the fastest of
# eight shapes on an H100 at configs 1 and 5 (scripts/tune_pair_kernel.py)
BLOCK = (16, 16, 4)

# ray pack rows (RAY_ROWS, B)
_RO, _RD, _HP, _NG, _ALB, _VALID = 0, 3, 6, 9, 12, 15
RAY_ROWS = 16
# VRL pack rows (VRL_ROWS, N)
_VS, _VE, _VP, _VVALID = 0, 3, 6, 9
VRL_ROWS = 10

_H_EPS = 1e-6
_SURFACES = (DIFFUSE, NULL, MIRROR, DIELECTRIC)


# ---------------------------------------------------------------------------
# Which scenes the kernel computes, and when the render entries take it.
# ---------------------------------------------------------------------------

def supports(scene) -> bool:
    """Whether the kernel computes this scene's estimator exactly: a
    homogeneous medium (balance strategy, HG or Rayleigh phase) and only
    untextured Lambertian, null or delta surfaces (the vol-surf term
    evaluates Lambert alone). Reads static data only (the medium's
    static fields and Materials.kind_set), so it holds under jit; a
    material table built from traced arrays has no kind_set and raises."""
    med = scene.medium
    if not (isinstance(med, hmed.HomogeneousMedium)
            and med.strategy == hmed.BALANCE
            and med.phase_kind in (ph.HG, ph.RAYLEIGH)
            and med.phase_params is None):
        return False
    kind_set = scene.materials.kind_set
    if kind_set is None:
        raise ValueError(
            "the material kinds are unknown (the table was built from "
            "traced arrays); build it with concrete kinds, or set "
            "VRLConfig(fused_kernel=False)")
    return all(k in _SURFACES and (k != DIFFUSE or t == TEX_NONE)
               for k, t in kind_set)


def use_kernel(scene, cfg, platform: str | None = None) -> bool:
    """The render entries' choice: the kernel on a GPU for the scenes it
    supports unless cfg.fused_kernel is off, the XLA path otherwise."""
    if platform is None:
        platform = jax.default_backend()
    return cfg.fused_kernel and platform == "gpu" and supports(scene)


# ---------------------------------------------------------------------------
# Packing: pytrees -> the flat float32 rows the kernel loads.
# ---------------------------------------------------------------------------

def pack_rays(scene, ray_o, ray_d, hit_p, hit_valid, hit_ng, hit_mat):
    """(RAY_ROWS, B): origin, direction, hit point, hit normal, Lambert
    albedo (0 for other surface kinds), valid."""
    kind = scene.materials.kind[hit_mat]
    albedo = jnp.where((kind == DIFFUSE)[:, None],
                       scene.materials.albedo[hit_mat], 0.0)
    rows = [ray_o, ray_d, hit_p, hit_ng, albedo,
            hit_valid[:, None].astype(jnp.float32)]
    return jnp.concatenate(rows, axis=1).astype(jnp.float32).T


def pack_vrls(vrl_s, vrl_e, vrl_p, vrl_valid):
    """(..., VRL_ROWS, N) from (..., N, k) VRL fields."""
    rows = [vrl_s, vrl_e, vrl_p, vrl_valid[..., None].astype(jnp.float32)]
    return jnp.swapaxes(jnp.concatenate(rows, axis=-1), -1, -2)


def pack_medium(med):
    """(8,): sigma_t (3), sigma_s (3), g, sampling weight."""
    return jnp.concatenate([
        med.sigma_t, med.sigma_s,
        jnp.reshape(med.g, (1,)), jnp.reshape(med.sampling_weight, (1,)),
    ]).astype(jnp.float32)


def pack_tris(scene):
    """(9, max(T, 1)): p0, e1 = p1 - p0, e2 = p2 - p0 per triangle, zero
    for the non-opaque ones (a degenerate triangle never blocks)."""
    f = scene.faces
    p0 = scene.vertices[f[:, 0]]
    e1 = scene.vertices[f[:, 1]] - p0
    e2 = scene.vertices[f[:, 2]] - p0
    tri = jnp.concatenate([p0, e1, e2], axis=1)
    tri = jnp.where(scene.opaque_faces()[:, None], tri, 0.0)
    if tri.shape[0] == 0:
        tri = jnp.zeros((1, 9), jnp.float32)
    return tri.T.astype(jnp.float32)


def _pad_last(a, mult):
    pad = -a.shape[-1] % mult
    if pad == 0:
        return a
    return jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])


# ---------------------------------------------------------------------------
# Per-pair math on 3-vectors held as tuples of (BR, 1) / (1, BV) / (BR, BV)
# arrays. Mirrors integrate.pair_contribution step by step.
# ---------------------------------------------------------------------------

def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _axpy(a, s, b):
    return (a[0] + s * b[0], a[1] + s * b[1], a[2] + s * b[2])


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _length(a):
    return jnp.sqrt(jnp.maximum(_dot(a, a), 0.0))


def _normalize(a):
    return _scale(a, 1.0 / jnp.maximum(_length(a), 1e-20))


def _safe_inv(den):
    ok = den != 0.0
    return jnp.where(ok, 1.0 / jnp.where(ok, den, 1.0), 0.0)


def _phase(kind, g, cos):
    if kind == ph.RAYLEIGH:
        return (3.0 / (16.0 * np.pi)) * (1.0 + cos * cos)
    temp = jnp.maximum(1.0 + g * g + 2.0 * g * cos, 1e-12)
    return (1.0 / (4.0 * np.pi)) * (1.0 - g * g) / (temp * jnp.sqrt(temp))


def _kulla(a, b, dirn, seg_len, d_pt, u):
    """Equi-angular point on segment [a, b] (unit direction dirn, length
    seg_len) around d_pt (integrate.kulla_sampling). Returns (point,
    pdf)."""
    dot_pr = _dot(dirn, _sub(d_pt, a))
    i_pt = _axpy(a, dot_pr, dirn)
    dis = jnp.maximum(_length(_sub(d_pt, i_pt)), _H_EPS)
    dist_ai = _length(_sub(i_pt, a))
    dist_ib = _length(_sub(b, i_pt))
    angle_a = jnp.arctan(dist_ai / dis)
    angle_b = jnp.arctan(dist_ib / dis)
    pos = dot_pr > 0
    angle_a = jnp.where(pos, -angle_a, angle_a)
    angle_b = jnp.where(pos & (dist_ai > seg_len), -angle_b, angle_b)
    t = dis * jnp.tan((1.0 - u) * angle_a + u * angle_b)
    pdf = dis * _safe_inv((angle_b - angle_a) * (dis * dis + t * t))
    return _axpy(i_pt, t, dirn), pdf


def _blocked_segments(tri_ref, n_tris, segments):
    """intersect.occluded for several segments at once: one sweep over
    the triangles, each loaded once for all segments."""
    pre = []
    for p, q in segments:
        delta = _sub(q, p)
        dist = _length(delta)
        lo = 1e-3 * jnp.maximum(dist, 1.0)
        pre.append((p, _scale(delta, 1.0 / jnp.maximum(dist, 1e-20)),
                    lo, dist - lo))

    def body(t, blocked):
        p0 = (tri_ref[0, t], tri_ref[1, t], tri_ref[2, t])
        e1 = (tri_ref[3, t], tri_ref[4, t], tri_ref[5, t])
        e2 = (tri_ref[6, t], tri_ref[7, t], tri_ref[8, t])
        out = []
        for (p, d, lo, hi), blk in zip(pre, blocked):
            pvec = _cross(d, e2)
            det = _dot(e1, pvec)
            det_ok = jnp.abs(det) > 1e-12
            inv_det = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0),
                                0.0)
            tvec = _sub(p, p0)
            u = _dot(tvec, pvec) * inv_det
            qvec = _cross(tvec, e1)
            v = _dot(d, qvec) * inv_det
            tt = _dot(e2, qvec) * inv_det
            hit = (det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                   & (tt > lo) & (tt < hi))
            out.append(blk | hit)
        return tuple(out)

    init = tuple(jnp.zeros(pre[0][2].shape, jnp.bool_) for _ in pre)
    return jax.lax.fori_loop(0, n_tris, body, init)


def _pair_terms(ray, vrl, med, ray_h, vrl_idx, tri_ref, n_tris, *,
                n_vv, n_vs, short_vrls, phase_kind):
    """The three channels of the estimate for every (ray, VRL) pair of
    a tile, before the sum over VRLs."""
    o = tuple(ray[_RO:_RO + 3])
    d = tuple(ray[_RD:_RD + 3])
    hp = tuple(ray[_HP:_HP + 3])
    ng = tuple(ray[_NG:_NG + 3])
    alb = ray[_ALB:_ALB + 3]
    r_valid = ray[_VALID] > 0.5
    s = tuple(vrl[_VS:_VS + 3])
    e = tuple(vrl[_VE:_VE + 3])
    pw = vrl[_VP:_VP + 3]
    v_valid = vrl[_VVALID] > 0.5
    sig_t, sig_s, g, msw = med[0:3], med[3:6], med[6], med[7]

    # per ray: the eye segment o -> hp
    eye = _sub(hp, o)
    elen = _length(eye)
    edir = _scale(eye, 1.0 / jnp.maximum(elen, 1e-20))
    tau_e_surf = [jnp.exp(-sig_t[ch] * elen) for ch in range(3)]
    surf_ok = r_valid & ~((tau_e_surf[0] == 0.0) & (tau_e_surf[1] == 0.0)
                          & (tau_e_surf[2] == 0.0))
    # per VRL: the segment s -> e
    sv = _sub(e, s)
    slen = _length(sv)
    sv_dir = _scale(sv, 1.0 / jnp.maximum(slen, 1e-20))
    vrl_len = jnp.maximum(slen, 1e-30)
    vrl_dir = _scale(sv, 1.0 / vrl_len)

    # closest points between the eye segment and the VRL
    w = _sub(o, s)
    a = _dot(eye, eye)
    b = _dot(eye, sv)
    c = _dot(sv, sv)
    dd = _dot(eye, w)
    ee = _dot(sv, w)
    denom = a * c - b * b
    par = denom < 1e-9 * a * c + 1e-30
    s_n = jnp.where(par, 0.0, b * ee - c * dd)
    s_d = jnp.where(par, 1.0, denom)
    t_n = jnp.where(par, ee, a * ee - b * dd)
    t_d = jnp.where(par, c, denom)
    below = s_n < 0.0
    above = s_n > s_d
    t_n = jnp.where(below, ee, jnp.where(above, ee + b, t_n))
    t_d = jnp.where(below | above, c, t_d)
    s_n = jnp.where(below, 0.0, jnp.where(above, s_d, s_n))
    t_below = t_n < 0.0
    t_above = t_n > t_d
    s_n = jnp.where(t_below, jnp.clip(-dd, 0.0, a),
                    jnp.where(t_above, jnp.clip(-dd + b, 0.0, a), s_n))
    s_d = jnp.where(t_below | t_above, jnp.maximum(a, 1e-30), s_d)
    t_n = jnp.where(t_below, 0.0, jnp.where(t_above, t_d, t_n))
    pa = _axpy(o, s_n / jnp.maximum(s_d, 1e-30), eye)
    vh = _axpy(s, t_n / jnp.maximum(t_d, 1e-30), sv)
    h = jnp.maximum(_length(_sub(vh, pa)), _H_EPS)

    cos_theta = _dot(_normalize(d), vrl_dir)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    near_par = sin_theta < 1e-4
    sin_safe = jnp.maximum(sin_theta, 1e-4)
    arc_h = _length(_sub(vh, s))
    a0 = jnp.arcsinh(-arc_h / h * sin_safe)
    a1 = jnp.arcsinh(_length(_sub(e, vh)) / h * sin_safe)
    span_v = jnp.maximum((a1 - a0) / sin_safe, 1e-30)

    def u01(slot):
        return rng.pair_u01(ray_h, rng.vrl_slot_hash(vrl_idx, slot))

    def medium_terms(v_pt):
        """(tau(S->V), pdfFailure(S->V)) of the balance strategy."""
        d_sv = _length(_sub(v_pt, s))
        ex = [jnp.exp(-sig_t[ch] * d_sv) for ch in range(3)]
        gone = jnp.maximum(jnp.maximum(ex[0], ex[1]), ex[2]) < 1e-20
        tau = [jnp.where(gone, 0.0, x) for x in ex]
        pf = msw * ((ex[0] + ex[1] + ex[2]) * (1.0 / 3.0)) + (1.0 - msw)
        return tau, jnp.maximum(pf, 1e-30)

    # sample points, then one occlusion sweep for all shadow segments
    vv = []
    for k in range(n_vv):
        u0, u1 = u01(2 * k), u01(2 * k + 1)
        new_v = h * jnp.sinh(a0 + u0 * (a1 - a0)) / sin_safe
        inv_dist = 1.0 / jnp.sqrt(h * h + new_v * new_v * sin_safe * sin_safe)
        v_k = _axpy(s, new_v + arc_h, vrl_dir)
        v_u = _axpy(s, u0, sv)
        v_pt = tuple(jnp.where(near_par, v_u[i], v_k[i]) for i in range(3))
        pdf_v = jnp.where(near_par, 1.0 / vrl_len, inv_dist / span_v)
        u_pt, pdf_u = _kulla(o, hp, edir, elen, v_pt, u1)
        vv.append((u_pt, v_pt, pdf_v * pdf_u))
    vs = []
    for k in range(n_vs):
        v_pt, pdf_v = _kulla(s, e, sv_dir, slen, hp, u01(2 * n_vv + k))
        vs.append((v_pt, pdf_v))
    blocked = _blocked_segments(
        tri_ref, n_tris,
        [(u_pt, v_pt) for u_pt, v_pt, _ in vv] + [(hp, v) for v, _ in vs])

    def finish(cs, d_uv):
        ok = (d_uv > 0.0) & jnp.isfinite(cs[0]) & jnp.isfinite(cs[1]) \
            & jnp.isfinite(cs[2])
        return [jnp.where(ok, x, 0.0) for x in cs]

    total = [0.0, 0.0, 0.0]
    for k, (u_pt, v_pt, pdf) in enumerate(vv):
        uv = _sub(u_pt, v_pt)
        d_uv = _length(uv)
        vu = _scale(uv, 1.0 / jnp.maximum(d_uv, 1e-20))
        d_eu = _length(_sub(u_pt, o))
        tau_sv, pf = medium_terms(v_pt)
        inv_pd = _safe_inv(pdf * d_uv * d_uv)
        ph_uv = (_phase(phase_kind, g, _dot(vu, d))
                 * _phase(phase_kind, g, -_dot(sv_dir, vu)))
        cs = []
        for ch in range(3):
            tau_uv = jnp.where(blocked[k], 0.0, jnp.exp(-sig_t[ch] * d_uv))
            x = pw[ch] * sig_s[ch] * sig_s[ch] * inv_pd
            x = x * tau_sv[ch] * tau_uv * jnp.exp(-sig_t[ch] * d_eu)
            if short_vrls:
                x = x / pf
            cs.append(x * ph_uv)
        for ch, x in enumerate(finish(cs, d_uv)):
            total[ch] = total[ch] + x * (1.0 / n_vv)
    for k, (v_pt, pdf_v) in enumerate(vs):
        hv = _sub(hp, v_pt)
        d_uv = _length(hv)
        vu = _scale(hv, 1.0 / jnp.maximum(d_uv, 1e-20))
        tau_sv, pf = medium_terms(v_pt)
        inv_pd = _safe_inv(pdf_v * d_uv * d_uv)
        ph_v = _phase(phase_kind, g, -_dot(sv_dir, vu))
        lambert = jnp.maximum(-_dot(ng, vu), 0.0) * (1.0 / np.pi)
        cs = []
        for ch in range(3):
            tau_uv = jnp.where(blocked[n_vv + k], 0.0,
                               jnp.exp(-sig_t[ch] * d_uv))
            x = pw[ch] * sig_s[ch] * inv_pd * tau_sv[ch] * tau_uv
            if short_vrls:
                x = x / pf
            cs.append(x * ph_v * (alb[ch] * lambert))
        for ch, x in enumerate(finish(cs, d_uv)):
            x = jnp.where(surf_ok, x, 0.0) * tau_e_surf[ch]
            total[ch] = total[ch] + x * (1.0 / n_vs)
    mask = v_valid & r_valid
    return [jnp.where(mask, x, 0.0) for x in total]


# ---------------------------------------------------------------------------
# The kernel: one program per ray block, a loop over VRL tiles inside.
# ---------------------------------------------------------------------------

def _kernel(ray_ref, *refs, n_vtiles, n_tris, block_v, clustered, c_pad,
            **terms):
    if clustered:
        slice_ref, vrl_ref, med_ref, tri_ref, seed_ref, out_ref = refs
    else:
        vrl_ref, med_ref, tri_ref, seed_ref, out_ref = refs
    block_r = ray_ref.shape[1]
    ray = [ray_ref[k, :][:, None] for k in range(RAY_ROWS)]
    ray_idx = pl.program_id(0) * block_r + jnp.arange(block_r)[:, None]
    ray_h = rng.ray_hash(seed_ref[0], ray_idx)
    med = [med_ref[k] for k in range(8)]
    if clustered:
        row0 = slice_ref[:][:, None] * (VRL_ROWS * c_pad)

    def body(j, acc):
        cols = j * block_v + jnp.arange(block_v)[None, :]
        if clustered:
            # each ray reads its own slice's representatives
            vrl = [vrl_ref[row0 + k * c_pad + cols] for k in range(VRL_ROWS)]
        else:
            vrl = [vrl_ref[k, pl.ds(j * block_v, block_v)][None, :]
                   for k in range(VRL_ROWS)]
        terms_ch = _pair_terms(ray, vrl, med, ray_h, cols, tri_ref, n_tris,
                               **terms)
        return tuple(acc[ch] + jnp.sum(terms_ch[ch], axis=1)
                     for ch in range(3))

    zero = jnp.zeros((block_r,), jnp.float32)
    acc = jax.lax.fori_loop(0, n_vtiles, body, (zero, zero, zero))
    for ch in range(3):
        out_ref[ch, :] = acc[ch]


@partial(jax.jit, static_argnames=("cfg", "phase_kind", "block",
                                   "interpret", "c_pad"))
def _pair_call(ray_pack, slice_of_ray, vrl_pack, med_pack, tri_pack, seed,
               *, cfg, phase_kind, block, interpret, c_pad=0):
    """(3, B) per-ray sums. ray_pack (RAY_ROWS, B) with B a multiple of
    the ray block; unclustered: vrl_pack (VRL_ROWS, N), N a multiple of
    the VRL tile, slice_of_ray None; clustered: vrl_pack the flattened
    (S, VRL_ROWS, c_pad) tables, slice_of_ray (B,) int32."""
    block_r, block_v, num_warps = block
    b = ray_pack.shape[1]
    clustered = slice_of_ray is not None
    n_cols = c_pad if clustered else vrl_pack.shape[1]
    kernel = partial(
        _kernel, n_vtiles=n_cols // block_v, n_tris=tri_pack.shape[1],
        block_v=block_v, clustered=clustered, c_pad=c_pad,
        n_vv=cfg.vol_vol_samples, n_vs=cfg.vol_surf_samples,
        short_vrls=cfg.short_vrls, phase_kind=phase_kind,
    )
    ray_spec = pl.BlockSpec((RAY_ROWS, block_r), lambda i: (0, i))
    whole = pl.no_block_spec
    in_specs = [ray_spec] + ([pl.BlockSpec((block_r,), lambda i: (i,))]
                             if clustered else []) + [whole] * 4
    operands = [ray_pack] + ([slice_of_ray] if clustered else []) + [
        vrl_pack, med_pack, tri_pack, jnp.reshape(seed, (1,))]
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((3, b), jnp.float32),
        grid=(b // block_r,),
        in_specs=in_specs,
        out_specs=pl.BlockSpec((3, block_r), lambda i: (0, i)),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
        interpret=interpret,
        name="vrl_pair_sum",
    )(*operands)


# ---------------------------------------------------------------------------
# Differentiable wrappers: kernel forward, reference backward.
# ---------------------------------------------------------------------------

def _forward(cfg, interpret, block, scene, ray_o, ray_d, hit_p, hit_valid,
             hit_ng, hit_mat, slice_of_ray, vrl_s, vrl_e, vrl_p, vrl_valid,
             seed):
    block_r, block_v, _ = block
    b = ray_o.shape[0]
    rays = _pad_last(pack_rays(scene, ray_o, ray_d, hit_p, hit_valid,
                               hit_ng, hit_mat), block_r)
    vrl = _pad_last(pack_vrls(vrl_s, vrl_e, vrl_p, vrl_valid), block_v)
    c_pad = 0
    if slice_of_ray is not None:
        c_pad = vrl.shape[-1]
        vrl = vrl.reshape(-1)
        slice_of_ray = jnp.pad(slice_of_ray.astype(jnp.int32),
                               (0, rays.shape[1] - b))
    out = _pair_call(rays, slice_of_ray, vrl, pack_medium(scene.medium),
                     pack_tris(scene), seed, cfg=cfg,
                     phase_kind=scene.medium.phase_kind, block=block,
                     interpret=interpret, c_pad=c_pad)
    return out[:, :b].T


def pair_sum(cfg, scene, ray_o, ray_d, hit_p, hit_valid, hit_ng, hit_mat,
             vrl_s, vrl_e, vrl_p, vrl_valid, seed, *, interpret=False,
             block=BLOCK):
    """Kernel counterpart of integrate.pair_sum for one VRL set shared by
    all rays: vrl_* (N, ...). Returns (B, 3) unnormalized sums.
    `interpret` runs the Pallas interpreter (CPU tests); `block` is
    (rays per program, VRLs per tile, warps)."""
    return _pair_sum(cfg, interpret, block, scene, ray_o, ray_d, hit_p,
                     hit_valid, hit_ng, hit_mat, vrl_s, vrl_e, vrl_p,
                     vrl_valid, seed)


def pair_sum_clustered(cfg, scene, ray_o, ray_d, hit_p, hit_valid, hit_ng,
                       hit_mat, slice_of_ray, tab_s, tab_e, tab_p, tab_valid,
                       seed, *, interpret=False, block=BLOCK):
    """Clustered pair sum: ray r sums over the VRL set
    tab_*[slice_of_ray[r]], tab_* (S, C, ...) (representative weights
    folded into tab_p). Returns (B, 3) unnormalized sums."""
    return _pair_sum_clustered(cfg, interpret, block, scene, ray_o, ray_d,
                               hit_p, hit_valid, hit_ng, hit_mat,
                               slice_of_ray, tab_s, tab_e, tab_p, tab_valid,
                               seed)


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _pair_sum(cfg, interpret, block, scene, ray_o, ray_d, hit_p, hit_valid,
              hit_ng, hit_mat, vrl_s, vrl_e, vrl_p, vrl_valid, seed):
    return _forward(cfg, interpret, block, scene, ray_o, ray_d, hit_p,
                    hit_valid, hit_ng, hit_mat, None, vrl_s, vrl_e, vrl_p,
                    vrl_valid, seed)


def _pair_sum_fwd(cfg, interpret, block, *args):
    return _pair_sum(cfg, interpret, block, *args), args


def _pair_sum_bwd(cfg, interpret, block, args, g):
    def reference(scene, o, d, hp, hv, hn, hm, vs, ve, vp, vv, seed):
        return integrate.pair_sum(scene, o, d, hp, hv, hn, hm, vs[None],
                                  ve[None], vp[None], vv[None], seed, cfg)

    return jax.vjp(reference, *args)[1](g)


_pair_sum.defvjp(_pair_sum_fwd, _pair_sum_bwd)


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _pair_sum_clustered(cfg, interpret, block, scene, ray_o, ray_d, hit_p,
                        hit_valid, hit_ng, hit_mat, slice_of_ray, tab_s,
                        tab_e, tab_p, tab_valid, seed):
    return _forward(cfg, interpret, block, scene, ray_o, ray_d, hit_p,
                    hit_valid, hit_ng, hit_mat, slice_of_ray, tab_s, tab_e,
                    tab_p, tab_valid, seed)


def _clustered_fwd(cfg, interpret, block, *args):
    return _pair_sum_clustered(cfg, interpret, block, *args), args


def _clustered_bwd(cfg, interpret, block, args, g):
    def reference(scene, o, d, hp, hv, hn, hm, sl, ts, te, tp, tv, seed):
        return integrate.pair_sum(scene, o, d, hp, hv, hn, hm, ts[sl],
                                  te[sl], tp[sl], tv[sl], seed, cfg)

    return jax.vjp(reference, *args)[1](g)


_pair_sum_clustered.defvjp(_clustered_fwd, _clustered_bwd)
