"""Irawan & Marschner woven-cloth BRDF.

Counterpart of src/bsdfs/irawan.{h,cpp}: a procedural micro-geometry
model of woven cloth. A weave pattern tiles UV space; each tile cell
belongs to a warp or weft yarn segment whose curved-cylinder geometry
produces an analytic specular highlight (filament yarns: specular along
the spine, psi = 0; staple yarns: twisted fibers, psi != 0), plus a
per-yarn Lambertian term. Preserved semantics (file:line citations):

  * tile lookup, segment-center recentring and the pi/2 weft rotation
    (irawan.cpp:201-254);
  * filament integrand: u(v) from the half vector, radius of curvature,
    geometry factor Gu, von-Mises + uniform phase fc, Seeliger
    attenuation with ss-smoothing, l*pi domain transform, constant
    highlight width delta_y clamp (irawan.cpp:390-465);
  * staple integrand: v(u) via atan2 + acos(D), Gv with 1/|sin psi|,
    2*w*umax transform, delta_x clamp (irawan.cpp:484-551);
  * radius of curvature: circle/ellipse/hyperbola/parabola by
    rhat = 1 + kappa (1 + 1/tan umax) (irawan.cpp:555-581);
  * von Mises with the Abramowitz-Stegun I0 polynomials
    (irawan.cpp:587-607) and the Seeliger term (:610-617);
  * specular normalization: 10k cosine/cosine MC of the raw integrand
    under diffuse illumination, norm = N / (max_channel * pi)
    (irawan.cpp:140-172);
  * random per-segment intensity variation min(-log xi, 10) when
    fineness > 0 (irawan.cpp:294-303) — the TEA hash is replaced by an
    integer-hash float (same role: a fixed pseudo-random xi per segment);
  * sampling = cosine hemisphere, weight eval*pi/cos, pdf = cos/pi
    (irawan.cpp:336-371).

Patterns come from (a) plain dicts / make_pattern, (b) two built-in
presets, or (c) the reference's external weave-pattern DSL files via
parse_weave/load_weave_file (the boost.spirit grammar of irawan.h:
228-406 — comments, $param substitution, degree->radian angles,
1-based pattern ids). Everything is a pytree so eval is fully
batched.

Divergence (documented): umax noise via `period` uses our value-noise
instead of Perlin+TEA — same statistics, different stream.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from alvrl_tpu.core import struct

_INV_PI = 1.0 / np.pi


@struct.dataclass
class WeavePattern:
    tile: jax.Array        # (Th, Tw) int32 0-based yarn ids
    yarn_type: jax.Array   # (Y,) 0 = warp, 1 = weft
    psi: jax.Array         # (Y,) fiber twist angle (0 => filament)
    umax: jax.Array        # (Y,) max inclination
    kappa: jax.Array       # (Y,) spine curvature
    width: jax.Array       # (Y,) segment rect width (tile cells)
    length: jax.Array      # (Y,) segment rect length
    center_u: jax.Array    # (Y,) segment center, tile-relative [0,1]
    center_v: jax.Array    # (Y,)
    kd: jax.Array          # (Y, 3)
    ks: jax.Array          # (Y, 3)
    alpha: jax.Array       # uniform phase weight
    beta: jax.Array        # von Mises concentration
    ss: jax.Array          # filament smoothing in [0,1)
    h_width: jax.Array     # highlight width fraction
    warp_area: jax.Array
    weft_area: jax.Array
    fineness: jax.Array    # intensity-variation density (0 = off)
    period: jax.Array      # umax noise period (0 = off)
    d_warp_umax_d_warp: jax.Array
    d_warp_umax_d_weft: jax.Array
    d_weft_umax_d_warp: jax.Array
    d_weft_umax_d_weft: jax.Array
    repeat_u: jax.Array
    repeat_v: jax.Array
    specular_normalization: jax.Array  # set by normalize_pattern


def make_pattern(tile, yarns, alpha=0.05, beta=4.0, ss=0.5, h_width=0.5,
                 warp_area=1.0, weft_area=1.0, fineness=0.0, period=0.0,
                 d_warp=(0.0, 0.0), d_weft=(0.0, 0.0),
                 repeat_u=4.0, repeat_v=4.0) -> WeavePattern:
    """yarns: list of dicts with keys type ('warp'|'weft'), psi, umax,
    kappa, width, length, center_u, center_v, kd, ks (angles in
    radians). tile: (Th, Tw) of 0-based yarn indices."""
    def col(k, default=0.0):
        return jnp.asarray([y.get(k, default) for y in yarns], jnp.float32)

    return WeavePattern(
        tile=jnp.asarray(tile, jnp.int32),
        yarn_type=jnp.asarray(
            [0 if y["type"] == "warp" else 1 for y in yarns], jnp.int32),
        psi=col("psi"), umax=col("umax"), kappa=col("kappa"),
        width=col("width", 1.0), length=col("length", 1.0),
        center_u=col("center_u", 0.5), center_v=col("center_v", 0.5),
        kd=jnp.asarray([y["kd"] for y in yarns], jnp.float32),
        ks=jnp.asarray([y["ks"] for y in yarns], jnp.float32),
        alpha=jnp.float32(alpha), beta=jnp.float32(beta),
        ss=jnp.float32(ss), h_width=jnp.float32(h_width),
        warp_area=jnp.float32(warp_area), weft_area=jnp.float32(weft_area),
        fineness=jnp.float32(fineness), period=jnp.float32(period),
        d_warp_umax_d_warp=jnp.float32(d_warp[0]),
        d_warp_umax_d_weft=jnp.float32(d_warp[1]),
        d_weft_umax_d_warp=jnp.float32(d_weft[0]),
        d_weft_umax_d_weft=jnp.float32(d_weft[1]),
        repeat_u=jnp.float32(repeat_u), repeat_v=jnp.float32(repeat_v),
        specular_normalization=jnp.float32(0.0),
    )


def _deg(x):
    return x * np.pi / 180.0


def plain_weave(kd=(0.3, 0.3, 0.45), ks=(0.4, 0.4, 0.5),
                repeat_u=8.0, repeat_v=8.0) -> WeavePattern:
    """Classic 2x2 plain weave, staple (twisted) yarns — a generic
    cotton-like cloth."""
    w = dict(type="warp", psi=_deg(30), umax=_deg(35), kappa=0.0,
             width=1.0, length=1.0, kd=kd, ks=ks)
    f = dict(type="weft", psi=_deg(30), umax=_deg(35), kappa=0.0,
             width=1.0, length=1.0, kd=kd, ks=ks)
    yarns = [
        dict(w, center_u=0.25, center_v=0.25),
        dict(f, center_u=0.75, center_v=0.25),
        dict(f, center_u=0.25, center_v=0.75),
        dict(w, center_u=0.75, center_v=0.75),
    ]
    tile = [[0, 1],
            [2, 3]]
    return make_pattern(tile, yarns, alpha=0.1, beta=4.0, ss=0.4,
                        h_width=0.5, repeat_u=repeat_u, repeat_v=repeat_v)


def silk_like_weave(kd=(0.1, 0.1, 0.15), ks=(0.9, 0.9, 1.0),
                    repeat_u=12.0, repeat_v=12.0) -> WeavePattern:
    """2x2 weave with filament (untwisted, psi = 0) yarns and strong
    anisotropic sheen — a charmeuse-like look exercising the filament
    integrand."""
    w = dict(type="warp", psi=0.0, umax=_deg(25), kappa=-0.5,
             width=1.0, length=1.0, kd=kd, ks=ks)
    f = dict(type="weft", psi=0.0, umax=_deg(25), kappa=-0.5,
             width=1.0, length=1.0, kd=kd, ks=ks)
    yarns = [
        dict(w, center_u=0.25, center_v=0.25),
        dict(f, center_u=0.75, center_v=0.25),
        dict(f, center_u=0.25, center_v=0.75),
        dict(w, center_u=0.75, center_v=0.75),
    ]
    tile = [[0, 1],
            [2, 3]]
    return make_pattern(tile, yarns, alpha=0.02, beta=6.0, ss=0.3,
                        h_width=0.5, repeat_u=repeat_u, repeat_v=repeat_v)


# ---------------------------------------------------------------------------
# model pieces
# ---------------------------------------------------------------------------

def _i0(x):
    """Modified Bessel I0, Abramowitz-Stegun (irawan.cpp:590-601)."""
    ax = jnp.abs(x)
    t_s = (ax / 3.75) ** 2
    small = 1.0 + t_s * (3.5156229 + t_s * (3.0899424 + t_s * (
        1.2067492 + t_s * (0.2659732 + t_s * (0.0360768
                                              + t_s * 0.0045813)))))
    t_l = 3.75 / jnp.maximum(ax, 3.75)
    big = jnp.exp(ax) / jnp.sqrt(jnp.maximum(ax, 1e-6)) * (
        0.39894228 + t_l * (0.01328592 + t_l * (0.00225319 + t_l * (
            -0.00157565 + t_l * (0.00916281 + t_l * (-0.02057706 + t_l * (
                0.02635537 + t_l * (-0.01647633 + t_l * 0.00392377))))))))
    return jnp.where(ax <= 3.75, small, big)


def _von_mises(cos_x, b):
    return jnp.exp(b * cos_x) / (2.0 * np.pi * _i0(b))


def _seeliger(c1, c2):
    c1 = jnp.maximum(c1, 0.0)
    c2 = jnp.maximum(c2, 0.0)
    ok = (c1 > 0.0) & (c2 > 0.0)
    return jnp.where(
        ok, (1.0 / (4.0 * np.pi)) * c1 * c2 / jnp.maximum(c1 + c2, 1e-12),
        0.0)


def _smoothstep(x):
    t = jnp.clip(x, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _radius_of_curvature(u, umax, kappa, w, l):
    """irawan.cpp:555-581, branchless over the conic type."""
    a = 0.5 * w
    tan_umax = jnp.tan(jnp.maximum(umax, 1e-4))
    rhat = 1.0 + kappa * (1.0 + 1.0 / tan_umax)
    sin_umax = jnp.sin(umax)
    base = 0.5 * l - a * sin_umax

    # circle
    r_circ = base / jnp.maximum(sin_umax, 1e-6)

    # ellipse (rhat > 0)
    rhat_pos = jnp.maximum(rhat, 1e-6)
    tmax_e = jnp.arctan(rhat_pos * tan_umax)
    bhat_e = base / jnp.maximum(jnp.sin(tmax_e), 1e-6)
    ahat_e = bhat_e / rhat_pos
    t_e = jnp.arctan(rhat_pos * jnp.tan(u))
    r_ell = (bhat_e ** 2 * jnp.cos(t_e) ** 2
             + ahat_e ** 2 * jnp.sin(t_e) ** 2) ** 1.5 \
        / jnp.maximum(ahat_e * bhat_e, 1e-12)

    # hyperbola (rhat < 0)
    def atanh(x):
        xc = jnp.clip(x, -0.999999, 0.999999)
        return 0.5 * jnp.log((1.0 + xc) / (1.0 - xc))
    rhat_neg = jnp.minimum(rhat, -1e-6)
    tmax_h = -atanh(rhat_neg * tan_umax)
    bhat_h = base / jnp.maximum(jnp.sinh(tmax_h), 1e-6)
    ahat_h = bhat_h / rhat_neg
    t_h = -atanh(rhat_neg * jnp.tan(u))
    r_hyp = -(bhat_h ** 2 * jnp.cosh(t_h) ** 2
              + ahat_h ** 2 * jnp.sinh(t_h) ** 2) ** 1.5 \
        / jnp.minimum(ahat_h * bhat_h, -1e-12)

    # parabola (rhat == 0)
    tmax_p = tan_umax
    ahat_p = base / jnp.maximum(2.0 * tmax_p, 1e-6)
    t_p = jnp.tan(u)
    r_par = 2.0 * ahat_p * (1.0 + t_p * t_p) ** 1.5

    eps = 1e-5
    return jnp.where(
        jnp.abs(rhat - 1.0) < eps, r_circ,
        jnp.where(rhat > eps, r_ell,
                  jnp.where(rhat < -eps, r_hyp, r_par)))


def _filament_integrand(u, v, om_i, om_r, alpha, beta, ss, umax, kappa,
                        w, l, h_width):
    """irawan.cpp:390-465 (vectorized, masks instead of early returns)."""
    h = om_i + om_r
    h = h / jnp.maximum(
        jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-12)
    u_of_v = jnp.arctan(h[..., 1] / jnp.maximum(jnp.abs(h[..., 2]), 1e-12)
                        * jnp.sign(h[..., 2]))
    ok = (jnp.abs(u_of_v) < umax) & (w * jnp.sin(umax) < l) & (kappa > -1.0)

    sin_u, cos_u = jnp.sin(u_of_v), jnp.cos(u_of_v)
    sin_v, cos_v = jnp.sin(v), jnp.cos(v)
    n = jnp.stack([sin_v, sin_u * cos_v, cos_u * cos_v], axis=-1)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    t = jnp.stack([jnp.zeros_like(u_of_v), cos_u, -sin_u], axis=-1)

    R = _radius_of_curvature(
        jnp.minimum(jnp.abs(u_of_v), (1.0 - ss) * umax),
        (1.0 - ss) * umax, kappa, w, l)

    a = 0.5 * w
    s_vec = om_i + om_r
    s_len = jnp.maximum(jnp.linalg.norm(s_vec, axis=-1), 1e-12)
    t_cross_h = jnp.cross(t, h)
    gu = a * (R + a * cos_v) / (
        s_len * jnp.maximum(jnp.abs(t_cross_h[..., 0]), 1e-6))

    fc = alpha + _von_mises(-jnp.sum(om_i * om_r, axis=-1), beta)
    A = _seeliger(jnp.sum(n * om_i, axis=-1), jnp.sum(n * om_r, axis=-1))
    As = jnp.where(
        ss > 0.0,
        A * (1.0 - _smoothstep(
            (jnp.abs(u_of_v) - (1.0 - ss) * umax)
            / jnp.maximum(ss * umax, 1e-6))),
        A)
    fs = gu * fc * As * np.pi * l

    delta_y = l * h_width
    y_of_v = jnp.clip(u_of_v * 0.5 * l / jnp.maximum(umax, 1e-6),
                      0.5 * (delta_y - l), 0.5 * (l - delta_y))
    in_hl = jnp.abs(
        y_of_v - u * 0.5 * l / jnp.maximum(umax, 1e-6)) < 0.5 * delta_y
    return jnp.where(ok & in_hl, fs / jnp.maximum(delta_y, 1e-12), 0.0)


def _staple_integrand(u, v, om_i, om_r, alpha, beta, psi, umax, kappa,
                      w, l, h_width):
    """irawan.cpp:484-551 (vectorized)."""
    h = om_i + om_r
    h = h / jnp.maximum(
        jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-12)
    sin_u, cos_u = jnp.sin(u), jnp.cos(u)
    hy, hz, hx = h[..., 1], h[..., 2], h[..., 0]
    tan_psi = jnp.tan(jnp.maximum(jnp.abs(psi), 1e-4)) * jnp.sign(
        jnp.where(psi == 0.0, 1.0, psi))
    denom = jnp.sqrt(hx * hx + (hy * sin_u + hz * cos_u) ** 2) * tan_psi
    D = (hy * cos_u - hz * sin_u) / jnp.where(
        jnp.abs(denom) > 1e-12, denom, 1e-12)
    v_of_u = jnp.arctan2(-hy * sin_u - hz * cos_u, hx) \
        + jnp.arccos(jnp.clip(D, -1.0, 1.0))
    ok = (jnp.abs(D) < 1.0) & (jnp.abs(v_of_u) < 0.5 * np.pi) \
        & (w * jnp.sin(umax) < l) & (kappa > -1.0)

    sin_vu, cos_vu = jnp.sin(v_of_u), jnp.cos(v_of_u)
    n = jnp.stack([sin_vu, sin_u * cos_vu, cos_u * cos_vu], axis=-1)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12)

    R = _radius_of_curvature(jnp.abs(u), umax, kappa, w, l)
    a = 0.5 * w
    s_len = jnp.maximum(jnp.linalg.norm(om_i + om_r, axis=-1), 1e-12)
    n_dot_h = jnp.maximum(jnp.abs(jnp.sum(n * h, axis=-1)), 1e-6)
    gv = a * (R + a * cos_vu) / (
        s_len * n_dot_h * jnp.maximum(jnp.abs(jnp.sin(psi)), 1e-6))

    fc = alpha + _von_mises(-jnp.sum(om_i * om_r, axis=-1), beta)
    A = _seeliger(jnp.sum(n * om_i, axis=-1), jnp.sum(n * om_r, axis=-1))
    fs = gv * fc * A * 2.0 * w * umax

    delta_x = w * h_width
    x_of_u = jnp.clip(v_of_u * w / np.pi,
                      0.5 * (delta_x - w), 0.5 * (w - delta_x))
    in_hl = jnp.abs(x_of_u - v * w / np.pi) < 0.5 * delta_x
    return jnp.where(ok & in_hl, fs / jnp.maximum(delta_x, 1e-12), 0.0)


def _hash01(i, j):
    """Integer-hash float in [0,1) per (i, j) — the TEA-float stand-in
    for the per-segment intensity variation (irawan.cpp:294-303)."""
    x = (i.astype(jnp.uint32) * jnp.uint32(0x9E3779B1)
         ^ j.astype(jnp.uint32) * jnp.uint32(0x85EBCA77))
    x = (x ^ (x >> 15)) * jnp.uint32(0x2C1B3C6D)
    x = (x ^ (x >> 12)) * jnp.uint32(0x297A2D39)
    x = x ^ (x >> 15)
    return x.astype(jnp.float32) * (1.0 / 4294967296.0)


def eval_raw(pat: WeavePattern, uv, wi_l, wo_l, with_kd: bool = True,
             normalized: bool = True):
    """f(wi, wo) * cos(theta_o) in the local shading frame; batched over
    leading dims. uv in [0,1]^2 (mesh parameterization)."""
    th, tw = pat.tile.shape
    cos_i = wi_l[..., 2]
    cos_o = wo_l[..., 2]
    front = (cos_i > 0.0) & (cos_o > 0.0)

    uu = uv[..., 0] * pat.repeat_u
    vv = (1.0 - uv[..., 1]) * pat.repeat_v
    x = uu * tw
    y = vv * th
    lx = jnp.mod(jnp.floor(x).astype(jnp.int32), tw)
    ly = jnp.mod(jnp.floor(y).astype(jnp.int32), th)
    yid = pat.tile[ly, lx]

    def yp(arr):
        return arr[yid]

    cu, cv = yp(pat.center_u), yp(pat.center_v)
    cx = jnp.floor(x / tw) * tw + cu * tw
    cy = jnp.floor(y / th) * th + (1.0 - cv) * th
    rx = x - cx
    ry = -(y - cy)

    is_weft = yp(pat.yarn_type) == 1
    # pi/2 rotation about z for weft segments (irawan.cpp:243-253)
    rx_r = jnp.where(is_weft, -ry, rx)
    ry_r = jnp.where(is_weft, rx, ry)

    def rot(v3):
        vx = jnp.where(is_weft, -v3[..., 1], v3[..., 0])
        vy = jnp.where(is_weft, v3[..., 0], v3[..., 1])
        return jnp.stack([vx, vy, v3[..., 2]], axis=-1)

    om_i = rot(wi_l)
    om_r = rot(wo_l)

    w = yp(pat.width)
    l = yp(pat.length)
    psi = yp(pat.psi)
    kappa = yp(pat.kappa)
    umax = yp(pat.umax)
    # umax noise (period > 0): value noise per segment center
    if True:
        from alvrl_tpu.textures.procedural import value_noise

        d_uw = jnp.where(is_weft, pat.d_weft_umax_d_warp,
                         pat.d_warp_umax_d_warp)
        d_uf = jnp.where(is_weft, pat.d_weft_umax_d_weft,
                         pat.d_warp_umax_d_weft)
        per = jnp.maximum(pat.period, 1e-6)
        p1 = jnp.stack([cx / per, cy / per, jnp.zeros_like(cx)], axis=-1)
        p2 = jnp.stack([cy / per, cx / per, 0.5 + jnp.zeros_like(cx)],
                       axis=-1)
        r1 = 2.0 * value_noise(p1) - 1.0
        r2 = 2.0 * value_noise(p2) - 1.0
        umax = jnp.where(pat.period > 0.0,
                         umax + r1 * d_uw + r2 * d_uf, umax)

    u = ry_r / (0.5 * l) * umax
    v = rx_r * np.pi / w

    f_fil = _filament_integrand(
        u, v, om_i, om_r, pat.alpha, pat.beta, pat.ss, umax, kappa, w, l,
        pat.h_width)
    f_sta = _staple_integrand(
        u, v, om_i, om_r, pat.alpha, pat.beta, psi, umax, kappa, w, l,
        pat.h_width)
    integrand = jnp.where(psi != 0.0, f_sta, f_fil)

    # per-segment intensity variation (fineness > 0)
    i1 = jnp.floor((cx + rx) * pat.fineness).astype(jnp.int32)
    i2 = jnp.floor((cy + ry) * pat.fineness).astype(jnp.int32)
    xi = _hash01(i1, i2)
    ivar = jnp.where(pat.fineness > 0.0,
                     jnp.minimum(-jnp.log(jnp.maximum(xi, 1e-10)), 10.0),
                     1.0)

    area_f = jnp.where(
        is_weft,
        (pat.warp_area + pat.weft_area) / pat.weft_area,
        (pat.warp_area + pat.weft_area) / pat.warp_area)

    spec_scale = ivar * integrand * area_f
    if normalized:
        spec_scale = spec_scale * pat.specular_normalization
        result = yp(pat.ks) * spec_scale[..., None]
        if with_kd:
            result = result + yp(pat.kd) * _INV_PI
    else:
        result = jnp.broadcast_to(spec_scale[..., None],
                                  spec_scale.shape + (3,))
    return jnp.where(front[..., None], result * cos_o[..., None], 0.0)


@partial(jax.jit, static_argnames=("n_samples",))
def _norm_mc(pat: WeavePattern, key, n_samples: int = 10000):
    from alvrl_tpu.core import warp as warp_mod

    k1, k2, k3 = jax.random.split(key, 3)
    u_i = jax.random.uniform(k1, (n_samples, 2))
    u_o = jax.random.uniform(k2, (n_samples, 2))
    uv = jax.random.uniform(k3, (n_samples, 2))
    wi = warp_mod.square_to_cosine_hemisphere(u_i)
    wo = warp_mod.square_to_cosine_hemisphere(u_o)
    f = eval_raw(pat, uv, wi, wo, normalized=False)
    # eval/cos accumulated as in the reference (irawan.cpp:162)
    s = (f / jnp.maximum(wo[..., 2:3], 1e-6)).sum(0)
    return s.max()


def normalize_pattern(pat: WeavePattern, key=None,
                      n_samples: int = 10000) -> WeavePattern:
    """MC-estimate the specular normalization (irawan.cpp:150-171)."""
    if key is None:
        key = jax.random.key(1234)
    mx = _norm_mc(pat, key, n_samples)
    norm = jnp.where(mx > 0.0, n_samples / jnp.maximum(mx * np.pi, 1e-12),
                     0.0)
    return pat.replace(specular_normalization=jnp.float32(norm))


def sample_cosine(pat: WeavePattern, uv, wi_l, u2):
    """Cosine-hemisphere sampling (irawan.cpp:336-371): returns
    (wo_l, weight = eval*pi/cos, pdf)."""
    from alvrl_tpu.core import warp as warp_mod

    wo_l = warp_mod.square_to_cosine_hemisphere(u2)
    cos_o = jnp.maximum(wo_l[..., 2], 1e-6)
    f_cos = eval_raw(pat, uv, wi_l, wo_l)
    weight = f_cos * (np.pi / cos_o)[..., None]
    pdf = cos_o * _INV_PI
    return wo_l, weight, pdf


# ---------------------------------------------------------------------------
# Weave-pattern description files (the reference's boost.spirit DSL,
# irawan.h:228-406): `weave { key = value, ..., pattern { ids... },
# yarn { ... }, ... }` with /* */ comments, $identifier substitution
# from scene parameters, 1-based yarn ids in `pattern`, and angles in
# degrees (psi, umax, dW*OverD*) converted to radians on load.
# ---------------------------------------------------------------------------

import re as _re

_ANGLE_KEYS = {"psi", "umax", "dWarpUmaxOverDWarp", "dWarpUmaxOverDWeft",
               "dWeftUmaxOverDWarp", "dWeftUmaxOverDWeft"}


def _tokenize_weave(text):
    text = _re.sub(r"/\*.*?\*/", " ", text, flags=_re.S)
    return _re.findall(
        r'"[^"]*"|\$[A-Za-z_]\w*|[A-Za-z_]\w*|[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?'
        r"|[{}=,]", text)


def parse_weave(text, params=None) -> WeavePattern:
    """Parse a weave-pattern description (irawan.cpp's `filename`
    format) into a WeavePattern. `params` resolves $identifier
    placeholders (the reference resolves them from the BSDF's
    Properties, irawan.h:81,337)."""
    params = params or {}
    toks = _tokenize_weave(text)
    pos = 0

    def peek():
        return toks[pos] if pos < len(toks) else None

    def take(expect=None):
        nonlocal pos
        t = toks[pos]
        if expect is not None and t != expect:
            raise ValueError(f"weave parse: expected {expect!r}, got {t!r}")
        pos += 1
        return t

    def value():
        t = take()
        if t.startswith("$"):
            name = t[1:]
            if name not in params:
                raise ValueError(f"weave parse: unresolved ${name}")
            return float(params[name])
        return float(t)

    take("weave")
    take("{")
    fields = {}
    yarns = []
    pattern = []
    while peek() != "}":
        if peek() == ",":
            take()
            continue
        key = take()
        if key == "pattern":
            take("{")
            while peek() != "}":
                if peek() == ",":
                    take()
                    continue
                pattern.append(int(float(take())))
            take("}")
        elif key == "yarn":
            take("{")
            y = {}
            while peek() != "}":
                if peek() == ",":
                    take()
                    continue
                yk = take()
                take("=")
                if yk == "type":
                    y["type"] = take()
                elif yk in ("kd", "ks"):
                    take("{")
                    rgb = [value()]
                    take(",")
                    rgb.append(value())
                    take(",")
                    rgb.append(value())
                    take("}")
                    y[yk] = rgb
                else:
                    v = value()
                    if yk in _ANGLE_KEYS:
                        v = v * np.pi / 180.0
                    key_map = {"centerU": "center_u", "centerV": "center_v"}
                    y[key_map.get(yk, yk)] = v
            take("}")
            y.setdefault("kd", [0.5, 0.5, 0.5])
            y.setdefault("ks", [0.5, 0.5, 0.5])
            yarns.append(y)
        elif key == "name":
            take("=")
            fields["name"] = take().strip('"')
        else:
            take("=")
            v = value()
            if key in _ANGLE_KEYS:
                v = v * np.pi / 180.0
            fields[key] = v
    take("}")

    tw = int(fields["tileWidth"])
    th = int(fields["tileHeight"])
    if len(pattern) != tw * th:
        raise ValueError(
            f"weave parse: pattern has {len(pattern)} entries, tile is "
            f"{tw}x{th}")
    ids = np.asarray(pattern, np.int32).reshape(th, tw) - 1  # 1-based
    if ids.min() < 0 or ids.max() >= len(yarns):
        raise ValueError("weave parse: pattern references missing yarns")
    return make_pattern(
        ids, yarns,
        alpha=fields.get("alpha", 0.05), beta=fields.get("beta", 4.0),
        ss=fields.get("ss", 0.5), h_width=fields.get("hWidth", 0.5),
        warp_area=fields.get("warpArea", 1.0),
        weft_area=fields.get("weftArea", 1.0),
        fineness=fields.get("fineness", 0.0),
        period=fields.get("period", 0.0),
        d_warp=(fields.get("dWarpUmaxOverDWarp", 0.0),
                fields.get("dWarpUmaxOverDWeft", 0.0)),
        d_weft=(fields.get("dWeftUmaxOverDWarp", 0.0),
                fields.get("dWeftUmaxOverDWeft", 0.0)),
    )


def load_weave_file(path, params=None, repeat_u=4.0,
                    repeat_v=4.0) -> WeavePattern:
    with open(path) as f:
        pat = parse_weave(f.read(), params)
    return pat.replace(repeat_u=jnp.float32(repeat_u),
                       repeat_v=jnp.float32(repeat_v))
