"""Phase functions: Henyey-Greenstein (isotropic as the g=0 case) and
Rayleigh, behind a static per-medium kind switch.

Counterpart of src/phase/{isotropic,hg,rayleigh}.cpp. Convention matches
the reference's PhaseFunctionSamplingRecord: `eval(g, wi, wo)` with the
HG lobe written in terms of dot(wi, wo), i.e. the reference evaluates
eval(pRec(mRec, -VU, -EU)) with wi pointing *away* from the propagation
direction of the incoming light (hg.cpp:107-110).

Sampling returns weight 1 (perfect importance sampling: hg.cpp:73-97;
rayleigh.cpp samples its exact CDF by a Cardano cubic inversion).

The kind is a *static* python int on the medium (one phase function per
medium, as in the reference's scene graph), so XLA compiles only the
branch taken; kkay/microflake (oriented media) are a planned round-2
item together with orientation volumes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from alvrl_tpu.core import math as m

# phase kinds (static per-medium)
HG = 0          # hg.cpp (g=0 == isotropic.cpp)
RAYLEIGH = 1    # rayleigh.cpp
KKAY = 2        # kkay.cpp (Kajiya-Kay fibers; needs orientation)
MICROFLAKE = 3  # microflake.cpp (Gaussian fiber flakes; orientation)
MIXTURE = 4     # mixturephase.cpp: convex combination of components

_G_EPS = 1e-4


def eval_hg(g, wi, wo):
    """HG phase value; INV_FOURPI * (1-g^2) / (1+g^2+2g cos)^(3/2)."""
    temp = 1.0 + g * g + 2.0 * g * m.dot(wi, wo)
    temp = jnp.maximum(temp, 1e-12)
    return m.INV_FOURPI * (1.0 - g * g) / (temp * jnp.sqrt(temp))


def sample_hg(g, wi, u2):
    """Sample wo given wi; returns (wo, weight=1, pdf).

    Branchless mix of the isotropic (|g| < eps) and HG inverse-CDF cases
    (hg.cpp:73-97). wo is built in the frame around -wi, as the reference
    does (pRec.wo = Frame(-wi).toWorld(...)).
    """
    u0, u1 = u2[..., 0], u2[..., 1]
    g_safe = jnp.where(jnp.abs(g) < _G_EPS, _G_EPS, g)
    sqr_term = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe * u0)
    cos_hg = (1.0 + g_safe * g_safe - sqr_term * sqr_term) / (2.0 * g_safe)
    cos_iso = 1.0 - 2.0 * u0
    cos_theta = jnp.where(jnp.abs(g) < _G_EPS, cos_iso, cos_hg)
    phi = 2.0 * jnp.pi * u1
    local = m.spherical_direction(cos_theta, phi)
    axis = -wi
    s, t = m.build_frame(axis)
    wo = m.frame_to_world(s, t, axis, local)
    pdf = eval_hg(g, wi, wo)
    return wo, jnp.ones_like(pdf), pdf


def eval_rayleigh(wi, wo):
    """Rayleigh lobe 3/(16pi) * (1 + cos^2) with cos = dot(wi, wo)
    (rayleigh.cpp eval; same wi convention as HG)."""
    c = m.dot(wi, wo)
    return (3.0 / (16.0 * jnp.pi)) * (1.0 + c * c)


def sample_rayleigh(wi, u2):
    """Exact inverse-CDF sampling of the Rayleigh lobe.

    cos(theta) solves the depressed cubic mu^3 + 3 mu = 8u - 4
    (CDF of 3/8 (1+mu^2)); Cardano: mu = c - 1/c with
    c = cbrt(q + sqrt(q^2 + 1)), q = 4u - 2 (rayleigh.cpp sample).
    Returns (wo, weight=1, pdf)."""
    u0, u1 = u2[..., 0], u2[..., 1]
    q = 4.0 * u0 - 2.0
    croot = jnp.cbrt(q + jnp.sqrt(q * q + 1.0))
    cos_theta = jnp.clip(croot - 1.0 / croot, -1.0, 1.0)
    phi = 2.0 * jnp.pi * u1
    local = m.spherical_direction(cos_theta, phi)
    axis = -wi
    s, t = m.build_frame(axis)
    wo = m.frame_to_world(s, t, axis, local)
    pdf = eval_rayleigh(wi, wo)
    return wo, jnp.ones_like(pdf), pdf


# ---------------------------------------------------------------------------
# Oriented-media phase functions: Kajiya-Kay and the Gaussian micro-flake
# model (src/phase/kkay.cpp, microflake.cpp + microflake_fiber.h).
# Both evaluate against a local fiber orientation supplied by the medium.
# ---------------------------------------------------------------------------

class PhaseParams(NamedTuple):
    """Static-shape parameter bundle for oriented phase functions.
    kkay: ks/kd/exponent/norm; microflake: stddev + sigma_t lut;
    mixture: component weights/kinds/g."""

    ks: jax.Array = None
    kd: jax.Array = None
    exponent: jax.Array = None
    norm: jax.Array = None
    stddev: jax.Array = None
    sigma_t_lut: jax.Array = None  # (K,) sigma_t(|cos theta|), theta vs fiber
    mix_w: jax.Array = None        # (K,) normalized component weights
    mix_kind: jax.Array = None     # (K,) int32 component kinds (HG/RAYLEIGH)
    mix_g: jax.Array = None        # (K,) HG g per component (0 = isotropic)


def kkay_params(ks=0.4, kd=0.2, exponent=4.0) -> PhaseParams:
    """Kajiya-Kay with the reference's Simpson-quadrature normalization
    of the cos^n lobe under perpendicular illumination (kkay.cpp:58-75)."""
    n_parts = 1000
    theta = np.linspace(0.0, np.pi, n_parts + 1)
    vals = np.cos(theta - np.pi / 2) ** exponent * np.sin(theta)
    w = np.ones(n_parts + 1)
    w[1:-1:2], w[2:-1:2] = 4.0, 2.0
    integral = (vals * w).sum() * (np.pi / n_parts) / 3.0
    norm = 1.0 / (integral * 2.0 * np.pi)
    return PhaseParams(
        ks=jnp.float32(ks), kd=jnp.float32(kd),
        exponent=jnp.float32(exponent), norm=jnp.float32(norm),
    )


def microflake_params(stddev=0.2, lut_size=128, n_quad=512) -> PhaseParams:
    """Gaussian fiber micro-flake distribution (Zhao et al. 2011 as in
    microflake_fiber.h). sigma_t(cos theta_i) = int |w_i . m| D(m) dm is
    precomputed on a |cos| grid by host quadrature (the reference ships
    fitted polynomial tables; a direct lut is simpler and as accurate)."""
    s = float(stddev)
    norm = _microflake_norm(s)
    # quadrature over the sphere of flake normals m: polar about the
    # fiber axis (mz = cos), azimuth phi; w_i at angle theta_i from the
    # axis in the xz-plane
    mz = (np.arange(n_quad) + 0.5) / n_quad * 2.0 - 1.0     # midpoints
    phi = (np.arange(n_quad) + 0.5) / n_quad * 2.0 * np.pi
    sz = np.sqrt(np.maximum(0.0, 1.0 - mz * mz))
    d_flake = norm * np.exp(-mz * mz / (2 * s * s))          # (Q,)
    cos_i = (np.arange(lut_size) / (lut_size - 1)).astype(np.float64)
    sin_i = np.sqrt(np.maximum(0.0, 1.0 - cos_i ** 2))
    # dot(w_i, m) = sin_i * sz * cos(phi) + cos_i * mz
    dots = np.abs(
        sin_i[:, None, None] * (sz[None, :, None] * np.cos(phi)[None, None, :])
        + cos_i[:, None, None] * mz[None, :, None]
    )                                                        # (L, Q, Q)
    lut = (dots * d_flake[None, :, None]).sum(axis=(1, 2)) * (
        (2.0 / n_quad) * (2.0 * np.pi / n_quad)
    )
    return PhaseParams(
        stddev=jnp.float32(s),
        sigma_t_lut=jnp.asarray(lut, jnp.float32),
    )


def _lut_interp(lut, x):
    """Linear interpolation of a (K,) lut over x in [0, 1]."""
    k = lut.shape[0]
    g = jnp.clip(x, 0.0, 1.0) * (k - 1)
    i0 = jnp.clip(jnp.floor(g).astype(jnp.int32), 0, k - 2)
    f = g - i0
    return lut[i0] * (1.0 - f) + lut[i0 + 1] * f


def microflake_sigma_dir(pp: PhaseParams, cos_theta):
    """Directionally varying extinction factor sigmaDir = 2 sigma_t
    (microflake.cpp:sigmaDir — scaled so an isotropic flake
    distribution reproduces an isotropic medium)."""
    return 2.0 * _lut_interp(pp.sigma_t_lut, jnp.abs(cos_theta))


def _fiber_pdf_cos(pp: PhaseParams, c):
    s = pp.stddev
    norm = 1.0 / (
        (2.0 * jnp.pi) ** 1.5 * s
        * jax.scipy.special.erf(1.0 / (jnp.sqrt(2.0) * s))
    )
    return jnp.exp(-c * c / (2.0 * s * s)) * norm


def eval_microflake(pp: PhaseParams, orientation, wi, wo):
    """0.5 * D(cos_h) / sigma_t(cos_i) in the fiber frame
    (microflake.cpp:eval); zero where the orientation is undefined."""
    olen = m.length(orientation)
    o = orientation / jnp.maximum(olen, 1e-12)[..., None]
    h = wi + wo
    hlen = m.length(h)
    cos_h = m.dot(h, o) / jnp.maximum(hlen, 1e-12)
    cos_i = m.dot(wi, o)
    sig = _lut_interp(pp.sigma_t_lut, jnp.abs(cos_i))
    val = 0.5 * _fiber_pdf_cos(pp, cos_h) / jnp.maximum(sig, 1e-12)
    return jnp.where((olen > 1e-8) & (hlen > 1e-12), val, 0.0)


def sample_microflake(pp: PhaseParams, orientation, wi, u_sir):
    """Flake-normal sampling: the reference rejection-samples H ~ D and
    accepts with |wi.H| (microflake.cpp:sample). Array re-design: draw a
    fixed batch of K candidates and pick one by sampling-importance-
    resampling on |wi.H| — fixed shape, no data-dependent loop; bias is
    O(1/K) and chi-square-tested. u_sir: (K, 3) uniforms (2 per
    candidate; u_sir[0, 2] selects the winner)."""
    olen = m.length(orientation)
    o = orientation / jnp.maximum(olen, 1e-12)[..., None]
    s_f, t_f = m.build_frame(o)
    s = pp.stddev
    c1 = jax.scipy.special.erf(1.0 / (jnp.sqrt(2.0) * s))
    # closed-form inversion of the longitudinal cdf (the reference runs
    # a Brent solver on it, microflake_fiber.h:cdf): cos = sqrt(2) s
    # erfinv((1 - 2 xi) erf(1/(sqrt2 s)))
    xi = u_sir[..., 0]
    cos_t = jnp.sqrt(2.0) * s * jax.scipy.special.erfinv(
        jnp.clip((1.0 - 2.0 * xi) * c1, -0.999999, 0.999999)
    )
    cos_t = jnp.clip(cos_t, -1.0, 1.0)
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    phi = 2.0 * jnp.pi * u_sir[..., 1]
    local = jnp.stack(
        [sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1)
    h = m.frame_to_world(s_f, t_f, o, local)        # (K, 3) candidates
    w = jnp.abs(jnp.sum(h * wi, axis=-1))           # (K,)
    w_sum = jnp.sum(w)
    cdf = jnp.cumsum(w)
    pick = jnp.clip(
        jnp.searchsorted(cdf, u_sir[0, 2] * w_sum),
        0, w.shape[-1] - 1,
    )
    h_sel = h[pick]
    wo = 2.0 * jnp.sum(wi * h_sel) * h_sel - wi
    ok = (olen > 1e-8) & (w_sum > 1e-12)
    weight = jnp.where(ok, 1.0, 0.0)
    wo = jnp.where(ok, wo, -wi)
    pdf = eval_microflake(pp, orientation, wi, wo)
    return wo, weight, pdf


def eval_kkay(pp: PhaseParams, orientation, wi, wo):
    """Kajiya-Kay (kkay.cpp:eval): kd/4pi isotropic term + ks cos^n
    lobe about the specular direction mirrored across the fiber."""
    olen = m.length(orientation)
    iso = pp.kd * m.INV_FOURPI
    o = orientation / jnp.maximum(olen, 1e-12)[..., None]
    s_f, t_f = m.build_frame(o)
    wo_l = m.frame_to_local(s_f, t_f, o, wo)
    z = -m.dot(wi, o)
    xy2 = wo_l[..., 0] ** 2 + wo_l[..., 1] ** 2
    a = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z)
                 / jnp.maximum(xy2, 1e-12))
    refl_l = jnp.stack(
        [wo_l[..., 0] * a, wo_l[..., 1] * a, z], axis=-1)
    r = m.frame_to_world(s_f, t_f, o, refl_l)
    spec = jnp.maximum(m.dot(r, wo), 0.0) ** pp.exponent * pp.norm * pp.ks
    return jnp.where(olen > 1e-8, spec + iso,
                     jnp.broadcast_to(iso, jnp.shape(olen)))


def sample_kkay(pp: PhaseParams, orientation, wi, u2):
    """Uniform-sphere sampling with weight eval * 4pi (kkay.cpp:sample)."""
    from alvrl_tpu.core import warp

    wo = warp.square_to_uniform_sphere(u2)
    val = eval_kkay(pp, orientation, wi, wo)
    pdf = jnp.full(jnp.shape(val), m.INV_FOURPI)
    return wo, val * (4.0 * jnp.pi), pdf


# ---------------------------------------------------------------------------
# Mixture phase function (src/phase/mixturephase.cpp): a convex
# combination of component phase functions. The reference mixes
# arbitrary phase plugins through virtual dispatch; the Array re-design
# restricts components to the unoriented analytic kinds (HG with
# per-component g — g=0 is isotropic — and Rayleigh) and evaluates all
# components branchlessly (a couple of extra VPU flops instead of a
# data-dependent dispatch). Oriented kinds (kkay/microflake) need the
# medium's orientation volume and are not mixable, matching practical
# reference scenes.
# ---------------------------------------------------------------------------

def mixture_params(weights, kinds, gs) -> PhaseParams:
    """Build mixture params. Weights must be non-negative; they are
    rescaled to sum to one ONLY when they exceed it (energy
    conservation, mixturephase.cpp:100-110) — a sum s < 1 is a valid,
    energy-ABSORBING mixture whose eval uses the raw weights (the
    reference evaluates with m_weights, not the selection pmf;
    mixturephase.cpp:119-126). The component-selection pmf is derived
    from the stored weights at sample/pdf time."""
    w = np.asarray(weights, np.float64).reshape(-1)
    if w.size == 0 or (w < 0).any() or w.sum() <= 0:
        raise ValueError("mixture weights must be non-negative and sum > 0")
    if w.sum() > 1.0:
        w = w / w.sum()
    k = np.asarray(kinds, np.int32).reshape(-1)
    g = np.asarray(gs, np.float64).reshape(-1)
    if not (w.size == k.size == g.size):
        raise ValueError("mixture component count mismatch")
    if not np.isin(k, [HG, RAYLEIGH]).all():
        raise ValueError("mixture components must be HG or Rayleigh kinds")
    return PhaseParams(
        mix_w=jnp.asarray(w, jnp.float32),
        mix_kind=jnp.asarray(k),
        mix_g=jnp.asarray(g, jnp.float32),
    )


def _mix_component_eval(pp: PhaseParams, wi, wo):
    """(..., K) per-component phase values at (wi, wo)."""
    c = m.dot(wi, wo)[..., None]                     # (..., 1)
    g = pp.mix_g                                     # (K,)
    temp = jnp.maximum(1.0 + g * g + 2.0 * g * c, 1e-12)
    hg = m.INV_FOURPI * (1.0 - g * g) / (temp * jnp.sqrt(temp))
    ray = (3.0 / (16.0 * jnp.pi)) * (1.0 + c * c)
    return jnp.where(pp.mix_kind == RAYLEIGH, ray, hg)


def eval_mixture(pp: PhaseParams, wi, wo):
    """sum_i w_i * eval_i (mixturephase.cpp:eval)."""
    return jnp.sum(pp.mix_w * _mix_component_eval(pp, wi, wo), axis=-1)


def pdf_mixture(pp: PhaseParams, wi, wo):
    """Selection-pmf-weighted pdf (mixturephase.cpp:128-134): every
    component importance-samples its own lobe exactly (pdf_i ==
    eval_i), so pdf = sum_i (w_i / s) eval_i = eval / s with
    s = sum(w). For s == 1 this reduces to eval == pdf."""
    s = jnp.sum(pp.mix_w)
    return eval_mixture(pp, wi, wo) / jnp.maximum(s, 1e-12)


def sample_mixture(pp: PhaseParams, wi, u2):
    """Pick a component ~ the selection pmf (reusing/rescaling
    u2[...,0], the standard one-uniform trick), sample its lobe, and
    weight by eval/pdf of the full mixture (mixturephase.cpp:137-157).
    Each component samples itself perfectly, so eval/pdf = s = sum(w):
    an energy-absorbing mixture (s < 1) returns weight s, not 1
    (ADVICE r03 item 2 — weights are stored raw, rescaled only when
    s > 1)."""
    u0, u1 = u2[..., 0], u2[..., 1]
    cdf = jnp.cumsum(pp.mix_w)
    j = jnp.clip(jnp.searchsorted(cdf, u0 * cdf[-1], side="right"),
                 0, pp.mix_w.shape[0] - 1)
    lo = jnp.where(j > 0, cdf[j - 1], 0.0)
    u0r = jnp.clip((u0 * cdf[-1] - lo) / jnp.maximum(cdf[j] - lo, 1e-12),
                   0.0, 1.0 - 1e-7)
    u2r = jnp.stack([u0r, u1], axis=-1)
    wo_hg, _, _ = sample_hg(pp.mix_g[j], wi, u2r)
    wo_ray, _, _ = sample_rayleigh(wi, u2r)
    wo = jnp.where((pp.mix_kind[j] == RAYLEIGH)[..., None], wo_ray, wo_hg)
    pdf = pdf_mixture(pp, wi, wo)
    s = jnp.sum(pp.mix_w)
    return wo, jnp.full_like(pdf, s), pdf


def _np_erf(x):
    """Vectorized erf without scipy (Abramowitz-Stegun 7.1.26, |e|<1.5e-7)."""
    x = np.asarray(x, np.float64)
    sign = np.sign(x)
    x = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    y = 1.0 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741)
                * t - 0.284496736) * t + 0.254829592) * t * np.exp(-x * x)
    return sign * y


def _microflake_norm(s):
    return 1.0 / ((2.0 * np.pi) ** 1.5 * s * _np_erf(1.0 / (np.sqrt(2) * s)))


def eval_phase(kind: int, g, wi, wo, orientation=None, pp=None,
               ):
    """Static phase dispatch (the PhaseFunction plugin switch).
    `orientation` is the local fiber direction for KKAY/MICROFLAKE."""
    if kind == RAYLEIGH:
        return eval_rayleigh(wi, wo)
    if kind == KKAY:
        return eval_kkay(pp, orientation, wi, wo)
    if kind == MICROFLAKE:
        return eval_microflake(pp, orientation, wi, wo)
    if kind == MIXTURE:
        return eval_mixture(pp, wi, wo)
    return eval_hg(g, wi, wo)


def pdf_phase(kind: int, g, wi, wo, orientation=None, pp=None):
    """Solid-angle pdf of sample_phase generating wo: equals eval for
    the perfectly importance-sampled kinds (HG/Rayleigh/microflake);
    kkay samples the uniform sphere."""
    if kind == KKAY:
        return jnp.full(jnp.shape(m.dot(wi, wo)), m.INV_FOURPI)
    return eval_phase(kind, g, wi, wo, orientation=orientation, pp=pp)


def sample_phase(kind: int, g, wi, u2, orientation=None, pp=None,
                 u_sir=None):
    """Sample wo; returns (wo, weight, pdf). `u_sir` ((K, 3) uniforms)
    drives the micro-flake candidate set."""
    if kind == RAYLEIGH:
        return sample_rayleigh(wi, u2)
    if kind == KKAY:
        return sample_kkay(pp, orientation, wi, u2)
    if kind == MICROFLAKE:
        return sample_microflake(pp, orientation, wi, u_sir)
    if kind == MIXTURE:
        return sample_mixture(pp, wi, u2)
    return sample_hg(g, wi, u2)
