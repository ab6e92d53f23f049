"""Heterogeneous participating medium over a density grid.

Counterpart of src/medium/heterogeneous.cpp + src/volume/gridvolume.cpp:
a scalar density field on a regular grid (trilinear interpolation,
gridvolume.cpp:337-364) with spectral extinction sigma_t = density *
scale * sigma_t_color, constant albedo and HG phase.

Sampling follows the reference's two strategies, adapted to batched arrays:
  * distance sampling: Woodcock delta tracking
    (heterogeneous.cpp:633-658) as a bounded `lax.while_loop`; the
    sampled distance is detached (discrete acceptance events);
  * transmittance evaluation: deterministic fixed-step midpoint
    quadrature of exp(-int sigma_t) (the Simpson strategy of
    integrateDensity, heterogeneous.cpp:301) — differentiable w.r.t.
    the voxel densities, static step count for XLA.

pdfSuccess/pdfFailure semantics mirror the reference: success pdf is
sigma_t(p) * Tr(0,t) in the *sampling channel* (scalar density), failure
pdf is Tr(0,dist) — no mediumSamplingWeight mixture (the reference's
heterogeneous medium does not use one).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from alvrl_tpu.core import struct

from alvrl_tpu.core import rng


@struct.dataclass
class GridMedium:
    density: jax.Array       # (Dz, Dy, Dx) f32 scalar density
    sigma_t_color: jax.Array  # (3,) spectral extinction per unit density
    albedo: jax.Array        # (3,) single-scatter albedo
    g: jax.Array             # HG mean cosine
    box_min: jax.Array       # (3,)
    box_max: jax.Array       # (3,)
    scale: jax.Array         # scalar density multiplier
    max_density: jax.Array   # scalar: max(density) * scale (Woodcock bound)
    phase_kind: int = struct.field(pytree_node=False, default=0)  # phase.HG
    # Quadrature lookups use nearest-neighbor reads of a 2x trilinearly
    # supersampled grid (1 gather/sample instead of 8 corner gathers);
    # the OD error vs full trilinear is <1% on smooth fields (tests).
    # Set False for exact trilinear quadrature.
    fast_tau: bool = struct.field(pytree_node=False, default=True)
    # oriented media (heterogeneous.cpp orientation volumes +
    # needsDirectionallyVaryingCoefficients): local fiber directions and
    # the phase parameter bundle for KKAY/MICROFLAKE kinds
    orientation: jax.Array = None   # (Dz, Dy, Dx, 3) or None
    phase_params: object = None     # phase.PhaseParams or None
    sigma_dir_max: jax.Array = None  # scalar majorant factor (default 1)
    # distance-sampling strategy (heterogeneous.cpp EWoodcockTracking
    # vs ESimpsonQuadrature): 0 = delta tracking, 1 = exact
    # transmittance inversion over a cumulative-OD table
    sampling: int = struct.field(pytree_node=False, default=0)
    # Materialized 2x-supersampled density (see with_cache). XLA does
    # NOT hoist the lazy _upsample2 out of fori_loop/lax.map bodies —
    # the recompute dominated the hetero render (measured 0.74 s per
    # quadrature step on config 4 vs ~1 ms for the gathers themselves).
    # Entry points call media.api.prepare() so the upsample runs once
    # per traced call; inside the trace, so voxel gradients still flow.
    density_ss_cache: jax.Array = None

    @property
    def density_ss(self):
        """2x supersampled density (exact trilinear at half-steps),
        shape (2Z-1, 2Y-1, 2X-1). Uses the materialized cache when the
        caller prepared one (media.api.prepare); otherwise computed
        from `density` with jnp ops so voxel gradients flow."""
        if self.density_ss_cache is not None:
            return self.density_ss_cache
        return _upsample2(self.density)

    @property
    def sigma_s_color(self):
        return self.sigma_t_color * self.albedo

    @property
    def sampling_weight(self):
        return jnp.float32(1.0)


def make_grid_medium(density, sigma_t_color, albedo, g=0.0,
                     box_min=(-1, -1, -1), box_max=(1, 1, 1), scale=1.0,
                     phase_kind=0, orientation=None, phase_params=None):
    from alvrl_tpu.media import phase as ph

    density = jnp.asarray(density, jnp.float32)
    sdm = jnp.float32(1.0)
    if orientation is not None:
        orientation = jnp.asarray(orientation, jnp.float32)
        if phase_kind == ph.MICROFLAKE:
            if phase_params is None:
                phase_params = ph.microflake_params()
            sdm = 2.0 * jnp.max(phase_params.sigma_t_lut)
        elif phase_params is None:
            phase_params = ph.kkay_params()
    return GridMedium(
        density=density,
        sigma_t_color=jnp.asarray(sigma_t_color, jnp.float32),
        albedo=jnp.asarray(albedo, jnp.float32),
        g=jnp.asarray(g, jnp.float32),
        box_min=jnp.asarray(box_min, jnp.float32),
        box_max=jnp.asarray(box_max, jnp.float32),
        scale=jnp.asarray(scale, jnp.float32),
        max_density=jnp.max(density) * scale,
        phase_kind=phase_kind,
        orientation=orientation,
        phase_params=phase_params,
        sigma_dir_max=sdm,
    )


def with_cache(med: GridMedium) -> GridMedium:
    """Return the medium with density_ss materialized.

    Call once at the top of a jitted render function — NOT per sample:
    XLA's loop-invariant code motion does not hoist the upsample out of
    fori_loop / lax.map bodies, so the lazy property recomputes the
    full (2Z-1,2Y-1,2X-1) grid at every quadrature step.

    ALWAYS recomputes from the current `density` (never trusts an
    existing cache): a prepared medium whose density was later replaced
    (optimization loops do `med.replace(density=new)`) would otherwise
    keep serving the stale supersample — silently wrong taus and exact
    zero d/d(density) gradients. Re-preparing a consistent medium is
    free inside a trace (XLA CSEs the duplicate upsample)."""
    if not med.fast_tau:
        return med
    return med.replace(density_ss_cache=_upsample2(med.density))


def _up1(a, axis):
    """Insert midpoints along one axis: n -> 2n-1 (exact trilinear)."""
    n = a.shape[axis]
    lo = jax.lax.slice_in_dim(a, 0, n - 1, axis=axis)
    hi = jax.lax.slice_in_dim(a, 1, n, axis=axis)
    mid = 0.5 * (lo + hi)
    inter = jnp.stack([lo, mid], axis=axis + 1)
    new_shape = list(a.shape)
    new_shape[axis] = 2 * (n - 1)
    inter = inter.reshape(new_shape)
    last = jax.lax.slice_in_dim(a, n - 1, n, axis=axis)
    return jnp.concatenate([inter, last], axis=axis)


def _upsample2(d):
    """(Z, Y, X) -> (2Z-1, 2Y-1, 2X-1) trilinear supersample."""
    return _up1(_up1(_up1(d, 0), 1), 2)


def lookup_density_nn(med: GridMedium, p):
    """Nearest lookup in the 2x supersampled grid — equals trilinear
    interpolation evaluated at the nearest half-cell point (max position
    error 1/4 voxel per axis). ONE gather per sample point vs 8 for
    trilinear: the quadrature fast path."""
    dz, dy, dx = med.density.shape
    ss = med.density_ss
    extent = med.box_max - med.box_min
    q = (p - med.box_min) / extent
    inside = jnp.all((q >= 0.0) & (q <= 1.0), axis=-1)
    ix = jnp.clip(jnp.round(q[..., 0] * (2 * (dx - 1))).astype(jnp.int32),
                  0, 2 * dx - 2)
    iy = jnp.clip(jnp.round(q[..., 1] * (2 * (dy - 1))).astype(jnp.int32),
                  0, 2 * dy - 2)
    iz = jnp.clip(jnp.round(q[..., 2] * (2 * (dz - 1))).astype(jnp.int32),
                  0, 2 * dz - 2)
    d = ss[iz, iy, ix]
    return jnp.where(inside, d * med.scale, 0.0)


def _lookup_quad(med: GridMedium, p):
    """Density lookup used by the deterministic tau quadratures."""
    if med.fast_tau:
        return lookup_density_nn(med, p)
    return lookup_density(med, p)


def lookup_density(med: GridMedium, p):
    """Trilinear density lookup; zero outside the box
    (GridDataSource::lookupFloat, gridvolume.cpp:337-364).
    Differentiable w.r.t. the voxel values."""
    dz, dy, dx = med.density.shape
    extent = med.box_max - med.box_min
    q = (p - med.box_min) / extent  # [0,1]^3
    gx = q[..., 0] * (dx - 1)
    gy = q[..., 1] * (dy - 1)
    gz = q[..., 2] * (dz - 1)
    inside = jnp.all((q >= 0.0) & (q <= 1.0), axis=-1)

    x0 = jnp.clip(jnp.floor(gx).astype(jnp.int32), 0, dx - 2)
    y0 = jnp.clip(jnp.floor(gy).astype(jnp.int32), 0, dy - 2)
    z0 = jnp.clip(jnp.floor(gz).astype(jnp.int32), 0, dz - 2)
    fx = jnp.clip(gx - x0, 0.0, 1.0)
    fy = jnp.clip(gy - y0, 0.0, 1.0)
    fz = jnp.clip(gz - z0, 0.0, 1.0)

    def at(zi, yi, xi):
        return med.density[zi, yi, xi]

    d000 = at(z0, y0, x0)
    d001 = at(z0, y0, x0 + 1)
    d010 = at(z0, y0 + 1, x0)
    d011 = at(z0, y0 + 1, x0 + 1)
    d100 = at(z0 + 1, y0, x0)
    d101 = at(z0 + 1, y0, x0 + 1)
    d110 = at(z0 + 1, y0 + 1, x0)
    d111 = at(z0 + 1, y0 + 1, x0 + 1)
    c00 = d000 * (1 - fx) + d001 * fx
    c01 = d010 * (1 - fx) + d011 * fx
    c10 = d100 * (1 - fx) + d101 * fx
    c11 = d110 * (1 - fx) + d111 * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    d = c0 * (1 - fz) + c1 * fz
    return jnp.where(inside, d * med.scale, 0.0)


def lookup_orientation(med: GridMedium, p):
    """Trilinear fiber-orientation lookup (the vector-volume case of
    GridDataSource::lookupVector, gridvolume.cpp); zero outside the box
    and where the volume stores a zero vector (undefined orientation)."""
    dz, dy, dx = med.density.shape
    extent = med.box_max - med.box_min
    q = (p - med.box_min) / extent
    gx = q[..., 0] * (dx - 1)
    gy = q[..., 1] * (dy - 1)
    gz = q[..., 2] * (dz - 1)
    inside = jnp.all((q >= 0.0) & (q <= 1.0), axis=-1)
    x0 = jnp.clip(jnp.floor(gx).astype(jnp.int32), 0, dx - 2)
    y0 = jnp.clip(jnp.floor(gy).astype(jnp.int32), 0, dy - 2)
    z0 = jnp.clip(jnp.floor(gz).astype(jnp.int32), 0, dz - 2)
    fx = jnp.clip(gx - x0, 0.0, 1.0)[..., None]
    fy = jnp.clip(gy - y0, 0.0, 1.0)[..., None]
    fz = jnp.clip(gz - z0, 0.0, 1.0)[..., None]
    o = med.orientation
    c00 = o[z0, y0, x0] * (1 - fx) + o[z0, y0, x0 + 1] * fx
    c01 = o[z0, y0 + 1, x0] * (1 - fx) + o[z0, y0 + 1, x0 + 1] * fx
    c10 = o[z0 + 1, y0, x0] * (1 - fx) + o[z0 + 1, y0, x0 + 1] * fx
    c11 = o[z0 + 1, y0 + 1, x0] * (1 - fx) + o[z0 + 1, y0 + 1, x0 + 1] * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    v = c0 * (1 - fz) + c1 * fz
    return jnp.where(inside[..., None], v, 0.0)


def _directional(med: GridMedium) -> bool:
    """Directionally varying extinction (microflake only; the reference's
    needsDirectionallyVaryingCoefficients, microflake.cpp)."""
    from alvrl_tpu.media import phase as ph

    return med.orientation is not None and med.phase_kind == ph.MICROFLAKE


def dir_factor(med: GridMedium, p, d):
    """sigmaDir(cos(d, orientation(p))): the factor scaling the scalar
    density into direction-dependent extinction (heterogeneous.cpp's
    lookupSigmaT with an orientation volume). 1 for unoriented media;
    0 where the orientation is undefined (zero vector)."""
    if not _directional(med):
        return jnp.ones(jnp.shape(p)[:-1])
    from alvrl_tpu.media import phase as ph

    o = lookup_orientation(med, p)
    olen = jnp.linalg.norm(o, axis=-1)
    cos_t = jnp.sum(d * o, axis=-1) / jnp.maximum(olen, 1e-12)
    f = ph.microflake_sigma_dir(med.phase_params, cos_t)
    return jnp.where(olen > 1e-8, f, 0.0)


# number of quadrature steps for deterministic transmittance.
# 16 midpoint steps give ~6e-4 mean relative optical-depth error on the
# benchmark plume (measured vs 128 steps) at half the gather cost of 32.
N_TAU_STEPS = 16


# Unroll threshold for the quadrature loops. fori_loop iterations with
# tiny bodies serialize and block fusion: each iteration pays loop
# overhead and forces its (batch,)-shaped carries through device
# memory. Unrolled, XLA fuses the whole accumulation chain. Above the threshold (step counts beyond any
# render-path use) fall back to fori to bound code size.
_UNROLL_MAX = 32


def optical_depth(med: GridMedium, p0, p1, n_steps=N_TAU_STEPS):
    """Midpoint-rule integral of density along [p0, p1] (scalar).

    Accumulates step by step (never materializing the full
    (batch x n_steps) sample-point tensor — inside the pairwise VRL
    kernel that allocates (rays x vrls x steps) and faults the device
    at benchmark sizes); unrolled for small static step counts (see
    _UNROLL_MAX)."""
    delta = p1 - p0
    dist = jnp.linalg.norm(delta, axis=-1)
    directional = _directional(med)
    if directional:
        d_unit = delta / jnp.maximum(dist, 1e-20)[..., None]

    def step(i_f, acc):
        t = (i_f + 0.5) / n_steps
        p = p0 + t * delta
        dens = _lookup_quad(med, p)
        if directional:
            dens = dens * dir_factor(med, p, d_unit)
        return acc + dens

    total = jnp.zeros(jnp.shape(dist), jnp.float32)
    if n_steps <= _UNROLL_MAX:
        for i in range(n_steps):
            total = step(jnp.float32(i), total)
    else:
        total = jax.lax.fori_loop(
            0, n_steps, lambda i, a: step(i.astype(jnp.float32), a), total
        )
    return total * dist / n_steps


def cumulative_od(med: GridMedium, p0, p1, n_steps=N_TAU_STEPS):
    """Cumulative optical depth along [p0, p1]: returns (..., n+1) with
    cum[..., k] = integral of density over the first k/n of the segment
    (midpoint rule per sub-interval). Lets callers that evaluate many
    taus along the SAME segment (per-eye-ray and per-VRL tables in the
    pairwise kernel) pay the quadrature gathers once and interpolate."""
    delta = p1 - p0
    dist = jnp.linalg.norm(delta, axis=-1)
    directional = _directional(med)
    if directional:
        d_unit = delta / jnp.maximum(dist, 1e-20)[..., None]

    def dens_at(i_f):
        p = p0 + ((i_f + 0.5) / n_steps) * delta
        d = _lookup_quad(med, p)
        if directional:
            d = d * dir_factor(med, p, d_unit)
        return d

    if n_steps <= _UNROLL_MAX:
        # unrolled: collect per-step densities and cumsum — avoids both
        # the fori overhead and the .at[].set scatter carry (measured
        # ~23 M lookups/s under fori vs ~89 M/s unrolled; see
        # _UNROLL_MAX note above)
        steps = jnp.stack(
            [dens_at(jnp.float32(i)) for i in range(n_steps)], axis=-1
        )
        cum = jnp.concatenate(
            [jnp.zeros(jnp.shape(dist) + (1,), jnp.float32),
             jnp.cumsum(steps, axis=-1)],
            axis=-1,
        )
    else:
        def body(i, acc):
            d = dens_at(i.astype(jnp.float32))
            return acc.at[..., i + 1].set(acc[..., i] + d)

        cum = jnp.zeros(jnp.shape(dist) + (n_steps + 1,), jnp.float32)
        cum = jax.lax.fori_loop(0, n_steps, body, cum)
    return cum * (dist / n_steps)[..., None]


def interp_od(cum, frac, n_steps=N_TAU_STEPS):
    """Linear interpolation of a cumulative_od table at fraction(s) of
    the segment. frac clipped to [0, 1]."""
    x = jnp.clip(frac, 0.0, 1.0) * n_steps
    k0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, n_steps - 1)
    w = x - k0
    c0 = jnp.take_along_axis(cum, k0[..., None], axis=-1)[..., 0]
    c1 = jnp.take_along_axis(cum, (k0 + 1)[..., None], axis=-1)[..., 0]
    return c0 * (1.0 - w) + c1 * w


def eval_transmittance(med: GridMedium, p0, p1, n_steps=N_TAU_STEPS):
    """Spectral tau = exp(-sigma_t_color * int density)."""
    od = optical_depth(med, p0, p1, n_steps=n_steps)
    return jnp.exp(-med.sigma_t_color * od[..., None])


def eval_ray(med: GridMedium, p0, p1):
    """(tau, pdf_success, pdf_failure) over the segment — the
    counterpart of HeterogeneousMedium::eval for the short-VRL
    pdfFailure division. Sampling channel = mean sigma_t_color."""
    od = optical_depth(med, p0, p1)
    tau = jnp.exp(-med.sigma_t_color * od[..., None])
    chan = jnp.mean(med.sigma_t_color)
    tr = jnp.exp(-chan * od)
    d_seg = (p1 - p0) / jnp.maximum(
        jnp.linalg.norm(p1 - p0, axis=-1), 1e-20)[..., None]
    dens_end = lookup_density(med, p1) * dir_factor(med, p1, d_seg)
    pdf_success = chan * dens_end * tr
    pdf_failure = tr
    return tau, pdf_success, pdf_failure


class GridMediumSample(NamedTuple):
    success: jax.Array
    t: jax.Array
    p: jax.Array
    transmittance: jax.Array  # (..., 3) ratio-tracking weight factor
    pdf_success: jax.Array
    pdf_failure: jax.Array
    sigma_s: jax.Array        # (..., 3) at the sampled point
    weight: jax.Array         # (..., 3) throughput factor = tau*sigma_s/pdf


MAX_TRACKING_STEPS = 256


def sample_distance(med: GridMedium, key, ray_o, ray_d, dist_surf):
    """Free-flight sampling; strategy dispatch per med.sampling
    (heterogeneous.cpp EWoodcockTracking default vs ESimpsonQuadrature).
    Woodcock: delta tracking in the mean-sigma_t channel
    (heterogeneous.cpp:633-658). Scalar (single-lane) version — vmap
    over batches. Returns a GridMediumSample; `weight` already includes
    the spectral correction tau_spectral * sigma_s / pdf at the sampled
    point (so callers multiply throughput by `weight` directly)."""
    if med.sampling == 1:
        return sample_distance_quadrature(med, key, ray_o, ray_d,
                                          dist_surf)
    chan = jnp.mean(med.sigma_t_color)
    dir_max = (jnp.float32(1.0) if med.sigma_dir_max is None
               else med.sigma_dir_max)
    sig_max = jnp.maximum(med.max_density * chan * dir_max, 1e-12)
    inv_max = 1.0 / sig_max

    def cond(carry):
        t, k, done, _ = carry
        return ~done

    def body(carry):
        t, k, done, steps = carry
        k1, k2, k_next = jax.random.split(k, 3)
        t_new = t - jnp.log1p(-rng.uniform(k1)) * inv_max
        beyond = t_new >= dist_surf
        p = ray_o + t_new * ray_d
        dens = lookup_density(med, p) * dir_factor(med, p, ray_d)
        sigma_t_chan = dens * chan
        accept = rng.uniform(k2) * sig_max <= sigma_t_chan
        done_new = beyond | accept | (steps >= MAX_TRACKING_STEPS)
        return (t_new, k_next, done_new, steps + 1)

    t0 = jnp.float32(0.0)
    t_fin, _, _, _ = jax.lax.while_loop(
        cond, body, (t0, key, jnp.bool_(False), jnp.int32(0))
    )
    t_fin = jax.lax.stop_gradient(t_fin)
    success = t_fin < dist_surf
    t_eff = jnp.minimum(t_fin, dist_surf)
    p = ray_o + t_eff * ray_d

    # deterministic pdfs/transmittance over [0, t_eff] for the weight
    p_end = ray_o + t_eff * ray_d
    tau = eval_transmittance(med, ray_o, p_end)
    od = optical_depth(med, ray_o, p_end)
    tr_chan = jnp.exp(-chan * od)
    dens_end = lookup_density(med, p_end) * dir_factor(med, p_end, ray_d)
    pdf_success = jnp.maximum(chan * dens_end * tr_chan, 1e-30)
    pdf_failure = jnp.maximum(tr_chan, 1e-30)
    sigma_s = dens_end * med.sigma_s_color
    # detached-sampling gradients: pdf denominators detached, tau and
    # sigma_s numerators differentiable (see media.api note)
    weight = jnp.where(
        success,
        (tau * sigma_s) / jax.lax.stop_gradient(pdf_success),
        tau / jax.lax.stop_gradient(pdf_failure),
    )
    return GridMediumSample(
        success=success,
        t=t_eff,
        p=p,
        transmittance=tau,
        pdf_success=pdf_success,
        pdf_failure=pdf_failure,
        sigma_s=sigma_s,
        weight=weight,
    )


def _ray_box_exit(med: GridMedium, ray_o, ray_d):
    """Distance to the medium AABB exit along the ray (slab test);
    0 if the ray never enters."""
    inv = 1.0 / jnp.where(jnp.abs(ray_d) < 1e-12,
                          jnp.where(ray_d >= 0, 1e-12, -1e-12), ray_d)
    t0 = (med.box_min - ray_o) * inv
    t1 = (med.box_max - ray_o) * inv
    t_near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    t_far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return jnp.where(t_far > jnp.maximum(t_near, 0.0),
                     jnp.maximum(t_far, 0.0), 0.0)


def sample_distance_quadrature(med: GridMedium, key, ray_o, ray_d,
                               dist_surf, n_steps: int = N_TAU_STEPS * 4):
    """Exact transmittance-inverse free flight: sample a target optical
    depth -log(1-u) in the mean channel and invert the cumulative
    density integral along the segment.

    Counterpart of the ESimpsonQuadrature path (integrateDensity
    heterogeneous.cpp:301 + the Newton-bisection invertDensityIntegral
    :420): here the monotone cumulative-OD table replaces the
    iterative root polish — a searchsorted + linear interpolation,
    fixed shape, one quadrature sweep."""
    chan = jnp.mean(med.sigma_t_color)
    # march only to the closer of the surface and the box exit
    t_exit = _ray_box_exit(med, ray_o, ray_d)
    seg_len = jnp.minimum(dist_surf, jnp.maximum(t_exit, 1e-6))
    p_seg_end = ray_o + seg_len[..., None] * ray_d

    cum = cumulative_od(med, ray_o, p_seg_end, n_steps=n_steps)  # (n+1,)
    od_total = cum[..., -1]
    target = -jnp.log1p(-rng.uniform(key)) / jnp.maximum(chan, 1e-30)
    success = target < od_total
    frac_idx = jnp.searchsorted(cum, target)  # first cum > target
    k0 = jnp.clip(frac_idx - 1, 0, n_steps - 1)
    c0 = cum[..., k0]
    c1 = cum[..., k0 + 1]
    w = jnp.where(c1 > c0, (target - c0) / jnp.maximum(c1 - c0, 1e-30),
                  0.0)
    frac = (k0 + jnp.clip(w, 0.0, 1.0)) / n_steps
    t_med = frac * seg_len
    t_eff = jnp.where(success, t_med, jnp.minimum(dist_surf, 3e30))
    p = ray_o + t_eff[..., None] * ray_d

    # beyond the segment the remaining density is zero, so the optical
    # depth at the failure endpoint equals the segment total
    od_at = jnp.where(success, target, od_total)
    tau = jnp.exp(-med.sigma_t_color * od_at[..., None])
    tr_chan = jnp.exp(-chan * od_at)
    dens_end = lookup_density(med, p) * dir_factor(med, p, ray_d)
    # the ACTUAL sampling density of the table inversion is the step-
    # average density (piecewise-constant per table step), not the
    # pointwise trilinear value — using the latter biases the weight
    dens_step = (c1 - c0) * n_steps / jnp.maximum(seg_len, 1e-30)
    pdf_success = jnp.maximum(chan * dens_step * tr_chan, 1e-30)
    pdf_failure = jnp.maximum(tr_chan, 1e-30)
    sigma_s = dens_end * med.sigma_s_color
    weight = jnp.where(
        success[..., None],
        (tau * sigma_s) / jax.lax.stop_gradient(pdf_success)[..., None],
        tau / jax.lax.stop_gradient(pdf_failure)[..., None],
    )
    t_ret = jnp.where(success, jax.lax.stop_gradient(t_eff), dist_surf)
    return GridMediumSample(
        success=success,
        t=t_ret,
        p=jax.lax.stop_gradient(p),
        transmittance=tau,
        pdf_success=pdf_success,
        pdf_failure=pdf_failure,
        sigma_s=sigma_s,
        weight=weight,
    )
