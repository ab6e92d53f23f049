"""VRL integrator: per-pixel radiance as a sum of VRL x eye-ray integrals.

Counterpart of the `vrl` plugin (src/integrators/vrl/vrlIntegrator.cpp):
  * unclustered path = getVRLContributions (vrlIntegrator.cpp:792-825):
    every eye ray integrates against every VRL, normalized by the
    traced-particle count;
  * clustered path = getClusteredVrlContributions (:542-599): each pixel
    looks up its slice's representative VRLs + weights (see
    alvrl_tpu.integrators.vrl.cluster).

Device mapping: eye rays are processed in tiles (sharded over the device
mesh by alvrl_tpu.parallel), VRLs in chunks via lax.scan: a (ray-tile x
vrl-chunk) blocked dense product, which is exactly the transfer-matrix
shape the clustering stage needs. On a GPU, scenes the fused pair kernel
supports (ops.pair_kernel.use_kernel) render each frame band in one
kernel launch instead; the render entries below make that choice.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from alvrl_tpu.core import rng
from alvrl_tpu.geometry import intersect
from alvrl_tpu.integrators.vrl.integrate import (
    VRLConfig,
    pair_contribution,
    pair_sum,
    pair_uniforms,
)
from alvrl_tpu.integrators.vrl.tracer import TracerConfig, trace
from alvrl_tpu.integrators.vrl.vrl import VRLs
from alvrl_tpu.scene.scene import Scene
from alvrl_tpu.sensors import perspective


def vrl_sum(scene: Scene, ray_o, ray_d, hit, vrls: VRLs, key, cfg: VRLConfig,
            weight=None):
    """Sum_i integrateVRL(ray, vrl_i) / particleCount for a ray batch.

    ray_o/ray_d: (B, 3); hit: HitInfo for those rays; weight: optional
    (B, 3) path weight (specular chains). Runs the fused GPU kernel where
    ops.pair_kernel.use_kernel takes it, the XLA pair sum otherwise; both
    draw the same hash uniforms. Returns (B, 3) radiance."""
    from alvrl_tpu.ops import pair_kernel

    seed = rng.seed_bits(key)
    args = (scene, ray_o, ray_d, hit.p, hit.valid, hit.ng, hit.mat)
    if pair_kernel.use_kernel(scene, cfg):
        acc = pair_kernel.pair_sum(cfg, *args, vrls.start, vrls.end,
                                   vrls.power, vrls.valid, seed)
    else:
        acc = pair_sum(*args, vrls.start[None], vrls.end[None],
                       vrls.power[None], vrls.valid[None], seed, cfg)
    if weight is not None:
        acc = acc * weight
    return acc / jnp.maximum(vrls.particle_count, 1.0)


class HitInfo:
    """Lightweight view bundling a Hit with material ids."""

    def __init__(self, hit, mat):
        self.p = hit.p
        self.valid = hit.valid
        self.ng = hit.ng
        self.ng_raw = hit.ng_raw
        self.t = hit.t
        self.prim = hit.prim
        self.mat = mat


def trace_eye_rays(scene: Scene, ray_o, ray_d) -> HitInfo:
    """Closest-hit + per-hit material id, packaged for the integrand."""
    hit = intersect.intersect_all(ray_o, ray_d, scene.vertices, scene.faces)
    # sanitize misses so masked arithmetic stays finite
    hit = hit._replace(p=jnp.where(hit.valid[..., None], hit.p, ray_o))
    mat = scene.material[jnp.maximum(hit.prim, 0)]
    return HitInfo(hit=hit, mat=mat)


def li_unclustered(scene: Scene, ray_o, ray_d, vrls: VRLs, key, cfg: VRLConfig):
    """Li for a batch of eye rays, unclustered (all VRLs).

    Eye rays escaping to infinity contribute 0, matching the reference's
    dropped-infinite-ray quirk (vrlIntegrator.cpp:418-423)."""
    hit = trace_eye_rays(scene, ray_o, ray_d)
    li = vrl_sum(scene, ray_o, ray_d, hit, vrls, key, cfg)
    return jnp.where(hit.valid[..., None], li, 0.0)


def li_unclustered_spec(
    scene: Scene, ray_o, ray_d, vrls: VRLs, key, cfg: VRLConfig,
    spec_cfg=None,
):
    """Unclustered Li including specular chains (LiInternal recursion,
    vrlIntegrator.cpp:445-511, as a bounded loop)."""
    from alvrl_tpu.integrators.vrl.specular import (
        SpecularConfig,
        li_specular_chain,
    )

    if spec_cfg is None:
        spec_cfg = SpecularConfig()

    def li_at_hit(o, d, hit, k, weight):
        return vrl_sum(scene, o, d, hit, vrls, k, cfg, weight=weight)

    return li_specular_chain(
        scene, ray_o, ray_d, li_at_hit, trace_eye_rays, key, spec_cfg
    )


# ---------------------------------------------------------------------------
# Clustered path (Adaptive LightSlice)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg",))
def build_R(scene: Scene, ray_o, ray_d, vrls: VRLs, key, cfg: VRLConfig):
    """Transfer matrix R over representative rays: per (ray, vrl)
    luminance mean and variance-of-mean of the unclustered estimator
    (getLiLuminanceVrlContributions, vrlIntegrator.cpp:527-539).
    Returns (mean (P, N), var (P, N)) — the clustering's input."""
    from alvrl_tpu.media import api as mapi_
    from alvrl_tpu.media import heterogeneous as gmed_

    scene = mapi_.prepare_scene(scene)
    b = ray_o.shape[0]
    hit = trace_eye_rays(scene, ray_o, ray_d)
    c = cfg.vrl_chunk
    n = vrls.capacity
    n_chunks = -(-n // c)
    pad = n_chunks * c - n

    def padded(a):
        if pad == 0:
            return a
        return jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))

    v_start = padded(vrls.start).reshape(n_chunks, c, 3)
    v_end = padded(vrls.end).reshape(n_chunks, c, 3)
    v_power = padded(vrls.power).reshape(n_chunks, c, 3)
    v_valid = padded(vrls.valid).reshape(n_chunks, c)

    expand = lambda a: a[:, None] if a.ndim == 1 else a[:, None, :]
    norm = 1.0 / jnp.maximum(vrls.particle_count, 1.0)
    seed = rng.seed_bits(key)
    ray_idx = jnp.arange(b)

    # grid media: the same cumulative-OD tables the render path uses
    use_tables = not mapi_.is_homogeneous(scene.medium)
    if use_tables:
        nq = gmed_.N_TAU_STEPS
        eye_od = gmed_.cumulative_od(scene.medium, ray_o, hit.p)
        v_od = padded(
            gmed_.cumulative_od(scene.medium, vrls.start, vrls.end)
        ).reshape(n_chunks, c, nq + 1)
    else:
        eye_od = None
        v_od = jnp.zeros((n_chunks, 1, 1))

    def body(_, inp):
        ci, vs, ve, vp, vv, vod = inp
        u_vv, u_vs = pair_uniforms(seed, ray_idx, ci * c + jnp.arange(c),
                                   cfg)
        _, lum_mean, lum_var = pair_contribution(
            scene,
            expand(ray_o), expand(ray_d),
            expand(hit.p), expand(hit.valid), expand(hit.ng), expand(hit.mat),
            vs[None], ve[None], vp[None], vv[None],
            u_vv, u_vs, cfg,
            eye_od=None if not use_tables else eye_od[:, None, :],
            vrl_od=None if not use_tables else vod[None],
        )
        # normalization as accumulated into vrlContributions
        # (getVRLContributions, :810-813): mean * norm, var * norm^2
        return None, (lum_mean * norm, lum_var * norm * norm)

    _, (means, variances) = jax.lax.scan(
        body, None,
        (jnp.arange(n_chunks), v_start, v_end, v_power, v_valid, v_od),
    )
    # (n_chunks, B, c) -> (B, N)
    means = jnp.moveaxis(means, 0, 1).reshape(b, n_chunks * c)[:, :n]
    variances = jnp.moveaxis(variances, 0, 1).reshape(b, n_chunks * c)[:, :n]
    return means, variances


def clustered_li_rays(
    scene: Scene, vrls: VRLs, slice_of_ray, table_vrls, table_weights, key,
    ray_o, ray_d, cfg: VRLConfig, vrl_od_full=None,
):
    """Clustered li for a ray batch: ray r sums over the representative
    VRLs of its table row slice_of_ray[r], weighted (the weights fold
    into the VRL power; the estimator is linear in it). Runs the fused
    GPU kernel where ops.pair_kernel.use_kernel takes it; vrl_od_full
    (N, nq+1) are grid media's VRL cumulative-OD tables, built once per
    frame by the caller."""
    from alvrl_tpu.ops import pair_kernel

    hit = trace_eye_rays(scene, ray_o, ray_d)
    tv = table_vrls
    tab = (vrls.start[tv], vrls.end[tv],
           vrls.power[tv] * table_weights[..., None],
           vrls.valid[tv] & (table_weights > 0))
    seed = rng.seed_bits(key)
    args = (scene, ray_o, ray_d, hit.p, hit.valid, hit.ng, hit.mat)
    if pair_kernel.use_kernel(scene, cfg):
        total = pair_kernel.pair_sum_clustered(cfg, *args, slice_of_ray,
                                               *tab, seed)
    else:
        sl = slice_of_ray
        total = pair_sum(
            *args, *(a[sl] for a in tab), seed, cfg,
            vrl_od=None if vrl_od_full is None else vrl_od_full[tv[sl]])
    li = total / jnp.maximum(vrls.particle_count, 1.0)
    return jnp.where(hit.valid[..., None], li, 0.0)


@partial(jax.jit, static_argnames=("cfg", "ray_tile", "band_h"))
def _render_clustered_rows(
    scene: Scene, vrls: VRLs, slice_rows, table_vrls, table_weights,
    key, y_off, band_h: int, cfg: VRLConfig, ray_tile: int,
):
    """Clustered li for scanline rows [y_off, y_off+band_h);
    slice_rows: (band_h * W,) table rows for those pixels."""
    from alvrl_tpu.media import api as mapi_

    scene = mapi_.prepare_scene(scene)
    cam = scene.camera
    w = cam.width
    px, py = jnp.meshgrid(jnp.arange(w), jnp.arange(band_h))
    px = px.reshape(-1)
    py = py.reshape(-1) + y_off
    return _clustered_li(
        scene, vrls, slice_rows, table_vrls, table_weights,
        rng.fold(key, y_off), px, py, cfg, ray_tile,
    ).reshape(band_h, w, 3)


def render_clustered(
    scene: Scene,
    vrls: VRLs,
    slice_of_pixel,   # (H*W,) int32 row into the tables (fallback row appended)
    table_vrls,       # (S+1, Cmax) int32
    table_weights,    # (S+1, Cmax) f32; 0 padding
    key,
    cfg: VRLConfig = VRLConfig(),
    ray_tile: int = 2048,
    host_bands: int = 1,
):
    """Clustered render: pixel -> slice -> representative VRLs+weights
    (getClusteredVrlContributions, vrlIntegrator.cpp:542-599).
    `host_bands` splits the frame into separate device calls (see
    render_with_vrls)."""
    w, h = scene.camera.width, scene.camera.height
    assert h % host_bands == 0
    band_h = h // host_bands
    sop = slice_of_pixel.reshape(h, w)
    rows = [
        _render_clustered_rows(
            scene, vrls, sop[b * band_h:(b + 1) * band_h].reshape(-1),
            table_vrls, table_weights, key, jnp.int32(b * band_h),
            band_h, cfg, ray_tile,
        )
        for b in range(host_bands)
    ]
    img = jnp.concatenate(rows, axis=0)
    return img


def _clustered_li(
    scene: Scene, vrls: VRLs, slice_of_pixel, table_vrls, table_weights,
    key, px, py, cfg: VRLConfig, ray_tile: int,
):
    """Clustered li for pixels (px, py): the kernel takes all of them in
    one launch, as tile 0 (so with ray_tile >= the pixel count both paths
    draw the same uniforms); the XLA path maps over tiles of `ray_tile`
    rays."""
    from alvrl_tpu.ops import pair_kernel

    ray_o, ray_d = perspective.sample_ray(scene.camera, px, py)
    n = px.shape[0]
    if pair_kernel.use_kernel(scene, cfg):
        return clustered_li_rays(
            scene, vrls, slice_of_pixel, table_vrls, table_weights,
            rng.fold(key, 0, rng.P_CLUSTER), ray_o, ray_d, cfg)

    n_tiles = -(-n // ray_tile)
    pad = n_tiles * ray_tile - n
    if pad:
        ray_o = jnp.pad(ray_o, ((0, pad), (0, 0)))
        ray_d = jnp.pad(ray_d, ((0, pad), (0, 0)), constant_values=1.0)
        slice_of_pixel = jnp.pad(slice_of_pixel, (0, pad))

    from alvrl_tpu.media import api as mapi_
    from alvrl_tpu.media import heterogeneous as gmed_

    vrl_od_full = None
    if not mapi_.is_homogeneous(scene.medium):
        # (N, n+1), built once per frame
        vrl_od_full = gmed_.cumulative_od(scene.medium, vrls.start, vrls.end)

    def tile_fn(args):
        i, o_t, d_t, sl_t = args
        return clustered_li_rays(
            scene, vrls, sl_t, table_vrls, table_weights,
            rng.fold(key, i, rng.P_CLUSTER), o_t, d_t, cfg,
            vrl_od_full=vrl_od_full)

    li = jax.lax.map(
        tile_fn,
        (
            jnp.arange(n_tiles),
            ray_o.reshape(n_tiles, ray_tile, 3),
            ray_d.reshape(n_tiles, ray_tile, 3),
            slice_of_pixel.reshape(n_tiles, ray_tile),
        ),
    )
    return li.reshape(-1, 3)[:n]


_clustered_li_jit = partial(
    jax.jit, static_argnames=("cfg", "ray_tile")
)(_clustered_li)


@partial(jax.jit, static_argnames=("cfg", "tracer_cfg", "num_particles", "ray_tile"))
def render_unclustered(
    scene: Scene,
    key,
    num_particles: int = 64,
    cfg: VRLConfig = VRLConfig(),
    tracer_cfg: TracerConfig = TracerConfig(),
    ray_tile: int = 2048,
):
    """One progressive pass: trace VRLs, integrate every pixel against
    them, return (image (H, W, 3), vrls). Pixel centers, one eye ray per
    pixel (the reference renders 1 spp per pass and accumulates passes,
    integrator.cpp:380-440)."""
    k_trace, k_render = jax.random.split(key)
    vrls = trace(scene, k_trace, num_particles, tracer_cfg)
    img = render_with_vrls(scene, vrls, k_render, cfg, ray_tile)
    return img, vrls


@partial(jax.jit, static_argnames=("cfg", "ray_tile", "band_h", "antialias"))
def _render_rows(scene: Scene, vrls: VRLs, key, y_off, band_h: int,
                 cfg: VRLConfig, ray_tile: int, antialias: bool = False):
    """Unclustered li for scanline rows [y_off, y_off + band_h). The
    kernel takes the whole band in one launch (one tile); the XLA path
    maps over tiles of `ray_tile` rays."""
    from alvrl_tpu.media import api as mapi_
    from alvrl_tpu.ops import pair_kernel

    scene = mapi_.prepare_scene(scene)
    cam = scene.camera
    w = cam.width
    px, py = jnp.meshgrid(jnp.arange(w), jnp.arange(band_h))
    px = px.reshape(-1)
    py = py.reshape(-1) + y_off
    jitter = None
    if antialias:
        # sub-pixel jitter per pass (the reference draws a fresh film
        # sample each progressive pass, integrator.cpp renderBlock)
        jitter = rng.uniform(
            rng.fold(key, rng.P_PIXEL, 1), (px.shape[0], 2)
        )
    ray_o, ray_d = perspective.sample_ray(cam, px, py, jitter=jitter)

    n = px.shape[0]
    if pair_kernel.use_kernel(scene, cfg):
        ray_tile = n
    n_tiles = -(-n // ray_tile)
    pad = n_tiles * ray_tile - n
    if pad:
        ray_o = jnp.pad(ray_o, ((0, pad), (0, 0)))
        ray_d = jnp.pad(ray_d, ((0, pad), (0, 0)), constant_values=1.0)

    def tile_fn(args):
        i, o_t, d_t = args
        k = rng.fold(key, i, rng.P_PIXEL)
        return li_unclustered(scene, o_t, d_t, vrls, rng.fold(k, y_off), cfg)

    li = jax.lax.map(
        tile_fn,
        (
            jnp.arange(n_tiles),
            ray_o.reshape(n_tiles, ray_tile, 3),
            ray_d.reshape(n_tiles, ray_tile, 3),
        ),
    )
    return li.reshape(-1, 3)[:n].reshape(band_h, w, 3)


def render_with_vrls(
    scene: Scene, vrls: VRLs, key, cfg: VRLConfig = VRLConfig(),
    ray_tile: int = 2048, host_bands: int = 1, antialias: bool = False,
):
    """Full-frame unclustered render: the fused pair kernel on a GPU
    for the scenes it supports (ops.pair_kernel.use_kernel), the XLA path
    otherwise. `host_bands` > 1
    splits the frame into scanline bands issued as separate device calls,
    which bounds the time and memory of one call (one compile: the row
    offset is a dynamic scalar)."""
    h = scene.camera.height
    assert h % host_bands == 0, (h, host_bands)
    band_h = h // host_bands
    rows = [
        _render_rows(scene, vrls, key, jnp.int32(b * band_h), band_h,
                     cfg, ray_tile, antialias)
        for b in range(host_bands)
    ]
    return jnp.concatenate(rows, axis=0)
