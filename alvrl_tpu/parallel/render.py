"""Sharded render + differentiable train step over a device mesh.

The distribution model (replacing the reference's scheduler/TCP remoting,
SURVEY §2.5-2.6):
  * the scene is replicated once per device (counterpart of resource
    registration, sched.h:392 / vrlIntegrator.cpp:353-384);
  * eye rays are sharded over the 'rays' mesh axis (tile parallelism P1);
  * the VRL buffer is sharded over the 'vrls' axis; each device
    integrates its rays against its VRL shard and the partial radiance
    sums are psum'd over 'vrls' (P7; XLA hands the collective to NCCL on
    GPUs);
  * gradients w.r.t. medium/emitter parameters come out of jax.grad
    through the same shard_map — XLA inserts the parameter psum.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from alvrl_tpu.core import rng
from alvrl_tpu.integrators.vrl.integrate import VRLConfig
from alvrl_tpu.integrators.vrl.integrator import (
    clustered_li_rays,
    trace_eye_rays,
    vrl_sum,
)
from alvrl_tpu.integrators.vrl.vrl import VRLs
from alvrl_tpu.scene.scene import Scene
from alvrl_tpu.sensors import perspective


def li_sharded(mesh: Mesh, scene: Scene, vrls: VRLs, ray_o, ray_d, key,
               cfg: VRLConfig):
    """Per-ray radiance with rays sharded over 'rays' and the VRL set
    sharded over 'vrls'. ray count must divide the 'rays' axis size and
    vrls.capacity the 'vrls' axis size. Each device's pair sum takes the
    fused GPU kernel where ops.pair_kernel.use_kernel does."""

    def local(scene, v_start, v_end, v_power, v_valid, pcount, o, d, key):
        vshard = VRLs(
            start=v_start, end=v_end, power=v_power, valid=v_valid,
            particle_count=pcount,
        )
        k = rng.fold(
            key,
            jax.lax.axis_index("rays"),
            jax.lax.axis_index("vrls"),
        )
        hit = trace_eye_rays(scene, o, d)
        li_part = vrl_sum(scene, o, d, hit, vshard, k, cfg)
        li_part = jnp.where(hit.valid[..., None], li_part, 0.0)
        return jax.lax.psum(li_part, "vrls")

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(),            # scene replicated
            P("vrls"), P("vrls"), P("vrls"), P("vrls"),  # VRL shards
            P(),            # particle count
            P("rays"), P("rays"),  # rays
            P(),            # key
        ),
        out_specs=P("rays"),
        check_vma=False,
    )(
        scene,
        vrls.start, vrls.end, vrls.power, vrls.valid,
        vrls.particle_count,
        ray_o, ray_d, key,
    )


def _pad_to(n, m):
    return (-(-n // m)) * m


def pad_rays(ray_o, ray_d, mult):
    n = ray_o.shape[0]
    p = _pad_to(n, mult) - n
    if p:
        ray_o = jnp.pad(ray_o, ((0, p), (0, 0)))
        ray_d = jnp.pad(ray_d, ((0, p), (0, 0)), constant_values=1.0)
    return ray_o, ray_d, n


def pad_vrls(vrls: VRLs, mult):
    n = vrls.capacity
    p = _pad_to(n, mult) - n
    if p == 0:
        return vrls
    return VRLs(
        start=jnp.pad(vrls.start, ((0, p), (0, 0))),
        end=jnp.pad(vrls.end, ((0, p), (0, 0)), constant_values=1.0),
        power=jnp.pad(vrls.power, ((0, p), (0, 0))),
        valid=jnp.pad(vrls.valid, (0, p)),
        particle_count=vrls.particle_count,
    )


def render_image_sharded(mesh: Mesh, scene: Scene, vrls: VRLs, key,
                         cfg: VRLConfig):
    """Full-frame sharded render (center rays), through the fused pair
    kernel where ops.pair_kernel.use_kernel takes it (its custom VJP
    gives the gradients)."""
    cam = scene.camera
    w, h = cam.width, cam.height
    px, py = jnp.meshgrid(jnp.arange(w), jnp.arange(h))
    px, py = px.reshape(-1), py.reshape(-1)
    ray_o, ray_d = perspective.sample_ray(cam, px, py)
    n_rays_axis = mesh.shape["rays"]
    n_vrls_axis = mesh.shape["vrls"]
    ray_o, ray_d, n = pad_rays(ray_o, ray_d, n_rays_axis)
    vrls = pad_vrls(vrls, n_vrls_axis)
    li = li_sharded(mesh, scene, vrls, ray_o, ray_d, key, cfg)
    return li[:n].reshape(h, w, 3)


def train_step(
    mesh: Mesh,
    scene: Scene,
    key,
    target,
    cfg: VRLConfig,
    num_particles: int = 8,
    tracer_cfg=None,
):
    """One full differentiable step: trace VRLs, render, L2 image loss,
    gradients w.r.t. the medium coefficients (sigma_a, sigma_s, g) and
    emitter intensities — the parameters BASELINE.json requires gradients
    for. Differentiation goes *through the tracer* (throughput factors;
    sampled positions are detached — the detached-sampling estimator of
    SURVEY §7 'hard parts'). On a GPU the render stage takes the fused
    kernel where ops.pair_kernel.use_kernel does."""
    from alvrl_tpu.integrators.vrl import tracer as tracer_mod

    if tracer_cfg is None:
        tracer_cfg = tracer_mod.TracerConfig(max_depth=4)
    k_trace, k_render = jax.random.split(key)

    def loss_fn(params):
        med = scene.medium.replace(
            sigma_a=params["sigma_a"], sigma_s=params["sigma_s"], g=params["g"]
        )
        em = scene.emitters.replace(intensity=params["intensity"])
        sc = scene.replace(medium=med, emitters=em)
        vrls = tracer_mod.trace(sc, k_trace, num_particles, tracer_cfg)
        vrls = pad_vrls(vrls, mesh.shape["vrls"])
        img = render_image_sharded(mesh, sc, vrls, k_render, cfg)
        return jnp.mean((img - target) ** 2)

    params = {
        "sigma_a": scene.medium.sigma_a,
        "sigma_s": scene.medium.sigma_s,
        "g": scene.medium.g,
        "intensity": scene.emitters.intensity,
    }
    loss, grads = jax.value_and_grad(loss_fn)(params)
    return loss, grads


# ---------------------------------------------------------------------------
# Sharded clustering-path pieces (SURVEY §7 step 8: the transfer matrix
# R is the natural (pixels x VRLs) sharding showcase; the clustered
# render shards rays with the representative tables replicated).
# ---------------------------------------------------------------------------


def build_r_sharded(mesh: Mesh, scene: Scene, ray_o, ray_d, vrls: VRLs,
                    key, cfg: VRLConfig):
    """Transfer matrix R over representative rays, 2D-sharded:
    rays over the 'rays' axis x VRLs over the 'vrls' axis — every
    device computes its (ray-shard x vrl-shard) block independently
    with NO collective (the reference fans this out over Rbuilder
    threads, vrlIntegrator.cpp:1038-1083). Returns (mean (P, N),
    var (P, N)) sharded P('rays', 'vrls')."""
    from alvrl_tpu.integrators.vrl.integrate import (
        pair_contribution,
        pair_uniforms,
    )
    from alvrl_tpu.media import api as mapi

    def local(scene, v_start, v_end, v_power, v_valid, pcount, o, d, key):
        scene = mapi.prepare_scene(scene)
        hit = trace_eye_rays(scene, o, d)
        k = rng.fold(key, jax.lax.axis_index("rays"),
                     jax.lax.axis_index("vrls"))
        b = o.shape[0]
        c = v_start.shape[0]
        expand = lambda a: a[:, None] if a.ndim == 1 else a[:, None, :]
        u_vv, u_vs = pair_uniforms(rng.seed_bits(k), jnp.arange(b),
                                   jnp.arange(c), cfg)
        kw = {}
        if not mapi.is_homogeneous(scene.medium):
            from alvrl_tpu.media import heterogeneous as gmed

            kw = dict(
                eye_od=gmed.cumulative_od(scene.medium, o, hit.p)[:, None],
                vrl_od=gmed.cumulative_od(scene.medium, v_start,
                                          v_end)[None],
            )
        _, lum_mean, lum_var = pair_contribution(
            scene, expand(o), expand(d), expand(hit.p), expand(hit.valid),
            expand(hit.ng), expand(hit.mat),
            v_start[None], v_end[None], v_power[None], v_valid[None],
            u_vv, u_vs, cfg, **kw)
        norm = 1.0 / jnp.maximum(pcount, 1.0)
        return lum_mean * norm, lum_var * norm * norm

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(),
            P("vrls"), P("vrls"), P("vrls"), P("vrls"), P(),
            P("rays"), P("rays"), P(),
        ),
        out_specs=(P("rays", "vrls"), P("rays", "vrls")),
        check_vma=False,
    )(scene, vrls.start, vrls.end, vrls.power, vrls.valid,
      vrls.particle_count, ray_o, ray_d, key)


def render_clustered_sharded(mesh: Mesh, scene: Scene, vrls: VRLs,
                             slice_of_pixel, table_vrls, table_weights,
                             key, cfg: VRLConfig):
    """Clustered render with eye rays sharded over 'rays'; the VRL
    buffer and the per-slice representative tables are replicated
    (they are the small clustered resources the reference registers
    once per worker, vrlIntegrator.cpp:353-384). Returns (H, W, 3)."""
    from alvrl_tpu.media import api as mapi

    cam = scene.camera
    w, h = cam.width, cam.height
    px, py = jnp.meshgrid(jnp.arange(w), jnp.arange(h))
    px, py = px.reshape(-1), py.reshape(-1)
    ray_o, ray_d = perspective.sample_ray(cam, px, py)
    n_axis = mesh.shape["rays"] * mesh.shape["vrls"]
    ray_o, ray_d, n = pad_rays(ray_o, ray_d, n_axis)
    sop = jnp.pad(jnp.asarray(slice_of_pixel),
                  (0, ray_o.shape[0] - n))

    def local(scene, tv, tw, v_start, v_end, v_power, v_valid, pcount,
              o, d, sl, key):
        scene = mapi.prepare_scene(scene)
        vrls = VRLs(start=v_start, end=v_end, power=v_power, valid=v_valid,
                    particle_count=pcount)
        vrl_od_full = None
        if not mapi.is_homogeneous(scene.medium):
            from alvrl_tpu.media import heterogeneous as gmed

            vrl_od_full = gmed.cumulative_od(scene.medium, v_start, v_end)
        k = rng.fold(key, jax.lax.axis_index("rays"), rng.P_CLUSTER)
        return clustered_li_rays(scene, vrls, sl, tv, tw, k, o, d, cfg,
                                 vrl_od_full=vrl_od_full)

    li = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(), P(), P(),
            P(), P(), P(), P(), P(),
            P(("rays", "vrls")), P(("rays", "vrls")),
            P(("rays", "vrls")), P(),
        ),
        out_specs=P(("rays", "vrls")),
        check_vma=False,
    )(scene, jnp.asarray(table_vrls), jnp.asarray(table_weights),
      vrls.start, vrls.end, vrls.power, vrls.valid, vrls.particle_count,
      ray_o, ray_d, sop, key)
    return li[:n].reshape(h, w, 3)
