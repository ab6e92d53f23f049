"""Multi-host worker: one process of a distributed render.

Counterpart of running `mtssrv` on each node (mtssrv.cpp) — except
there is no message loop: every process runs the SAME program, joins
the jax.distributed runtime, and executes one shard_map render step
over the global mesh. Used by tests/test_multihost.py (2 CPU processes
x 2 virtual devices) and, one process per host, on GPU machines.

Usage (per process):
  python scripts/multihost_worker.py <coordinator> <nprocs> <pid> <out.npy>
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    coordinator, nprocs, pid, out_path = sys.argv[1:5]
    nprocs, pid = int(nprocs), int(pid)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    # join the runtime BEFORE importing alvrl_tpu: module-level jnp
    # constants in the library initialize the XLA backend, which
    # jax.distributed.initialize must precede
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=nprocs, process_id=pid)

    from alvrl_tpu.parallel import multihost

    assert jax.process_count() == nprocs

    import numpy as np

    from alvrl_tpu.integrators.vrl import tracer
    from alvrl_tpu.integrators.vrl.integrate import VRLConfig
    from alvrl_tpu.integrators.vrl.vrl import compact
    from alvrl_tpu.parallel import render as prender
    from alvrl_tpu.scene import presets

    scene = presets.cornell_smoke(width=8, height=8)
    # the trace is a pure function of (scene, key): every process
    # computes the same VRL set — the replicated-resource semantics of
    # the reference's resource registry (sched.h:392)
    key = jax.random.key(5)
    raw = tracer.trace(scene, key, 16, tracer.TracerConfig(max_depth=6))
    vrls = compact(raw, 64, slots_per_particle=6)

    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = multihost.global_mesh()
    cam = scene.camera
    w, h = cam.width, cam.height
    from alvrl_tpu.sensors import perspective

    px, py = jnp.meshgrid(jnp.arange(w), jnp.arange(h))
    ray_o, ray_d = perspective.sample_ray(
        cam, px.reshape(-1), py.reshape(-1))
    ray_o, ray_d, n = prender.pad_rays(ray_o, ray_d, mesh.shape["rays"])
    vrls = prender.pad_vrls(vrls, mesh.shape["vrls"])

    # host-replicated data -> global sharded arrays (each process
    # contributes its addressable shards; the replicated-resource
    # semantics of the reference's scheduler registry, sched.h:392)
    def gput(x, spec):
        return jax.device_put(np.asarray(x), NamedSharding(mesh, spec))

    import dataclasses
    vrls = type(vrls)(
        start=gput(vrls.start, P("vrls")),
        end=gput(vrls.end, P("vrls")),
        power=gput(vrls.power, P("vrls")),
        valid=gput(vrls.valid, P("vrls")),
        particle_count=gput(vrls.particle_count, P()),
    )
    ray_o = gput(ray_o, P("rays"))
    ray_d = gput(ray_d, P("rays"))
    scene_g = jax.tree_util.tree_map(lambda x: gput(x, P()), scene)

    li = prender.li_sharded(
        mesh, scene_g, vrls, ray_o, ray_d, jax.random.key(7),
        VRLConfig(vol_vol_samples=1, vol_surf_samples=1, vrl_chunk=32))
    img = np.asarray(multihost_utils.process_allgather(li, tiled=True))
    img = img[:n].reshape(h, w, 3)
    if pid == 0:
        np.save(out_path, img)
    print(f"proc {pid}: done, img mean {float(np.mean(img)):.6g}")


if __name__ == "__main__":
    main()
