"""Multi-process weak-scaling measurement on the CPU (gloo collectives):
a rehearsal of the BASELINE >=85% multi-device scaling claim, whose
measurement belongs on the GPUs.

Spawns N separate OS processes (1 virtual CPU device each, gloo
collectives) rendering a frame whose row count scales with N — fixed
per-process ray load. Reports rays/s and efficiency vs N=1.

CAVEAT printed with the result: with fewer cores than N worker
processes the efficiency number measures CPU contention, not
interconnect scaling.

Usage:  python scripts/weak_scaling.py            # driver
        python scripts/weak_scaling.py worker ... # internal
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BASE_H = 32     # rows per process
W = 64
PASSES = 3


def worker(coordinator, nprocs, pid, out_path):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 1)
    if nprocs > 1:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=nprocs, process_id=pid)

    import time

    import jax.numpy as jnp
    from jax.sharding import Mesh

    from alvrl_tpu.integrators.vrl import tracer
    from alvrl_tpu.integrators.vrl.integrate import VRLConfig
    from alvrl_tpu.integrators.vrl.vrl import compact
    from alvrl_tpu.parallel import render as prender
    from alvrl_tpu.scene import presets

    import numpy as np

    h = BASE_H * nprocs
    scene = presets.cornell_smoke(width=W, height=h)
    key = jax.random.key(5)
    raw = tracer.trace(scene, key, 16, tracer.TracerConfig(max_depth=6))
    vrls = compact(raw, 64, slots_per_particle=6)

    devices = np.asarray(jax.devices()).reshape(-1, 1)
    mesh = Mesh(devices, ("rays", "vrls"))
    cfg = VRLConfig(vrl_chunk=64)

    def one_pass(k):
        return prender.render_image_sharded(mesh, scene, vrls, k, cfg)

    img = jax.block_until_ready(one_pass(jax.random.key(0)))  # compile
    t0 = time.time()
    for p in range(PASSES):
        img = one_pass(jax.random.key(p + 1))
    jax.block_until_ready(img)
    dt = (time.time() - t0) / PASSES
    if pid == 0:
        rays = W * h
        with open(out_path, "w") as f:
            json.dump({"n": nprocs, "rays": rays, "secs": dt,
                       "rays_per_s": rays / dt}, f)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    results = {}
    for n in (1, 2, 4):
        coord = f"127.0.0.1:{_free_port()}"
        out = f"/tmp/weak_scaling_{n}.json"
        procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "worker",
                 coord, str(n), str(pid), out],
                env=env, cwd=repo,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            )
            for pid in range(n)
        ]
        for p in procs:
            rc = p.wait(timeout=1200)
            assert rc == 0, rc
        with open(out) as f:
            results[n] = json.load(f)
        print(n, results[n])
    r1 = results[1]["rays_per_s"]
    for n in (2, 4):
        eff = results[n]["rays_per_s"] / r1  # weak scaling: same per-proc load
        note = ("" if n <= (os.cpu_count() or 1) else
                "  (fewer cores than processes: this measures host "
                "oversubscription, not interconnect)")
        print(f"N={n}: weak-scaling efficiency {eff:.2%}{note}")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    else:
        main()
