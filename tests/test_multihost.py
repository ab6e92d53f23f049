"""True multi-process distributed rendering (P3, SURVEY §2.5/2.6).

Spawns TWO separate processes (2 virtual CPU devices each = a 4-device
global mesh across process boundaries, gloo collectives) running
scripts/multihost_worker.py — the moral equivalent of `mitsuba -c
host1;host2` against two mtssrv nodes — and checks the distributed
image against a single-process render of the same configuration."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_render(tmp_path):
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    out = tmp_path / "mh.npy"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts",
                                          "multihost_worker.py"),
             coord, "2", str(pid), str(out)],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    logs = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(o.decode(errors="replace"))
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{log[-3000:]}"
    assert out.exists()
    img_mh = np.load(out)

    # single-process reference over the same estimator/keys
    import jax

    jax.config.update("jax_platforms", "cpu")
    from alvrl_tpu.integrators.vrl import tracer
    from alvrl_tpu.integrators.vrl.integrate import VRLConfig
    from alvrl_tpu.integrators.vrl.vrl import compact
    from alvrl_tpu.parallel import mesh as mesh_mod
    from alvrl_tpu.parallel import render as prender
    from alvrl_tpu.scene import presets

    scene = presets.cornell_smoke(width=8, height=8)
    raw = tracer.trace(scene, jax.random.key(5), 16,
                       tracer.TracerConfig(max_depth=6))
    vrls = compact(raw, 64, slots_per_particle=6)
    mesh = mesh_mod.make_mesh(jax.local_device_count())
    img_sp = np.asarray(prender.render_image_sharded(
        mesh, scene, vrls, jax.random.key(7),
        VRLConfig(vol_vol_samples=1, vol_surf_samples=1, vrl_chunk=32)))

    assert np.isfinite(img_mh).all()
    assert img_mh.shape == img_sp.shape
    # same VRLs; per-pixel sampling keys differ between mesh layouts
    # only through the sharded key folds -> compare means statistically
    m_mh, m_sp = img_mh.mean(), img_sp.mean()
    assert m_mh > 0 and m_sp > 0
    assert abs(m_mh - m_sp) / m_sp < 0.35, (m_mh, m_sp)
