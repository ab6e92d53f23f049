"""Smoke test of the VRL renderer on one NVIDIA GPU (or four, --multi).

Drives the main paths through the entry points a user calls, at the
sizes of the BASELINE configurations, and checks every result against
the repository's own references:

  1. device      a GPU is present; its kind, count, name and power limit
  2. pair kernel the fused pair kernel (ops.pair_kernel), unclustered and
                 clustered, against integrate.pair_sum at the same hash
                 uniforms, at config 1 width (128x128 rays x 512 VRLs) and
                 on a 1024-wide band of config 5 (1024x16 rays); median
                 warm times of the kernel and of the XLA pair sum; then
                 whole render passes (render_with_vrls) through the kernel
                 and through the XLA path at configs 1 and 5 (1024x1024)
  3. unclustered render_progressive on Cornell smoke at 1024x1024 (config 5
                 stand-in), 2 passes; the VRL render against the volpath
                 onlyVRLpaths oracle at 64x64
  4. clustered   render_progressive(clustered=True) on config 2 (Cornell
                 smoke, 128x128, through the kernel) and config 4 (48^3
                 grid plume, 512x512, XLA); the mean of 8 clusterings of
                 one VRL set against its unclustered render; on config 2
                 also the clustered render through the kernel against the
                 XLA path at the same uniforms, per pixel
  5. gradient    one train_step on a 1x1 mesh at 128x128; reverse-mode AD
                 through the kernel (its custom VJP) against central
                 differences of the kernel's render for sigma_s and g at
                 32x32
  6. --multi     only: train_step, build_r_sharded and
                 render_clustered_sharded on a 4-GPU mesh against the same
                 calls on one GPU

Phase 2 runs alone, so its times are the device's. The gradient programs
then compile in a background thread while phases 3-4 run (the compile
releases the interpreter lock); each phase reports its own compile
seconds.

Each phase prints one JSON line with its checks, times (warm pass and
compile seconds) and the device's peak_bytes_in_use so far. Any failed
check raises, and the script exits non-zero. The last line of a passing
run is {"ok": true, "device": {...}}.

    python chip_smoke.py           # one GPU
    python chip_smoke.py --multi   # four GPUs
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def require_gpus(n):
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU; JAX found platform "
                 f"{devs[0].platform!r}")
    if len(devs) < n:
        sys.exit(f"chip_smoke: needs {n} GPUs, JAX found {len(devs)}")
    return devs


def emit(phase, **fields):
    stats = jax.devices()[0].memory_stats() or {}
    fields["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


def timed(fn, reps=5):
    """(first-call seconds, median warm seconds, result)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    times.sort()
    return first, times[len(times) // 2], out


def compile_aot(jitted, *args):
    """(compiled executable, compile seconds) for jitted(*args)."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    return compiled, time.perf_counter() - t0


def check(cond, what):
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------


def phase_device(n):
    devs = require_gpus(n)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    emit("device", platform=devs[0].platform, kind=devs[0].device_kind,
         count=len(devs), nvidia_smi=smi)
    return devs


def bench_vrls(capacity=512):
    from alvrl_tpu.integrators.vrl import vrl as vrl_mod

    # config 1's VRL set: 128 particles traced once, kept in data/
    return vrl_mod.compact(vrl_mod.load_ascii(
        os.path.join(ROOT, "data", "bench_vrls.txt"), particle_count=78.0),
        capacity)


def compare_rays(out, ref):
    """Per-ray sums of the kernel against the XLA path at the same
    uniforms."""
    # fp32 on both sides, another summation order and other
    # transcendental implementations: per-ray sums agree to 1e-3
    # relative with a floor of 1e-6 x the mean, except where a
    # last-bit difference flips a discrete decision (a shadow segment
    # grazing a triangle edge); at most 1 ray in 1000 may do so, and
    # the frame means agree to 1e-5.
    out, ref = np.asarray(out), np.asarray(ref)
    err = np.abs(out - ref)
    tol = 1e-3 * np.abs(ref) + 1e-6 * np.abs(ref).mean()
    res = dict(max_abs_err=float(err.max()),
               max_rel_err=float((err / (np.abs(ref) + 1e-6
                                         * np.abs(ref).mean())).max()),
               rays_over_tol=int((err > tol).sum()),
               frac_over_tol=float((err > tol).mean()),
               mean_rel_diff=float(abs(out.mean() - ref.mean())
                                   / abs(ref.mean())),
               tolerance="1e-3 rel per ray (floor 1e-6*mean) for all "
                         "but <=1e-3 of rays; frame mean 1e-5 rel")
    check(np.isfinite(out).all(), "kernel output not finite")
    check(ref.mean() > 0, "reference image is black")
    check(res["frac_over_tol"] <= 1e-3, f"kernel vs reference: {res}")
    check(res["mean_rel_diff"] <= 1e-5, f"kernel vs reference: {res}")
    return res


def phase_pair_kernel():
    import jax.numpy as jnp

    from alvrl_tpu.core import rng
    from alvrl_tpu.integrators.vrl import integrate, integrator
    from alvrl_tpu.integrators.vrl.integrate import VRLConfig
    from alvrl_tpu.ops import pair_kernel
    from alvrl_tpu.scene import presets
    from alvrl_tpu.sensors import perspective

    cfg = VRLConfig()
    vrls = bench_vrls()
    vrl_args = (vrls.start, vrls.end, vrls.power, vrls.valid)
    kernel = jax.jit(lambda *a: pair_kernel.pair_sum(cfg, *a))
    kernel_c = jax.jit(lambda *a: pair_kernel.pair_sum_clustered(cfg, *a))

    @jax.jit
    def reference(scene, o, d, hp, hv, hn, hm, vs, ve, vp, vv, seed):
        with jax.default_matmul_precision("highest"):
            return integrate.pair_sum(scene, o, d, hp, hv, hn, hm, vs, ve,
                                      vp, vv, seed, cfg)

    # both cases trace 16,384 rays, so one compiled kernel and one
    # compiled reference serve both (the pair sum never reads the camera)
    scene = presets.cornell_smoke(width=128, height=128)
    for name, w, rows in (("config1_128x128", 128, 128),
                          ("config5_band_1024x16", 1024, 16)):
        cam = presets.cornell_smoke(width=w, height=w).camera
        px, py = jnp.meshgrid(jnp.arange(w), jnp.arange(rows))
        o, d = perspective.sample_ray(cam, px.reshape(-1), py.reshape(-1))
        hit = integrator.trace_eye_rays(scene, o, d)
        rays = (o, d, hit.p, hit.valid, hit.ng, hit.mat)
        seed = rng.seed_bits(jax.random.key(7))
        n_ps = o.shape[0] * vrls.capacity * (cfg.vol_vol_samples
                                             + cfg.vol_surf_samples)

        first, t_k, out = timed(
            lambda: kernel(scene, *rays, *vrl_args, seed), reps=7)
        ref_first, t_x, ref = timed(
            lambda: reference(scene, *rays, *(a[None] for a in vrl_args),
                              seed), reps=7)
        emit("pair_kernel", case=name, rays=o.shape[0], vrls=vrls.capacity,
             **compare_rays(out, ref),
             kernel_median_s=t_k, kernel_compile_s=first - t_k,
             xla_median_s=t_x, xla_compile_s=ref_first - t_x,
             kernel_pair_sample_evals_per_s=n_ps / t_k,
             xla_pair_sample_evals_per_s=n_ps / t_x,
             speedup=t_x / t_k)

        if name.startswith("config1"):
            # clustered variant: 128 slices x 64 representatives
            k1, k2, k3 = jax.random.split(jax.random.key(9), 3)
            tv = jax.random.randint(k1, (128, 64), 0, vrls.capacity)
            tw = jax.random.uniform(k2, (128, 64), minval=0.5, maxval=8.0)
            sl = jax.random.randint(k3, (o.shape[0],), 0, 128)
            tab = (vrls.start[tv], vrls.end[tv],
                   vrls.power[tv] * tw[..., None], vrls.valid[tv])
            first, t_k, out = timed(
                lambda: kernel_c(scene, *rays, sl, *tab, seed))
            ref = reference(scene, *rays, *(a[sl] for a in tab), seed)
            emit("pair_kernel", case=name + "_clustered", rays=o.shape[0],
                 slices=128, reps_per_slice=64, **compare_rays(out, ref),
                 kernel_median_s=t_k, kernel_compile_s=first - t_k)

    # whole passes: render_with_vrls through the kernel (its default on
    # the GPU) and through the XLA path (tiles of 2048 rays); the two
    # draw other uniforms per tile, so their frame means agree to the
    # Monte Carlo noise of 512 VRLs (< 1%)
    xla = cfg.replace(fused_kernel=False)
    for name, size in (("config1_128x128", 128), ("config5_1024x1024", 1024)):
        sc = presets.cornell_smoke(width=size, height=size)
        check(pair_kernel.use_kernel(sc, cfg), "kernel not selected")
        res = {}
        for path, c in (("kernel", cfg), ("xla", xla)):
            first, med, img = timed(lambda: integrator.render_with_vrls(
                sc, vrls, jax.random.key(11), c))
            img = np.asarray(img)
            check(np.isfinite(img).all() and img.mean() > 0, (name, path))
            res[path] = dict(pass_s=med, compile_s=first - med,
                             mean=float(img.mean()))
        rel = abs(res["kernel"]["mean"] - res["xla"]["mean"]) \
            / res["xla"]["mean"]
        check(rel < 1e-2, (name, res))
        emit("pair_kernel", case="pass_" + name, vrls=vrls.capacity,
             kernel_pass_s=res["kernel"]["pass_s"],
             kernel_compile_s=res["kernel"]["compile_s"],
             xla_pass_s=res["xla"]["pass_s"],
             xla_compile_s=res["xla"]["compile_s"],
             speedup=res["xla"]["pass_s"] / res["kernel"]["pass_s"],
             mean_rel_diff=rel, limit=1e-2)


def phase_unclustered():
    from alvrl_tpu.integrators import progressive, volpath
    from alvrl_tpu.integrators.vrl import alvrl, integrator, tracer
    from alvrl_tpu.integrators.vrl.integrate import VRLConfig
    from alvrl_tpu.ops import pair_kernel
    from alvrl_tpu.scene import presets

    cfg = VRLConfig()
    # render_progressive at 1024^2: 512 VRLs from 128 particles, 2 passes
    scene = presets.cornell_smoke(width=1024, height=1024)
    check(pair_kernel.use_kernel(scene, cfg),
          "kernel not selected on the GPU")
    params = alvrl.ALVRLParams(vrl_target_num=512, num_particles=128)
    prog = progressive.ProgressiveConfig(max_passes=2)
    tcfg = tracer.TracerConfig(max_depth=12)

    def run():
        return progressive.render_progressive(
            scene, jax.random.key(1), prog, params, cfg, tcfg)

    t0 = time.perf_counter()
    img = run()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    img = run()
    warm = (time.perf_counter() - t0) / prog.max_passes
    check(img.shape == (scene.camera.height, scene.camera.width, 3),
          img.shape)
    check(np.isfinite(img).all(), "render_progressive: non-finite image")
    check(img.mean() > 0, "render_progressive: black image")
    emit("unclustered", case="render_progressive_1024x1024_2passes",
         pass_s=warm, compile_s=cold - 2 * warm, image_mean=float(img.mean()))

    # the reference's own A/B: VRL render vs the onlyVRLpaths oracle
    small = presets.cornell_smoke(width=64, height=64)
    t0 = time.perf_counter()
    vrl_runs = []
    for i in range(6):
        raw = tracer.trace(small, jax.random.key(i), 256,
                           tracer.TracerConfig(max_depth=16))
        vrl_runs.append(np.asarray(integrator.render_with_vrls(
            small, raw, jax.random.key(50 + i), cfg)))
    o_runs = [np.asarray(volpath.render_volpath(
        small, jax.random.key(100 + i), spp=1024,
        cfg=volpath.VolpathConfig(max_depth=16))) for i in range(3)]
    vrl_img, o_img = np.mean(vrl_runs, axis=0), np.mean(o_runs, axis=0)
    sigma_mean = max(float(np.std([r.mean() for r in o_runs], ddof=1)),
                     0.01 * o_img.mean())
    z = abs(vrl_img.mean() - o_img.mean()) / sigma_mean
    self_rel = float((np.abs(o_runs[0] - o_runs[1])
                      / (np.abs(o_img) + 1e-2)).mean())
    rel = float((np.abs(vrl_img - o_img) / (np.abs(o_img) + 1e-2)).mean())
    res = dict(z=z, z_limit=4.0, vrl_mean=float(vrl_img.mean()),
               oracle_mean=float(o_img.mean()), per_pixel_rel=rel,
               per_pixel_limit=1.5 * self_rel + 0.02)
    check(np.isfinite(vrl_img).all() and np.isfinite(o_img).all(), res)
    check(z < 4.0, res)
    check(rel < 1.5 * self_rel + 0.02, res)
    emit("unclustered", case="ab_oracle_64x64", seconds=time.perf_counter()
         - t0, **res)


def phase_clustered():
    import dataclasses

    from alvrl_tpu.integrators import progressive
    from alvrl_tpu.integrators.vrl import alvrl, cluster_native, integrator
    from alvrl_tpu.integrators.vrl import cluster as cl
    from alvrl_tpu.integrators.vrl import tracer
    from alvrl_tpu.integrators.vrl import vrl as vrl_mod
    from alvrl_tpu.integrators.vrl.integrate import VRLConfig
    from alvrl_tpu.ops import pair_kernel
    from alvrl_tpu.scene import presets

    TracerConfig = tracer.TracerConfig
    cfg = VRLConfig()
    cases = (
        ("config2_128x128", presets.cornell_smoke(width=128, height=128),
         alvrl.ALVRLParams(vrl_target_num=512, num_particles=128,
                           cluster=cl.ClusterParams(
                               target_num_slices=100,
                               target_pixel_undersampling=64.0)),
         TracerConfig(max_depth=12)),
        ("config4_grid48_512x512", presets.cornell_grid_smoke(512, 512),
         alvrl.ALVRLParams(vrl_target_num=512, num_particles=192,
                           cluster=cl.ClusterParams(
                               target_num_slices=128,
                               target_pixel_undersampling=128.0)),
         TracerConfig(max_depth=10)),
    )
    for name, scene, params, tcfg in cases:
        prog = progressive.ProgressiveConfig(max_passes=2, clustered=True)
        kernel = pair_kernel.use_kernel(scene, cfg)
        check(kernel == name.startswith("config2"), (name, kernel))

        def run():
            return progressive.render_progressive(
                scene, jax.random.key(1), prog, params, cfg, tcfg)

        t0 = time.perf_counter()
        img = run()
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        img = run()
        warm = (time.perf_counter() - t0) / prog.max_passes
        check(np.isfinite(img).all() and img.mean() > 0, name)

        # clustered vs unclustered with the same VRL set: the clustered
        # estimator is unbiased for it over the random choice of
        # representatives, but one clustering's frame mean can stray by a
        # few % (its errors are shared by every pixel of a slice). So 8
        # clusterings (host and R seeds 0-7) are averaged, and their mean
        # must lie within 4 standard errors of the unclustered render.
        si = alvrl.build_slice_info(scene, params)
        vrls = vrl_mod.compact(
            tracer.trace(scene, jax.random.key(2), params.num_particles,
                         tcfg), params.vrl_target_num,
            slots_per_particle=tcfg.max_depth)
        m_u = float(np.asarray(integrator.render_with_vrls(
            scene, vrls, jax.random.key(3), cfg)).mean())
        m_c = []
        for seed in range(8):
            tables = alvrl.prepare_clustering(
                scene, vrls, None, dataclasses.replace(params, seed=seed),
                cfg, slice_info=si)[:3]
            m_c.append(float(np.asarray(integrator.render_clustered(
                scene, vrls, *tables, jax.random.key(5 + seed),
                cfg)).mean()))
        z = abs(np.mean(m_c) - m_u) / (np.std(m_c, ddof=1) / np.sqrt(8))
        check(z < 4.0, (name, m_c, m_u))
        check(cluster_native._lib is not None, "native refiner not used")
        fields = {}
        if kernel:
            # the clustered render through the kernel and through the XLA
            # path in one tile: the same uniforms, so per-pixel agreement
            n = scene.camera.width * scene.camera.height
            out = [np.asarray(integrator.render_clustered(
                scene, vrls, *tables, jax.random.key(5), c,
                ray_tile=n)).reshape(-1, 3)
                for c in (cfg, cfg.replace(fused_kernel=False))]
            fields = {"kernel_vs_xla": compare_rays(*out)}
        emit("clustered", case=name, pass_s=warm,
             compile_s=cold - 2 * warm, image_mean=float(img.mean()),
             clustered_means=m_c, unclustered_mean=m_u,
             mean_rel_diff=abs(np.mean(m_c) - m_u) / m_u, z=z, z_limit=4.0,
             kernel=kernel, native_refiner=True, **fields)


def compile_gradient_programs():
    """Phase 5's programs, lowered and compiled (run in a thread): the
    train step, and the value and reverse-mode gradient of a 32x32 render
    on a fixed VRL set w.r.t. shifts of sigma_s and g. Both renders take
    the pair kernel, so the gradients come from its custom VJP."""
    import jax.numpy as jnp

    from alvrl_tpu.integrators.vrl import integrator, tracer
    from alvrl_tpu.integrators.vrl.integrate import VRLConfig
    from alvrl_tpu.ops import pair_kernel
    from alvrl_tpu.parallel import render as prender
    from alvrl_tpu.parallel.mesh import make_mesh
    from alvrl_tpu.scene import presets

    cfg = VRLConfig()
    scene = presets.cornell_smoke(width=128, height=128)
    mesh = make_mesh(1)
    target = jnp.zeros((scene.camera.height, scene.camera.width, 3))
    step = jax.jit(lambda k, t: prender.train_step(
        mesh, scene, k, t, cfg, num_particles=8))
    key = jax.random.key(1)
    train = compile_aot(step, key, target) + ((key, target),)

    small = presets.cornell_smoke(width=32, height=32)
    check(pair_kernel.use_kernel(small, cfg), "kernel not selected")
    vr = tracer.trace(small, jax.random.key(0), 32,
                      tracer.TracerConfig(max_depth=8))

    def mean_image(sc, vr, x):
        # x = (shift of sigma_s, shift of g)
        med = sc.medium.replace(sigma_s=sc.medium.sigma_s + x[0],
                                g=sc.medium.g + x[1])
        img = integrator.render_with_vrls(sc.replace(medium=med), vr,
                                          jax.random.key(2), cfg)
        return jnp.mean(img)

    x0 = jnp.zeros(2, jnp.float32)
    fd = compile_aot(jax.jit(jax.value_and_grad(mean_image, argnums=2)),
                     small, vr, x0) + ((small, vr),)
    return dict(train=train, fd=fd)


def phase_gradient(programs):
    import jax.numpy as jnp

    (step, step_compile, step_args) = programs["train"]
    first, med, (loss, grads) = timed(lambda: step(*step_args), reps=3)
    finite = all(bool(jnp.all(jnp.isfinite(g))) for g in grads.values())
    check(bool(jnp.isfinite(loss)) and finite, "train_step not finite")
    check(any(float(jnp.abs(g).sum()) > 0 for g in grads.values()),
          "train_step gradients all zero")
    emit("gradient", case="train_step_1x1_128x128", step_s=med,
         compile_s=step_compile, loss=float(loss),
         grad_abs_sums={k: float(jnp.abs(v).sum())
                        for k, v in grads.items()})

    # reverse-mode AD (the kernel's custom VJP: the gradient of the XLA
    # estimator at the kernel's uniforms) against central differences of
    # the kernel's own render (fixed VRL set, fixed uniforms). eps 2e-3
    # in fp32: truncation and rounding stay below 1e-3 relative, so 1e-2
    # leaves room for the estimator's few discontinuities (shadow edges)
    # between the two evaluation points and for the two paths' rounding.
    (fd, fd_compile, (small, vr)) = programs["fd"]
    eps = 2e-3
    _, g_ad = fd(small, vr, jnp.zeros(2, jnp.float32))
    res = {}
    for i, pname in enumerate(("sigma_s", "g")):
        e = jnp.zeros(2, jnp.float32).at[i].set(1.0)
        f_hi, _ = fd(small, vr, eps * e)
        f_lo, _ = fd(small, vr, -eps * e)
        ad, g_fd = float(g_ad[i]), (float(f_hi) - float(f_lo)) / (2 * eps)
        rel = abs(ad - g_fd) / max(abs(g_fd), 1e-9)
        res[pname] = dict(ad=ad, fd=g_fd, rel_err=rel)
        check(np.isfinite(ad) and rel < 1e-2, (pname, res[pname]))
    emit("gradient", case="ad_vs_fd_32x32_kernel", tolerance=1e-2,
         compile_s=fd_compile, **res)


def compile_multi_programs():
    """The sharded programs on the 4-GPU mesh and on one GPU, each
    compiled in its own thread (they are independent)."""
    import jax.numpy as jnp

    from alvrl_tpu.integrators.vrl import alvrl, tracer
    from alvrl_tpu.integrators.vrl import cluster as cl
    from alvrl_tpu.integrators.vrl.integrate import VRLConfig
    from alvrl_tpu.integrators.vrl.vrl import compact
    from alvrl_tpu.parallel import render as prender
    from alvrl_tpu.parallel.mesh import make_mesh
    from alvrl_tpu.scene import presets
    from alvrl_tpu.sensors import perspective

    # one sample of each kind: the sharding, not the estimator, is what
    # this phase checks, and the smaller program compiles in half the time
    cfg = VRLConfig(vol_vol_samples=1, vol_surf_samples=1)
    scene = presets.cornell_smoke(width=128, height=128)
    meshes = {1: make_mesh(1), 4: make_mesh(4)}
    target = jnp.zeros((scene.camera.height, scene.camera.width, 3))

    jobs, futures = {}, {}
    with ThreadPoolExecutor(3 * len(meshes)) as pool:
        def submit(name, fn, *args):
            jobs[name] = (fn, args)
            futures[name] = pool.submit(compile_aot, fn, *args)

        # the train steps take longest to compile: start them first
        for n, mesh in meshes.items():
            submit(("train", n), jax.jit(lambda k, t, mesh=mesh: (
                prender.train_step(mesh, scene, k, t, cfg,
                                   num_particles=8))),
                   jax.random.key(1), target)
        vrls = compact(tracer.trace(scene, jax.random.key(2), 128,
                                    tracer.TracerConfig(max_depth=12)),
                       512, slots_per_particle=12)
        px = jnp.arange(1024) % 128
        py = (jnp.arange(1024) * 37) % 128
        r_o, r_d = perspective.sample_ray(scene.camera, px, py)
        for n, mesh in meshes.items():
            submit(("build_r", n), jax.jit(lambda o, d, k, mesh=mesh: (
                prender.build_r_sharded(
                    mesh, scene, o, d,
                    prender.pad_vrls(vrls, mesh.shape["vrls"]), k, cfg))),
                   r_o, r_d, jax.random.key(3))
        # the clustering tables, on this thread meanwhile
        params = alvrl.ALVRLParams(
            vrl_target_num=512, num_particles=128,
            cluster=cl.ClusterParams(target_num_slices=100,
                                     target_pixel_undersampling=64.0))
        sop, tv, tw, _ = alvrl.prepare_clustering(
            scene, vrls, jax.random.key(4), params, cfg)
        for n, mesh in meshes.items():
            submit(("clustered", n), jax.jit(lambda k, mesh=mesh: (
                prender.render_clustered_sharded(
                    mesh, scene, prender.pad_vrls(vrls, mesh.shape["vrls"]),
                    sop, tv, tw, k, cfg))), jax.random.key(5))
        compiled = {name: f.result() + (jobs[name][1],)
                    for name, f in futures.items()}
    return dict(scene=scene, meshes=meshes, vrls=vrls, compiled=compiled)


def phase_multi(programs):
    meshes, vrls = programs["meshes"], programs["vrls"]
    compiled = programs["compiled"]

    # train step: same traced VRLs, other uniforms per device
    out = {}
    for n in meshes:
        fn, comp_s, args = compiled[("train", n)]
        _, med, res = timed(lambda: fn(*args), reps=3)
        out[n] = (comp_s, med, res)
    (_, t1, (l1, g1)), (c4, t4, (l4, g4)) = out[1], out[4]
    ratios = {}
    for name in g1:
        a, b = np.asarray(g4[name]).ravel(), np.asarray(g1[name]).ravel()
        big = np.abs(b) > 0.05 * np.abs(b).max()
        # gradients of independent estimates of the same loss: same sign
        # everywhere they are not near zero, magnitudes within 25%
        check((np.sign(a[big]) == np.sign(b[big])).all(), (name, a, b))
        r = a[big] / b[big]
        check(((r > 0.8) & (r < 1.25)).all(), (name, r))
        ratios[name] = [float(r.min()), float(r.max())]
    emit("multi", case="train_step_mesh4_vs_mesh1",
         mesh=dict(meshes[4].shape), step_s_4=t4, step_s_1=t1,
         compile_s_4=c4, loss_4=float(l4), loss_1=float(l1),
         grad_ratio_range=ratios, ratio_limits=[0.8, 1.25])

    # transfer matrix R, rays x VRLs sharded, no collective
    r = {}
    for n in meshes:
        fn, comp_s, args = compiled[("build_r", n)]
        _, med, (rm, _) = timed(lambda: fn(*args))
        r[n] = (np.asarray(rm)[:, :vrls.capacity], med, comp_s)
    d = (r[4][0] - r[1][0]).ravel()
    z = abs(d.mean()) / (d.std() / np.sqrt(d.size))
    check(np.isfinite(r[4][0]).all() and z < 3.0, ("build_r", z))
    emit("multi", case="build_r_sharded_1024x512", z=z, z_limit=3.0,
         r_mean_4=float(r[4][0].mean()), r_mean_1=float(r[1][0].mean()),
         pass_s_4=r[4][1], pass_s_1=r[1][1], compile_s_4=r[4][2])

    # clustered render, rays sharded, tables replicated
    imgs = {}
    for n in meshes:
        fn, comp_s, args = compiled[("clustered", n)]
        _, med, img = timed(lambda: fn(*args))
        imgs[n] = (np.asarray(img), med, comp_s)
    d = (imgs[4][0] - imgs[1][0]).ravel()
    z = abs(d.mean()) / (d.std() / np.sqrt(d.size))
    check(np.isfinite(imgs[4][0]).all() and z < 3.0, ("clustered", z))
    emit("multi", case="render_clustered_sharded_128x128", z=z, z_limit=3.0,
         image_mean_4=float(imgs[4][0].mean()),
         image_mean_1=float(imgs[1][0].mean()), pass_s_4=imgs[4][1],
         pass_s_1=imgs[1][1], compile_s_4=imgs[4][2])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-GPU sharded path and its "
                         "1-GPU comparison")
    args = ap.parse_args()
    n = 4 if args.multi else 1
    require_gpus(n)

    from alvrl_tpu import compile_cache

    compile_cache.enable()
    devs = phase_device(n)
    if args.multi:
        phase_multi(compile_multi_programs())
    else:
        phase_pair_kernel()
        with ThreadPoolExecutor(1) as pool:
            gradient_programs = pool.submit(compile_gradient_programs)
            phase_unclustered()
            phase_clustered()
            phase_gradient(gradient_programs.result())
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
