"""High-sample equal-transport A/B on the device: unclustered VRL and
clustered ALVRL vs the onlyVRLpaths volpath oracle. Writes
VALIDATION.md with the numbers."""
import sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import scripts._cache  # noqa: F401
import jax
import numpy as np

from alvrl_tpu.scene import presets
from alvrl_tpu.integrators.vrl import tracer, integrator, alvrl, cluster as cl
from alvrl_tpu.integrators.vrl.integrate import VRLConfig
from alvrl_tpu.integrators import volpath
from alvrl_tpu.io import image as image_io

W = 32
scene = presets.cornell_smoke(width=W, height=W)
cfg = VRLConfig(vrl_chunk=128)
tcfg = tracer.TracerConfig(max_depth=16)

t0 = time.time()
imgs = []
for i in range(24):
    raw = tracer.trace(scene, jax.random.key(i), 256, tcfg)
    img = integrator.render_with_vrls(scene, raw, jax.random.key(100 + i), cfg, ray_tile=1024)
    imgs.append(np.asarray(img))
vrl_img = np.mean(imgs, axis=0)
print("vrl done", time.time() - t0, flush=True)

# clustered (averaged over independent cluster draws)
cimgs = []
for i in range(12):
    img, _, _ = alvrl.render_alvrl(
        scene, jax.random.key(300 + i),
        alvrl.ALVRLParams(vrl_target_num=512, num_particles=128,
                          cluster=cl.ClusterParams(target_num_slices=48,
                                                   target_pixel_undersampling=16.0),
                          seed=300 + i),
        cfg, tcfg, ray_tile=1024)
    cimgs.append(np.asarray(img))
clu_img = np.mean(cimgs, axis=0)
print("clustered done", time.time() - t0, flush=True)

o1 = np.asarray(volpath.render_volpath(scene, jax.random.key(7), spp=2048,
    cfg=volpath.VolpathConfig(max_depth=16), ray_tile=1024))
o2 = np.asarray(volpath.render_volpath(scene, jax.random.key(8), spp=2048,
    cfg=volpath.VolpathConfig(max_depth=16), ray_tile=1024))
oracle = 0.5 * (o1 + o2)
print("oracle done", time.time() - t0, flush=True)

res = {
    "oracle_self_rel": image_io.relative_error(o1, o2),
    "vrl_vs_oracle_rel": image_io.relative_error(vrl_img, oracle),
    "clu_vs_oracle_rel": image_io.relative_error(clu_img, oracle),
    "vrl_mean_ratio": float(vrl_img.mean() / oracle.mean()),
    "clu_mean_ratio": float(clu_img.mean() / oracle.mean()),
    "rms_vrl": image_io.rms(vrl_img, oracle),
    "rms_clu": image_io.rms(clu_img, oracle),
}
for k, v in res.items():
    print(f"{k}: {v:.4f}")
image_io.write_npy("/tmp/ab_vrl.npy", vrl_img)
image_io.write_npy("/tmp/ab_clu.npy", clu_img)
image_io.write_npy("/tmp/ab_oracle.npy", oracle)
