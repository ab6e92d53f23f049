"""Precompute the volpath oracle image for equal-time comparisons
(run on CPU: forced below)."""
import os
import sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from alvrl_tpu.integrators import volpath
from alvrl_tpu.scene import presets

W = int(sys.argv[1]) if len(sys.argv) > 1 else 64
SPP = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
out = sys.argv[3] if len(sys.argv) > 3 else f"/tmp/oracle{W}.npy"
scene = presets.cornell_smoke(width=W, height=W)
img = np.asarray(volpath.render_volpath(
    scene, jax.random.key(999), spp=SPP,
    cfg=volpath.VolpathConfig(max_depth=12), ray_tile=4096))
np.save(out, img)
print("saved", out, img.mean())
