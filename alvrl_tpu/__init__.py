"""alvrl_tpu — a differentiable volumetric renderer in JAX.

A JAX/XLA/Pallas framework with the capabilities of the reference
Mitsuba-ALVRL system (Adaptive LightSlice for Virtual Ray Lights,
Frederickx, Bartels, Dutré, EG 2015): many-light volumetric transport with
Virtual Ray Lights, accelerated by adaptive per-image-slice clustering of
the VRL set, differentiable w.r.t. medium parameters (sigma_t, albedo,
phase g) and light intensities.

Design stance (vs. the C++ reference):
  * a scene is a pytree of arrays, not a refcounted object graph
  * renderers are jit-compiled pure functions
  * parallelism is a jax.sharding.Mesh + shard_map, not a TCP scheduler
  * the VRL x eye-ray coupling runs as one fused Pallas kernel on NVIDIA
    GPUs (ops.pair_kernel) and as plain XLA elsewhere
  * RNG is counter-based (threefry keys per {pass, pixel, purpose}, and a
    hash of (seed, ray, VRL, draw) for the pair estimator), not mutable
    per-worker sampler clones
"""

__version__ = "0.1.0"

from alvrl_tpu.scene.scene import Scene  # noqa: F401
