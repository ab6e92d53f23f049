"""Device mesh construction.

Replaces the reference's worker registry (Scheduler::registerWorker,
mitsuba.cpp:280-314) with a jax.sharding.Mesh. Axes:

  'rays' — image-space data parallelism (the counterpart of P1 tile
           distribution, renderproc.cpp:117-184);
  'vrls' — the VRL set sharded across devices; partial per-ray sums are
           reduced with psum (the counterpart of the film
           reduction P7, and the scalable answer to growing VRL counts
           suggested in SURVEY §5 long-context notes).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def _factor(n: int) -> tuple[int, int]:
    """Split n into (rays, vrls) with the vrl axis at most ~sqrt(n)."""
    best = 1
    for v in range(1, int(np.sqrt(n)) + 1):
        if n % v == 0:
            best = v
    return n // best, best


def make_mesh(n_devices: int | None = None, shape: tuple[int, int] | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = devs[:n_devices]
    if shape is None:
        shape = _factor(n_devices)
    return Mesh(np.asarray(devs).reshape(shape), ("rays", "vrls"))
