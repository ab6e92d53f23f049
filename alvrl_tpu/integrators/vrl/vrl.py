"""VRL records as fixed-capacity struct-of-arrays buffers.

Counterpart of VRL / vrlVector (src/integrators/vrl/VRL.h). Where the
reference grows a std::vector until vrlTargetNum VRLs are stored, the
array build traces a *fixed* number of particles in parallel and emits a
fixed-capacity (particles x max_depth) buffer with a validity mask —
the estimator normalizes by traced-particle count (VRL.h:164,
vrlIntegrator.cpp:590), so a fixed particle budget is unbiased by
construction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from alvrl_tpu.core import struct


@struct.dataclass
class VRLs:
    start: jax.Array   # (N, 3)
    end: jax.Array     # (N, 3)
    power: jax.Array   # (N, 3) radiant intensity along the segment
    valid: jax.Array   # (N,) bool
    particle_count: jax.Array  # scalar f32: traced particles (normalizer)

    @property
    def capacity(self) -> int:
        return self.start.shape[0]


def compact(vrls: VRLs, capacity: int | None = None,
            slots_per_particle: int | None = None) -> VRLs:
    """Host-side compaction: pack valid VRLs to the front (optionally
    truncating/padding to `capacity`). Run once per pass between tracing
    and rendering — keeps the render kernel from wasting lanes on
    masked-out slots.

    Truncation must drop WHOLE particles (the estimator normalizes by
    traced-particle count; dropping individual VRLs of a kept particle
    loses transport). Pass `slots_per_particle` (= tracer max_depth)
    when the buffer may exceed `capacity`: the largest particle prefix
    whose VRLs fit is kept and `particle_count` is reduced accordingly —
    the analog of the reference stopping at vrlTargetNum whole particles
    (vrlTracer.h:29-39)."""
    valid = np.asarray(vrls.valid)
    idx = np.nonzero(valid)[0]
    if capacity is None:
        capacity = int(len(idx))
    if len(idx) > capacity:
        if slots_per_particle is None:
            raise ValueError(
                f"{len(idx)} valid VRLs exceed capacity {capacity}; pass "
                "slots_per_particle so truncation can drop whole particles"
            )
        per_particle = valid.reshape(-1, slots_per_particle).sum(axis=1)
        csum = np.cumsum(per_particle)
        n_keep = int(np.searchsorted(csum, capacity, side="right"))
        if n_keep == 0:
            raise ValueError("capacity smaller than one particle's VRLs")
        keep_mask = np.zeros_like(valid)
        keep_mask[: n_keep * slots_per_particle] = True
        idx = np.nonzero(valid & keep_mask)[0]
        vrls = vrls.replace(particle_count=jnp.float32(n_keep))
    sel = idx[:capacity]
    pad = capacity - len(sel)

    def take(a):
        a = np.asarray(a)
        out = a[sel]
        if pad > 0:
            out = np.concatenate([out, np.zeros((pad,) + a.shape[1:], a.dtype)])
        return jnp.asarray(out)

    new_valid = np.zeros((capacity,), bool)
    new_valid[: len(sel)] = True
    return VRLs(
        start=take(vrls.start),
        end=take(vrls.end),
        power=take(vrls.power),
        valid=jnp.asarray(new_valid),
        particle_count=vrls.particle_count,
    )


def compact_device(vrls: VRLs, capacity: int,
                   slots_per_particle: int) -> VRLs:
    """jnp twin of `compact` for pipelined drivers (round 5): the host
    version's np.nonzero forces a device->host sync on the freshly
    traced buffer, which stalls the software pipeline of
    alvrl.render_alvrl_progressive (the host blocks before it can
    enqueue the next render). This version compacts on-device with
    static shapes: whole-particle truncation (same
    normalization-correct semantics), valid slots packed to the front
    via a stable argsort, zero padding, and a TRACED particle_count.

    Equivalent to `compact(vrls, capacity, slots_per_particle)` up to
    the kept-slot ORDER being identical (argsort over the original
    index is stable) — verified in tests/test_components.py."""
    n = vrls.valid.shape[0]
    valid = vrls.valid
    per_particle = valid.reshape(-1, slots_per_particle).sum(axis=1)
    csum = jnp.cumsum(per_particle)
    n_keep = jnp.searchsorted(csum, jnp.int32(capacity), side="right")
    n_particles = per_particle.shape[0]
    # if everything fits, keep all particles
    n_keep = jnp.where(csum[-1] <= capacity, n_particles, n_keep)
    keep = valid & ((jnp.arange(n) // slots_per_particle) < n_keep)
    # stable pack-to-front: sort by (not kept, original index)
    order = jnp.argsort(jnp.where(keep, jnp.arange(n), n + jnp.arange(n)))
    sel = order[:capacity]
    new_valid = keep[sel]

    def take(a):
        return jnp.where(new_valid.reshape((-1,) + (1,) * (a.ndim - 1)),
                         a[sel], 0.0)

    return VRLs(
        start=take(vrls.start),
        end=take(vrls.end),
        power=take(vrls.power),
        valid=new_valid,
        particle_count=jnp.minimum(
            n_keep, n_particles).astype(jnp.float32),
    )


def save_ascii(vrls: VRLs, path: str):
    """ASCII VRL interchange format of the reference (VRL.h:43-54,65-73):
    one line per VRL: x0 y0 z0 x1 y1 z1 r g b."""
    s = np.asarray(vrls.start)
    e = np.asarray(vrls.end)
    p = np.asarray(vrls.power)
    v = np.asarray(vrls.valid)
    with open(path, "w") as f:
        for i in range(len(s)):
            if not v[i]:
                continue
            f.write(
                " ".join(
                    f"{x:.9g}"
                    for x in (*s[i], *e[i], *p[i])
                )
                + "\n"
            )


def load_ascii(path: str, particle_count: float | None = None) -> VRLs:
    """Load the reference's ASCII VRL format. The file does not store the
    particle count; the reference sets it to the VRL count on load
    (VRL.h:127) — we default to the same."""
    rows = np.loadtxt(path, dtype=np.float32, ndmin=2)
    n = len(rows)
    if particle_count is None:
        particle_count = float(n)
    return VRLs(
        start=jnp.asarray(rows[:, 0:3]),
        end=jnp.asarray(rows[:, 3:6]),
        power=jnp.asarray(rows[:, 6:9]),
        valid=jnp.ones((n,), bool),
        particle_count=jnp.float32(particle_count),
    )
