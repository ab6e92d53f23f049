"""Deterministic keyed RNG.

Replaces the reference's mutable per-worker sampler clones
(src/samplers/independent.cpp, renderjob.cpp:59-69) with counter-based
threefry keys derived per {pass, pixel, sample, purpose}. This gives
bit-reproducible renders independent of device count and work order —
the property the reference only approximates by cloning samplers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Stable purpose tags so different consumers of randomness never collide.
P_EMISSION = 0
P_DISTANCE = 1
P_PHASE = 2
P_BSDF = 3
P_RR = 4
P_VOLVOL = 5
P_VOLSURF = 6
P_PIXEL = 7
P_CLUSTER = 8
P_CHANNEL = 9
P_SPECULAR = 10
P_TRACKING = 11


def make_root(seed: int) -> jax.Array:
    return jax.random.key(seed)


def fold(key, *ids):
    """Derive a subkey by folding in a sequence of integer ids."""
    for i in ids:
        key = jax.random.fold_in(key, i)
    return key


def uniform(key, shape=()):
    """U[0,1) float32, matching Sampler::next1D semantics."""
    return jax.random.uniform(key, shape, dtype=jnp.float32)


def uniform2(key, shape=()):
    """U[0,1)^2, matching Sampler::next2D."""
    return jax.random.uniform(key, shape + (2,), dtype=jnp.float32)


# ---------------------------------------------------------------------------
# Counter-based hash uniforms for the VRL pair estimator. One uniform per
# (seed, ray index, VRL index, slot), where a slot numbers the estimator's
# draws for one pair (2 per vol-vol sample, 1 per vol-surf sample). Plain
# uint32 arithmetic, so the same functions run inside a GPU kernel and in
# the XLA reference and give the same bits.
# ---------------------------------------------------------------------------

MAX_PAIR_SLOTS = 16


def mix32(x):
    """Bijective 32-bit integer finalizer (Wellons' lowbias32)."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x21F0AAAD)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x735A2D97)
    return x ^ (x >> 15)


def seed_bits(key):
    """A uint32 seed drawn from a JAX key."""
    return jax.random.bits(key, (), jnp.uint32)


def ray_hash(seed, ray_idx):
    """Per-ray half of the pair hash; ray_idx is any integer array."""
    return mix32(seed ^ mix32(ray_idx.astype(jnp.uint32)))


def vrl_slot_hash(vrl_idx, slot: int):
    """Per-(VRL, slot) half of the pair hash; slot < MAX_PAIR_SLOTS."""
    return mix32(vrl_idx.astype(jnp.uint32) * jnp.uint32(MAX_PAIR_SLOTS)
                 + jnp.uint32(slot))


def pair_u01(ray_h, vrl_slot_h):
    """U[0,1) float32 with 24 random bits from the two hash halves."""
    h = mix32(ray_h ^ vrl_slot_h)
    return (h >> 8).astype(jnp.int32).astype(jnp.float32) * jnp.float32(
        2.0 ** -24)
