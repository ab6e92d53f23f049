"""Support code of the render path: the pair hash, the pytree dataclass
helper and the compile-cache helper."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alvrl_tpu import compile_cache
from alvrl_tpu.core import rng, struct
from alvrl_tpu.integrators.vrl.integrate import VRLConfig, pair_uniforms


def _u(seed=1, n_rays=512, n_vrls=256, slot=0):
    rh = rng.ray_hash(jnp.uint32(seed), jnp.arange(n_rays))[:, None]
    vh = rng.vrl_slot_hash(jnp.arange(n_vrls), slot)[None, :]
    return np.asarray(rng.pair_u01(rh, vh))


def test_hash_uniform_range_and_moments():
    u = _u()
    assert u.dtype == np.float32
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 3e-3
    assert abs(u.var() - 1.0 / 12.0) < 2e-3


def test_hash_uniform_chi_square():
    counts = np.bincount((_u() * 64).astype(int).ravel(), minlength=64)
    expected = counts.sum() / 64
    chi2 = ((counts - expected) ** 2 / expected).sum()
    # 63 degrees of freedom: the 0.999 quantile is about 103
    assert chi2 < 103, chi2


@pytest.mark.parametrize("other", ["slot", "seed", "next_ray", "next_vrl"])
def test_hash_uniform_independence(other):
    a = _u()
    b = {
        "slot": lambda: _u(slot=1),
        "seed": lambda: _u(seed=2),
        "next_ray": lambda: np.roll(_u(), 1, axis=0),
        "next_vrl": lambda: np.roll(_u(), 1, axis=1),
    }[other]()
    r = np.corrcoef(a.ravel(), b.ravel())[0, 1]
    assert abs(r) < 0.01, r
    # no identical draws beyond chance among 131072 pairs
    assert (a == b).mean() < 1e-3


def test_pair_uniforms_layout():
    cfg = VRLConfig(vol_vol_samples=2, vol_surf_samples=3)
    seed = jnp.uint32(9)
    u_vv, u_vs = pair_uniforms(seed, jnp.arange(4), jnp.arange(5), cfg)
    assert u_vv.shape == (4, 5, 2, 2) and u_vs.shape == (4, 5, 3)
    rh = rng.ray_hash(seed, jnp.arange(4))[:, None]
    vh = lambda s: rng.vrl_slot_hash(jnp.arange(5), s)[None, :]
    np.testing.assert_array_equal(u_vv[..., 1, 0], rng.pair_u01(rh, vh(2)))
    np.testing.assert_array_equal(u_vs[..., 2], rng.pair_u01(rh, vh(6)))
    with pytest.raises(ValueError):
        pair_uniforms(seed, jnp.arange(4), jnp.arange(5),
                      VRLConfig(vol_vol_samples=8, vol_surf_samples=1))


@struct.dataclass
class _Point:
    x: jax.Array
    tag: str = struct.field(pytree_node=False, default="a")


def test_struct_pytree_and_static_fields():
    p = _Point(x=jnp.ones(3))
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 1
    q = jax.tree_util.tree_map(lambda v: v * 2, p)
    assert q.tag == "a" and float(q.x.sum()) == 6.0
    # static fields are part of the tree structure
    assert treedef != jax.tree_util.tree_structure(p.replace(tag="b"))
    out = jax.jit(lambda p: p.x * (2 if p.tag == "b" else 1))(
        p.replace(tag="b"))
    assert float(out.sum()) == 6.0


def test_struct_replace_and_frozen():
    p = _Point(x=jnp.zeros(2))
    q = p.replace(x=jnp.ones(2))
    assert float(p.x.sum()) == 0.0 and float(q.x.sum()) == 2.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.x = jnp.ones(2)


def test_struct_configs_hash_by_value():
    assert VRLConfig(vrl_chunk=64) == VRLConfig(vrl_chunk=64)
    assert hash(VRLConfig(vrl_chunk=64)) == hash(VRLConfig(vrl_chunk=64))
    assert VRLConfig(vrl_chunk=64) != VRLConfig(vrl_chunk=32)
    calls = []
    f = jax.jit(lambda x, cfg: calls.append(cfg) or x + cfg.vrl_chunk,
                static_argnames=("cfg",))
    f(1.0, cfg=VRLConfig(vrl_chunk=3))
    f(1.0, cfg=VRLConfig(vrl_chunk=3))
    assert len(calls) == 1


def test_cache_dir_follows_environment(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    assert compile_cache.cache_dir() is None
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    path = compile_cache.cache_dir()
    root = os.path.dirname(os.path.dirname(compile_cache.__file__))
    assert path == os.path.join(root, ".jax_cache")
    assert path == compile_cache.cache_dir()


def test_cache_enable_sets_no_directory_when_environment_does(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    try:
        assert compile_cache.enable() == "/elsewhere"
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
