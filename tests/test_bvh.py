"""BVH tests: native build + device traversal vs the brute-force
intersector (counterpart of test_kd.cpp's build/trace checks)."""

import jax
import jax.numpy as jnp
import numpy as np

from alvrl_tpu.geometry import bvh as bvh_mod
from alvrl_tpu.geometry import intersect, shapes


def _random_mesh(n=200, seed=0):
    rng = np.random.default_rng(seed)
    # soup of random small triangles in [-1, 1]^3
    centers = rng.uniform(-1, 1, (n, 1, 3))
    offsets = rng.normal(0, 0.08, (n, 3, 3))
    verts = (centers + offsets).reshape(-1, 3).astype(np.float32)
    faces = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    return verts, faces


def test_build_covers_all_prims():
    verts, faces = _random_mesh(100)
    b = bvh_mod.build(verts, faces)
    order = np.sort(np.asarray(b.prim_order))
    np.testing.assert_array_equal(order, np.arange(100))
    # root bounds contain all vertices
    lo = np.asarray(b.bounds_lo[0])
    hi = np.asarray(b.bounds_hi[0])
    assert (verts >= lo - 1e-5).all() and (verts <= hi + 1e-5).all()


def test_traversal_matches_bruteforce():
    verts, faces = _random_mesh(300, seed=1)
    b = bvh_mod.build(verts, faces)
    rng = np.random.default_rng(2)
    n_rays = 128
    o = rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    hit_bf = intersect.intersect_all(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(verts), jnp.asarray(faces)
    )
    t_bvh, prim_bvh, valid_bvh = jax.vmap(
        lambda oo, dd: bvh_mod.intersect(b, oo, dd)
    )(jnp.asarray(o), jnp.asarray(d))

    np.testing.assert_array_equal(
        np.asarray(valid_bvh), np.asarray(hit_bf.valid)
    )
    both = np.asarray(valid_bvh) & np.asarray(hit_bf.valid)
    np.testing.assert_allclose(
        np.asarray(t_bvh)[both], np.asarray(hit_bf.t)[both], rtol=1e-4
    )
    np.testing.assert_array_equal(
        np.asarray(prim_bvh)[both], np.asarray(hit_bf.prim)[both]
    )


def test_occlusion_matches_bruteforce():
    v, f = shapes.cube()
    b = bvh_mod.build(v, f)
    p0 = jnp.array([[0.0, 0.0, -2.0], [0.0, 0.0, 0.5], [2.0, 2.0, 2.0]])
    p1 = jnp.array([[0.0, 0.0, 2.0], [0.0, 0.0, -0.5], [3.0, 3.0, 3.0]])
    blocked = jax.vmap(lambda a, c: bvh_mod.occluded(b, a, c))(p0, p1)
    expected = intersect.occluded(p0, p1, jnp.asarray(v), jnp.asarray(f))
    np.testing.assert_array_equal(np.asarray(blocked), np.asarray(expected))


def test_bunny_scale_build():
    """Larger mesh build + spot-check traversal (the kdbench analog)."""
    v, f = shapes.sphere(radius=1.0, n_theta=32, n_phi=64)  # 4096 tris
    b = bvh_mod.build(v, f)
    assert b.bounds_lo.shape[0] > 100
    o = jnp.array([0.0, 0.0, -3.0])
    d = jnp.array([0.0, 0.0, 1.0])
    t, prim, valid = bvh_mod.intersect(b, o, d)
    assert bool(valid)
    assert abs(float(t) - 2.0) < 1e-2

