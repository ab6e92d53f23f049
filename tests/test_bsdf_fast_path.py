"""The BSDF dispatch's short paths for Lambertian-and-delta material
tables against the full dispatch, and the static record of material kinds
they (and the pair kernel's selection) read."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alvrl_tpu.bsdf import api
from alvrl_tpu.core import math as m
from alvrl_tpu.scene import presets
from alvrl_tpu.scene.scene import (
    DIELECTRIC, DIFFUSE, MIRROR, NULL, ROUGH_CONDUCTOR, make_materials)
from alvrl_tpu.textures.procedural import TEX_CHECKER, TEX_NONE

N = 512


def _scenes(textured):
    kinds = [DIFFUSE, NULL, MIRROR, DIELECTRIC, DIFFUSE]
    tex = [TEX_NONE] * 4 + [TEX_CHECKER if textured else TEX_NONE]
    mats = make_materials(
        kinds, [[0.7, 0.5, 0.3], [1, 1, 1], [0.9, 0.9, 0.9], [1, 1, 1],
                [0.2, 0.6, 0.4]],
        etas=[1.0, 1.0, 1.0, 1.5, 1.0], tex_kinds=tex,
        tex_scales=[1.0, 1.0, 1.0, 1.0, 4.0],
        albedo2=[[0.0] * 3] * 4 + [[0.9, 0.1, 0.1]])
    scene = presets.cornell_smoke(width=4, height=4).replace(materials=mats)
    # the same table with a kind record that admits a rough conductor:
    # the full dispatch
    full = scene.replace(materials=dataclasses.replace(
        mats, kind_set=mats.kind_set + ((ROUGH_CONDUCTOR, TEX_NONE),)))
    assert api.lambert_delta_only(scene)
    assert not api.lambert_delta_only(full)
    return scene, full


def _inputs():
    k = jax.random.split(jax.random.key(0), 7)
    unit = lambda kk: m.normalize(jax.random.normal(kk, (N, 3)))
    return dict(
        mat_id=jax.random.randint(k[0], (N,), 0, 5),
        ng=unit(k[1]), ng_raw=unit(k[2]), wi=unit(k[3]), wo=unit(k[4]),
        p=jax.random.uniform(k[5], (N, 3), minval=-1.0, maxval=1.0),
        u=jax.random.uniform(k[6], (N, api.N_SAMPLE_DIMS)),
    )


def _close(a, b):
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(np.asarray(x, np.float32),
                                   np.asarray(y, np.float32),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("textured", [False, True])
def test_eval_and_pdf_match_full_dispatch(textured):
    x = _inputs()
    out = []
    for sc in _scenes(textured):
        out.append((
            api.eval_smooth(sc, x["mat_id"], x["ng"], x["wi"], x["wo"]),
            api.eval_smooth(sc, x["mat_id"], x["ng"], x["wi"], x["wo"],
                            p_world=x["p"]),
            api.pdf_smooth(sc, x["mat_id"], x["ng"], x["wi"], x["wo"]),
        ))
    assert float(jnp.abs(out[0][1]).sum()) > 0
    _close(*out)


@pytest.mark.parametrize("mode", ["radiance", "importance"])
@pytest.mark.parametrize("textured", [False, True])
def test_sample_matches_full_dispatch(mode, textured):
    x = _inputs()
    out = [api.sample_from_uniforms(sc, x["u"], x["mat_id"], x["ng"],
                                    x["ng_raw"], -x["wi"], x["p"],
                                    mode=mode)
           for sc in _scenes(textured)]
    assert bool(out[0].is_delta.any()) and bool(out[0].is_smooth.any())
    _close(*out)


def test_kind_set_recorded_and_static():
    scene, _ = _scenes(textured=True)
    mats = scene.materials
    assert mats.kinds() == {DIFFUSE, NULL, MIRROR, DIELECTRIC}
    assert (DIFFUSE, TEX_CHECKER) in mats.kind_set
    # replacing the kinds records them anew; other fields keep the record
    rough = mats.replace(kind=mats.kind.at[0].set(ROUGH_CONDUCTOR))
    assert ROUGH_CONDUCTOR in rough.kinds()
    assert mats.replace(albedo=mats.albedo * 0.5).kind_set == mats.kind_set
    # the record is static: it reaches a jitted function unchanged
    seen = []
    jax.jit(lambda s: seen.append(s.materials.kind_set) or 0)(scene)
    assert seen == [mats.kind_set]
    # and is unknown for kinds that are traced
    jax.jit(lambda k: seen.append(mats.replace(kind=k).kinds()) or 0)(
        mats.kind)
    assert seen[-1] is None
