"""The fused pair kernel's clustered variant, its wrapper (packing,
padding) and the render entries' choice of kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alvrl_tpu.core import rng
from alvrl_tpu.integrators.vrl import integrate
from alvrl_tpu.integrators.vrl.integrate import VRLConfig
from alvrl_tpu.media import phase as ph
from alvrl_tpu.ops import pair_kernel as pk
from alvrl_tpu.scene import presets
from tests.pair_kernel_utils import BLOCK, assert_close, setup_scene


@pytest.mark.parametrize("g", [0.0, 0.8])
def test_clustered_kernel_matches_reference(g):
    """Each ray sums over its own slice's table row; zero-weight entries
    are invalid; the table width (21) is not a multiple of the tile."""
    cfg = VRLConfig(vrl_chunk=16)
    scene, vrls, rays = setup_scene(g=g)
    s, c = 3, 21
    tv = jax.random.randint(jax.random.key(5), (s, c), 0, vrls.capacity)
    tw = jax.random.uniform(jax.random.key(6), (s, c)).at[:, ::4].set(0.0)
    sl = jax.random.randint(jax.random.key(7), (rays[0].shape[0],), 0, s)
    tab = (vrls.start[tv], vrls.end[tv], vrls.power[tv] * tw[..., None],
           vrls.valid[tv] & (tw > 0))
    seed = rng.seed_bits(jax.random.key(8))
    out = pk.pair_sum_clustered(cfg, scene, *rays, sl, *tab, seed,
                                interpret=True, block=BLOCK)
    ref = integrate.pair_sum(scene, *rays, *(a[sl] for a in tab), seed, cfg)
    assert_close(out, ref)


def test_padding_rows_are_zero():
    """Rays and VRLs padded up to the block shape contribute nothing."""
    cfg = VRLConfig()
    scene, vrls, rays = setup_scene(w=3, h=3, n_vrls=5)
    rows = pk._pad_last(pk.pack_rays(scene, *rays), 16)
    vrl = pk._pad_last(pk.pack_vrls(vrls.start, vrls.end, vrls.power,
                                    vrls.valid), 16)
    assert rows.shape == (pk.RAY_ROWS, 16) and vrl.shape == (pk.VRL_ROWS, 16)
    out = pk._pair_call(rows, None, vrl, pk.pack_medium(scene.medium),
                        pk.pack_tris(scene), jnp.uint32(1), cfg=cfg,
                        phase_kind=0, block=BLOCK, interpret=True)
    assert out.shape == (3, 16)
    assert float(jnp.abs(out[:, 9:]).max()) == 0.0
    assert float(jnp.abs(out[:, :9]).sum()) > 0.0


def test_pack_layout():
    scene, vrls, rays = setup_scene(w=2, h=2, n_vrls=3)
    o, d, hp, hv, hn, hm = rays
    rows = np.asarray(pk.pack_rays(scene, *rays))
    np.testing.assert_array_equal(rows[pk._RO:pk._RO + 3].T, o)
    np.testing.assert_array_equal(rows[pk._HP:pk._HP + 3].T, hp)
    np.testing.assert_array_equal(rows[pk._VALID], np.asarray(hv, float))
    v = np.asarray(pk.pack_vrls(vrls.start, vrls.end, vrls.power,
                                vrls.valid))
    np.testing.assert_array_equal(v[pk._VE:pk._VE + 3].T, vrls.end)
    tri = np.asarray(pk.pack_tris(scene))
    assert tri.shape == (9, scene.faces.shape[0])
    med = np.asarray(pk.pack_medium(scene.medium))
    np.testing.assert_allclose(med[:3], scene.medium.sigma_t)


def _with_material(scene, kind=None, tex_kind=None):
    mats = scene.materials
    if kind is not None:
        mats = mats.replace(kind=mats.kind.at[0].set(kind))
    if tex_kind is not None:
        mats = mats.replace(tex_kind=mats.tex_kind.at[0].set(tex_kind))
    return scene.replace(materials=mats)


def test_kernel_selection():
    from alvrl_tpu.scene.scene import MIRROR, ROUGH_CONDUCTOR

    cfg = VRLConfig()
    scene = presets.cornell_smoke(width=4, height=4)
    assert pk.use_kernel(scene, cfg, "gpu")
    assert not pk.use_kernel(scene, cfg, "cpu")
    assert not pk.use_kernel(scene, VRLConfig(fused_kernel=False), "gpu")
    assert pk.use_kernel(_with_material(scene, kind=MIRROR), cfg, "gpu")
    assert not pk.use_kernel(_with_material(scene, kind=ROUGH_CONDUCTOR),
                             cfg, "gpu")
    assert not pk.use_kernel(_with_material(scene, tex_kind=1), cfg, "gpu")
    ray = scene.replace(medium=scene.medium.replace(phase_kind=ph.RAYLEIGH))
    assert pk.use_kernel(ray, cfg, "gpu")
    mix = scene.replace(medium=scene.medium.replace(phase_kind=ph.MIXTURE))
    assert not pk.use_kernel(mix, cfg, "gpu")
    single = scene.replace(medium=scene.medium.replace(strategy=1))
    assert not pk.use_kernel(single, cfg, "gpu")
    grid = presets.cornell_grid_smoke(width=4, height=4, grid_res=4)
    assert not pk.use_kernel(grid, cfg, "gpu")


def test_kernel_selection_under_jit():
    """The choice reads static data only: a scene traced as a jit
    argument is decided as the concrete one is; a material table built
    from traced kinds has no static record and raises."""
    from alvrl_tpu.scene.scene import ROUGH_CONDUCTOR

    cfg = VRLConfig()
    scene = presets.cornell_smoke(width=4, height=4)
    rough = _with_material(scene, kind=ROUGH_CONDUCTOR)
    seen = []
    for sc in (scene, rough):
        jax.jit(lambda s: seen.append(pk.use_kernel(s, cfg, "gpu")) or 0)(sc)
    assert seen == [True, False]

    def traced_kinds(kind):
        mats = scene.materials.replace(kind=kind)
        assert mats.kind_set is None
        with pytest.raises(ValueError, match="unknown"):
            pk.use_kernel(scene.replace(materials=mats), cfg, "gpu")
        return 0

    jax.jit(traced_kinds)(scene.materials.kind)
