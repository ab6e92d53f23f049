"""Environment map emitter: lat-long radiance texture with exact
luminance-proportional importance sampling.

Counterpart of src/emitters/envmap.cpp (an EXR lat-long map wrapped on
the scene bounding sphere, importance-sampled from a luminance
distribution). Array-native design: the map and its sampling tables are
plain arrays; sampling is two CDF inversions (row, then column) via
`searchsorted`, uniform within the chosen texel, so the solid-angle pdf
is piecewise constant and *exactly* consistent with `eval` (which uses
nearest-texel lookup). The reference bilinearly filters and corrects the
pdf accordingly (envmap.cpp); we trade that for exact eval/pdf
consistency — the estimator stays unbiased for the map as loaded.

Direction convention (y-up, matching the repo's scenes):
  theta = acos(d.y) in [0, pi]   -> row v = theta / pi
  phi = atan2(-d.z, d.x) + azimuth, in [-pi, pi] -> col u = phi / 2pi + 0.5
Row 0 is the +y pole (theta = 0), matching a lat-long image whose top is
"up".
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from alvrl_tpu.core import struct

from alvrl_tpu.core import spectrum

_TWO_PI = 2.0 * np.pi


@struct.dataclass
class EnvMap:
    image: jax.Array     # (H, W, 3) radiance (scale premultiplied)
    row_cdf: jax.Array   # (H,) CDF over rows of sin-weighted luminance
    cond_cdf: jax.Array  # (H, W) per-row CDF over columns
    pdf_map: jax.Array   # (H, W) solid-angle pdf of sampling each texel
    mean: jax.Array      # (3,) mean radiance over the sphere
    azimuth: jax.Array   # () rotation around +y (radians)


def make_envmap(image, scale=1.0, azimuth_deg=0.0) -> EnvMap:
    """Build the sampling tables. image: (H, W, 3) float radiance."""
    img = np.asarray(image, np.float32) * np.float32(scale)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    h, w = img.shape[:2]
    # sin(theta) weight at the texel center row
    theta_c = (np.arange(h) + 0.5) / h * np.pi
    sin_w = np.sin(theta_c).astype(np.float32)
    lum = np.asarray(spectrum.luminance(jnp.asarray(img)))
    lum = np.maximum(lum, 0.0)
    weighted = lum * sin_w[:, None] + 1e-12  # strictly positive: every
    # texel keeps nonzero sample probability, so pdf>0 wherever L>=0
    row_w = weighted.sum(axis=1)
    row_cdf = np.cumsum(row_w)
    total = row_cdf[-1]
    row_cdf = row_cdf / total
    cond_cdf = np.cumsum(weighted, axis=1)
    cond_cdf = cond_cdf / cond_cdf[:, -1:]
    # texel solid angle: (cos t0 - cos t1) * (2pi / W)
    t0 = np.arange(h) / h * np.pi
    t1 = (np.arange(h) + 1) / h * np.pi
    omega = ((np.cos(t0) - np.cos(t1)) * (_TWO_PI / w)).astype(np.float32)
    p_texel = weighted / total
    pdf_map = p_texel / np.maximum(omega[:, None], 1e-12)
    # solid-angle-weighted mean radiance: sum(L * omega) / 4pi
    mean = (img * omega[:, None, None]).sum(axis=(0, 1)) / (4.0 * np.pi)
    return EnvMap(
        image=jnp.asarray(img),
        row_cdf=jnp.asarray(row_cdf.astype(np.float32)),
        cond_cdf=jnp.asarray(cond_cdf.astype(np.float32)),
        pdf_map=jnp.asarray(pdf_map.astype(np.float32)),
        mean=jnp.asarray(mean.astype(np.float32)),
        azimuth=jnp.float32(np.deg2rad(azimuth_deg)),
    )


def default_envmap() -> EnvMap:
    """1x1 zero map — the no-envmap placeholder (eval returns 0)."""
    return make_envmap(np.zeros((1, 1, 3), np.float32))


def _dir_to_uv(env: EnvMap, d):
    """Unit direction -> continuous (v, u) in [0,1)^2 (y-up lat-long)."""
    ct = jnp.clip(d[..., 1], -1.0, 1.0)
    theta = jnp.arccos(ct)
    phi = jnp.arctan2(-d[..., 2], d[..., 0]) - env.azimuth
    u = phi / _TWO_PI + 0.5
    u = u - jnp.floor(u)
    v = theta / jnp.pi
    return v, u


def eval_env(env: EnvMap, d):
    """Radiance arriving from direction d (pointing AT the environment).
    Nearest-texel lookup, consistent with pdf_env."""
    h, w = env.image.shape[:2]
    v, u = _dir_to_uv(env, d)
    row = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    col = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    return env.image[row, col]


def pdf_env(env: EnvMap, d):
    """Solid-angle pdf of sample_env producing direction d."""
    h, w = env.image.shape[:2]
    v, u = _dir_to_uv(env, d)
    row = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    col = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    return env.pdf_map[row, col]


def sample_env(env: EnvMap, u2):
    """Importance-sample a direction ~ luminance * sin(theta).

    Scalar sample (u2: (2,)); vmap for batches. Returns (d (3,) pointing
    AT the environment, pdf (), radiance (3,)). Two CDF inversions +
    uniform jitter inside the texel, so pdf is exactly pdf_env(d)."""
    h, w = env.image.shape[:2]
    u_row, u_col = u2[0], u2[1]
    row = jnp.clip(
        jnp.searchsorted(env.row_cdf, u_row, side="left"), 0, h - 1
    )
    # re-standardize the uniforms inside their CDF cells for the jitter
    lo_r = jnp.where(row > 0, env.row_cdf[jnp.maximum(row - 1, 0)], 0.0)
    fr = jnp.clip(
        (u_row - lo_r) / jnp.maximum(env.row_cdf[row] - lo_r, 1e-12),
        0.0, 1.0 - 1e-6,
    )
    cdf_row = env.cond_cdf[row]
    col = jnp.clip(jnp.searchsorted(cdf_row, u_col, side="left"), 0, w - 1)
    lo_c = jnp.where(col > 0, cdf_row[jnp.maximum(col - 1, 0)], 0.0)
    fc = jnp.clip(
        (u_col - lo_c) / jnp.maximum(cdf_row[col] - lo_c, 1e-12),
        0.0, 1.0 - 1e-6,
    )
    # uniform in solid angle within the texel: cos(theta) uniform on the
    # texel's [cos t1, cos t0] range (so pdf == p_texel / omega_texel
    # exactly), phi uniform
    ct0 = jnp.cos(row / h * jnp.pi)
    ct1 = jnp.cos((row + 1) / h * jnp.pi)
    ct = ct0 + fr * (ct1 - ct0)
    theta = jnp.arccos(jnp.clip(ct, -1.0, 1.0))
    phi = ((col + fc) / w - 0.5) * _TWO_PI + env.azimuth
    st = jnp.sin(theta)
    d = jnp.stack(
        [st * jnp.cos(phi), jnp.cos(theta), -st * jnp.sin(phi)], axis=-1
    )
    pdf = env.pdf_map[row, col]
    return d, pdf, env.image[row, col]
