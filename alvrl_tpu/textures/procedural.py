"""Textures modulating surface albedo: world-space procedural fields
(checkerboard, gridtexture, value noise) and UV-mapped bitmaps.

Counterpart of src/textures/ (checkerboard.cpp, gridtexture.cpp,
bitmap.cpp). Procedural kinds are parameterized over world position;
TEX_BITMAP samples the scene's texture stack bilinearly at the
mesh-interpolated UV (shapes carry per-face-corner UVs: analytic
parameterizations for rectangle/cube/sphere, `vt` records for OBJ).
Evaluated inside the BSDF gathers: `albedo_at(scene, mat_id, p, uv)`
replaces raw albedo table lookups.
"""

from __future__ import annotations

import jax.numpy as jnp

TEX_NONE = 0
TEX_CHECKER = 1
TEX_GRID = 2
TEX_NOISE = 3
TEX_BITMAP = 4


def interp_uv(face_uv, prim, bary):
    """Interpolate per-face-corner UVs at a hit: (1-u-v, u, v) weights.
    face_uv: (T, 3, 2); prim: (...) i32; bary: (..., 2)."""
    fuv = face_uv[jnp.maximum(prim, 0)]  # (..., 3, 2)
    u, v = bary[..., 0], bary[..., 1]
    w0 = (1.0 - u - v)[..., None]
    return fuv[..., 0, :] * w0 + fuv[..., 1, :] * u[..., None] \
        + fuv[..., 2, :] * v[..., None]


def bitmap_lookup(textures, tex_id, uv):
    """Bilinear sample of textures[tex_id] at uv in [0,1)^2 (wrapped).
    textures: (K, H, W, 3); v runs top-down (image rows)."""
    k, h, w = textures.shape[0], textures.shape[1], textures.shape[2]
    tid = jnp.clip(tex_id, 0, k - 1)
    u = uv[..., 0] - jnp.floor(uv[..., 0])
    v = uv[..., 1] - jnp.floor(uv[..., 1])
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0w = jnp.mod(x0, w)
    x1w = jnp.mod(x0 + 1, w)
    y0c = jnp.clip(y0, 0, h - 1)
    y1c = jnp.clip(y0 + 1, 0, h - 1)
    # joint (texture, row, col) gather: broadcasts for batched tex_id
    # (per-lane scalar indexing under vmap also lowers to this)
    tid = jnp.broadcast_to(tid, y0c.shape)
    c00 = textures[tid, y0c, x0w]
    c01 = textures[tid, y0c, x1w]
    c10 = textures[tid, y1c, x0w]
    c11 = textures[tid, y1c, x1w]
    return ((c00 * (1 - fx) + c01 * fx) * (1 - fy)
            + (c10 * (1 - fx) + c11 * fx) * fy)


def _hash3(ip):
    """Integer lattice hash -> [0,1) (value noise)."""
    h = (
        ip[..., 0] * jnp.int32(374761393)
        + ip[..., 1] * jnp.int32(668265263)
        + ip[..., 2] * jnp.int32(1440662683)
    )
    h = (h ^ (h >> 13)) * jnp.int32(1274126177)
    h = h ^ (h >> 16)
    return (h & 0x7FFFFF).astype(jnp.float32) / jnp.float32(0x800000)


def value_noise(p):
    """Trilinear value noise over the unit lattice."""
    ip = jnp.floor(p).astype(jnp.int32)
    fp = p - jnp.floor(p)
    w = fp * fp * (3.0 - 2.0 * fp)  # smoothstep

    def corner(dx, dy, dz):
        return _hash3(ip + jnp.asarray([dx, dy, dz], jnp.int32))

    c000, c100 = corner(0, 0, 0), corner(1, 0, 0)
    c010, c110 = corner(0, 1, 0), corner(1, 1, 0)
    c001, c101 = corner(0, 0, 1), corner(1, 0, 1)
    c011, c111 = corner(0, 1, 1), corner(1, 1, 1)
    x00 = c000 * (1 - w[..., 0]) + c100 * w[..., 0]
    x10 = c010 * (1 - w[..., 0]) + c110 * w[..., 0]
    x01 = c001 * (1 - w[..., 0]) + c101 * w[..., 0]
    x11 = c011 * (1 - w[..., 0]) + c111 * w[..., 0]
    y0 = x00 * (1 - w[..., 1]) + x10 * w[..., 1]
    y1 = x01 * (1 - w[..., 1]) + x11 * w[..., 1]
    return y0 * (1 - w[..., 2]) + y1 * w[..., 2]


def checker(p, scale):
    ip = jnp.floor(p * scale[..., None]).astype(jnp.int32)
    return ((ip[..., 0] + ip[..., 1] + ip[..., 2]) & 1).astype(jnp.float32)


def grid_lines(p, scale, line_width=0.08):
    fp = p * scale[..., None] - jnp.floor(p * scale[..., None])
    near = jnp.minimum(fp, 1.0 - fp)
    on_line = jnp.min(near, axis=-1) < line_width
    return on_line.astype(jnp.float32)


def albedo_at(scene, mat_id, p, uv=None):
    """Albedo of material `mat_id` at world position p (procedural
    kinds mix albedo/albedo2 by the texture value); with `uv` given
    (interp_uv at the hit), TEX_BITMAP materials multiply the base
    albedo by the bilinear bitmap sample. Falls back to the plain table
    when the scene's materials carry no texture fields (back-compat)."""
    mats = scene.materials
    base = mats.albedo[mat_id]
    if not hasattr(mats, "tex_kind") or mats.tex_kind is None:
        return base
    kind_set = getattr(mats, "kind_set", None)
    if kind_set is not None and all(t == TEX_NONE for _, t in kind_set):
        return base  # no textured material (static)
    kind = mats.tex_kind[mat_id]
    scale = mats.tex_scale[mat_id]
    alb2 = mats.albedo2[mat_id]
    t_checker = checker(p, scale)
    t_grid = grid_lines(p, scale)
    t_noise = value_noise(p * scale[..., None])
    t = jnp.where(
        kind == TEX_CHECKER, t_checker,
        jnp.where(kind == TEX_GRID, t_grid,
                  jnp.where(kind == TEX_NOISE, t_noise, 0.0)),
    )
    out = base * (1.0 - t[..., None]) + alb2 * t[..., None]
    if uv is not None and hasattr(scene, "textures"):
        tex = bitmap_lookup(
            scene.textures, getattr(mats, "tex_id", None)[mat_id]
            if getattr(mats, "tex_id", None) is not None else 0,
            uv * scale[..., None],
        )
        out = jnp.where((kind == TEX_BITMAP)[..., None], base * tex, out)
    return out
