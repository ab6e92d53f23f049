"""Emitter table + sampling.

Counterpart of src/emitters/{point,spot,directional}.cpp as one
struct-of-arrays table with a kind field (the plugin dispatch becomes
masked arithmetic). Area emitters attach to mesh faces and are planned
with the mesh-light sampling records.

Conventions match the reference:
  * point: samplePosition weight = intensity * 4pi (point.cpp:82-89),
    direction uniform sphere, weight 1;
  * spot: uniform-cone direction sampling within cutoffAngle, linear
    falloff between beamWidth and cutoffAngle (spot.cpp), position
    weight = intensity * 2pi(1-cos cutoff) so the product of
    position/direction weights integrates the emitted power;
  * directional: a delta direction; photons start on a disk covering
    the scene bounding sphere, weight = irradiance * pi r^2.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from alvrl_tpu.core import struct

from alvrl_tpu.core import math as m
from alvrl_tpu.core import rng, spectrum, warp
from alvrl_tpu.emitters.envmap import (
    EnvMap, default_envmap, eval_env, pdf_env, sample_env,
)

POINT = 0
SPOT = 1
DIRECTIONAL = 2
AREA = 3       # one triangle per entry (quad lights = 2 entries)
CONSTANT = 4   # constant environment radiance (constant.cpp)
ENVMAP = 5     # lat-long environment texture (envmap.cpp; sky/sun bake
               # into it via emitters.sunsky)
COLLIMATED = 6  # collimated beam: delta position AND delta direction
                # (collimated.cpp:57-127) — radiates `intensity` (the
                # beam power) along the fixed ray (position, direction)


@struct.dataclass
class Emitters:
    kind: jax.Array        # (E,) int32
    position: jax.Array    # (E, 3); AREA: triangle vertex p0
    direction: jax.Array   # (E, 3) unit (spot/directional)
    intensity: jax.Array   # (E, 3) radiant intensity / irradiance /
                           # AREA: emitted radiance
    cos_cutoff: jax.Array  # (E,) spot cutoff cosine
    cos_beam: jax.Array    # (E,) spot full-strength beam cosine
    tri_e1: jax.Array      # (E, 3) AREA: triangle edge p1 - p0
    tri_e2: jax.Array      # (E, 3) AREA: triangle edge p2 - p0
    pmf: jax.Array         # (E,) selection pmf
    env: EnvMap = None     # the (single) environment map, shared by all
                           # ENVMAP entries; zero 1x1 map when unused

    def __post_init__(self):
        if self.env is None:
            object.__setattr__(self, "env", default_envmap())


def make_emitters(kinds, positions, intensities, directions=None,
                  cutoff_deg=None, beam_deg=None, tri_e1=None, tri_e2=None,
                  env: EnvMap = None):
    kinds = jnp.asarray(kinds, jnp.int32).reshape(-1)
    e = kinds.shape[0]
    positions = jnp.asarray(positions, jnp.float32).reshape(e, 3)
    intensities = jnp.asarray(intensities, jnp.float32).reshape(e, 3)
    if directions is None:
        directions = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (e, 1))
    else:
        directions = m.normalize(jnp.asarray(directions, jnp.float32).reshape(e, 3))
    cutoff = jnp.cos(jnp.deg2rad(
        jnp.asarray(cutoff_deg if cutoff_deg is not None else [20.0] * e, jnp.float32)
    ))
    beam = jnp.cos(jnp.deg2rad(
        jnp.asarray(beam_deg if beam_deg is not None else
                    [15.0] * e, jnp.float32)
    ))
    e1 = (jnp.asarray(tri_e1, jnp.float32).reshape(e, 3)
          if tri_e1 is not None else jnp.zeros((e, 3)))
    e2 = (jnp.asarray(tri_e2, jnp.float32).reshape(e, 3)
          if tri_e2 is not None else jnp.zeros((e, 3)))
    if env is None:
        env = default_envmap()
    # power-weighted selection pmf: area emitters weigh by L*pi*A
    # (constant env keeps plain luminance — its power depends on the
    # scene bounds, unknown here); envmap entries use the map's
    # solid-angle-mean radiance luminance
    area = 0.5 * jnp.linalg.norm(jnp.cross(e1, e2), axis=-1)
    lum = spectrum.luminance(intensities)
    lum = jnp.where(kinds == AREA, lum * jnp.pi * jnp.maximum(area, 1e-12),
                    lum)
    lum = jnp.where(kinds == ENVMAP, spectrum.luminance(env.mean), lum)
    pmf = lum / jnp.maximum(jnp.sum(lum), 1e-30)
    return Emitters(
        kind=kinds, position=positions, direction=directions,
        intensity=intensities, cos_cutoff=cutoff, cos_beam=beam,
        tri_e1=e1, tri_e2=e2, pmf=pmf, env=env,
    )


def _spot_falloff(em: Emitters, idx, d):
    """Linear falloff between beamWidth and cutoffAngle (spot.cpp)."""
    cos_d = m.dot(d, em.direction[idx])
    cc = em.cos_cutoff[idx]
    cb = em.cos_beam[idx]
    t = jnp.clip((cos_d - cc) / jnp.maximum(cb - cc, 1e-6), 0.0, 1.0)
    return jnp.where(cos_d < cc, 0.0, t)


def sample_emission(em: Emitters, key, scene_center, scene_radius):
    """Pick an emitter, sample position + direction for a light path.
    Returns (position, direction, weight (3,))."""
    k_sel, k_dir, k_pos = jax.random.split(key, 3)
    idx = jax.random.choice(k_sel, em.pmf.shape[0], p=em.pmf)
    kind = em.kind[idx]
    inten = em.intensity[idx] / em.pmf[idx]

    # point: uniform sphere
    d_sphere = warp.square_to_uniform_sphere(rng.uniform2(k_dir))
    w_point = inten * (4.0 * jnp.pi)

    # spot: uniform cone around the axis
    u2 = rng.uniform2(k_dir)
    cc = em.cos_cutoff[idx]
    cos_t = 1.0 - u2[..., 0] * (1.0 - cc)
    phi = 2.0 * jnp.pi * u2[..., 1]
    local = m.spherical_direction(cos_t, phi)
    axis = em.direction[idx]
    s_f, t_f = m.build_frame(axis)
    d_cone = m.frame_to_world(s_f, t_f, axis, local)
    solid_angle = 2.0 * jnp.pi * (1.0 - cc)
    w_spot = inten * solid_angle * _spot_falloff(em, idx, d_cone)[..., None]

    # directional: disk of radius R behind the scene
    u2b = rng.uniform2(k_pos)
    r = scene_radius * jnp.sqrt(u2b[..., 0])
    phi2 = 2.0 * jnp.pi * u2b[..., 1]
    axis_d = em.direction[idx]
    s2, t2 = m.build_frame(axis_d)
    disk = (
        scene_center
        - axis_d * scene_radius * 1.5
        + s2 * (r * jnp.cos(phi2))[..., None]
        + t2 * (r * jnp.sin(phi2))[..., None]
    )
    area = jnp.pi * scene_radius * scene_radius
    w_dir = inten * area

    # area: uniform point on the triangle + cosine direction about the
    # face normal (area.cpp semantics): weight = L * pi * A
    ua, ub = rng.uniform(k_pos), rng.uniform(k_dir)
    su = jnp.sqrt(jnp.clip(ua, 1e-9, 1.0))
    b0 = 1.0 - su
    b1 = ub * su
    tri_p = (
        em.position[idx] + b0 * em.tri_e1[idx] + b1 * em.tri_e2[idx]
    )
    n_face = m.normalize(jnp.cross(em.tri_e1[idx], em.tri_e2[idx]))
    local = warp.square_to_cosine_hemisphere(rng.uniform2(k_dir))
    s_a, t_a = m.build_frame(n_face)
    d_area = m.frame_to_world(s_a, t_a, n_face, local)
    area = 0.5 * jnp.linalg.norm(
        jnp.cross(em.tri_e1[idx], em.tri_e2[idx])
    )
    w_area = inten * (jnp.pi * area)

    # constant env: emit from the bounding sphere inward — position
    # uniform on the sphere, direction cosine-weighted about the inward
    # normal; power = L * pi * (4 pi R^2) (constant.cpp emission)
    u_env = rng.uniform2(k_pos)
    n_out = warp.square_to_uniform_sphere(u_env)
    p_env = scene_center + scene_radius * 1.05 * n_out
    s_e, t_e = m.build_frame(-n_out)
    local_e = warp.square_to_cosine_hemisphere(rng.uniform2(k_dir))
    d_env = m.frame_to_world(s_e, t_e, -n_out, local_e)
    w_env = inten * (
        jnp.pi * 4.0 * jnp.pi * (1.05 * scene_radius) ** 2
    )

    # envmap: importance-sample the arrival direction from the map, then
    # a point on a disk of radius R perpendicular to it outside the
    # scene; photon power = L(d)/pdf(d) * pi R^2 (envmap.cpp emission)
    d_map, pdf_map, l_map = sample_env(em.env, rng.uniform2(k_dir))
    u2m = rng.uniform2(k_pos)
    r_m = scene_radius * jnp.sqrt(u2m[..., 0])
    phi_m = 2.0 * jnp.pi * u2m[..., 1]
    s_m, t_m = m.build_frame(d_map)
    p_map = (
        scene_center
        + d_map * scene_radius * 1.5
        + s_m * (r_m * jnp.cos(phi_m))[..., None]
        + t_m * (r_m * jnp.sin(phi_m))[..., None]
    )
    w_map = (
        l_map / jnp.maximum(pdf_map, 1e-30)[..., None]
        * (jnp.pi * scene_radius * scene_radius)
        / em.pmf[idx]
    )

    # collimated: both position and direction are deltas — the photon
    # starts at the emitter position along its axis carrying the full
    # beam power (sampleRay, collimated.cpp:117-126)
    w_coll = inten

    is_area = kind == AREA
    is_env = kind == CONSTANT
    is_map = kind == ENVMAP
    pos = jnp.where(
        (kind == DIRECTIONAL)[..., None], disk,
        jnp.where(is_area[..., None], tri_p,
                  jnp.where(is_env[..., None], p_env,
                            jnp.where(is_map[..., None], p_map,
                                      em.position[idx]))),
    )
    d = jnp.where(
        (kind == POINT)[..., None], d_sphere,
        jnp.where((kind == SPOT)[..., None], d_cone,
                  jnp.where(is_area[..., None], d_area,
                            jnp.where(is_env[..., None], d_env,
                                      jnp.where(is_map[..., None], -d_map,
                                                axis_d)))),
    )
    weight = jnp.where(
        (kind == POINT)[..., None], w_point,
        jnp.where((kind == SPOT)[..., None], w_spot,
                  jnp.where(is_area[..., None], w_area,
                            jnp.where(is_env[..., None], w_env,
                                      jnp.where(is_map[..., None], w_map,
                                                jnp.where(
                                                    (kind == COLLIMATED)[..., None],
                                                    w_coll, w_dir))))),
    )
    return pos, d, weight


def nee(em: Emitters, key, p, scene_radius):
    """Direct sampling toward the emitters from point p.
    Returns (direction (3,), unattenuated value (3,), distance)."""
    u3 = rng.uniform(key, (3,))
    return nee_u(em, u3, p, scene_radius)


def nee_u(em: Emitters, u3, p, scene_radius):
    """Explicit-uniform NEE (u3: (3,) = emitter select + 2D) — the
    primary-sample-space entry point (pssmlt owns the uniforms)."""
    cdf = jnp.cumsum(em.pmf)
    idx = jnp.clip(
        jnp.searchsorted(cdf, u3[0] * cdf[-1], side="left"),
        0, em.pmf.shape[0] - 1,
    )
    uv = u3[1:3]
    kind = em.kind[idx]
    inten = em.intensity[idx] / em.pmf[idx]

    delta = em.position[idx] - p
    dist2 = jnp.maximum(m.length_sq(delta), 1e-12)
    dist = jnp.sqrt(dist2)
    dirn = delta / dist[..., None]
    v_point = inten / dist2[..., None]
    v_spot = v_point * _spot_falloff(em, idx, -dirn)[..., None]

    # directional: pseudo-source far along -direction
    d_dir = -em.direction[idx]
    dist_dir = 2.0 * scene_radius
    v_dir = inten

    # area: uniform point on the triangle, pdf 1/A in area measure;
    # value = L * cos(face) * A / r^2 (solid-angle conversion)
    su = jnp.sqrt(jnp.clip(uv[..., 0], 1e-9, 1.0))
    b0 = 1.0 - su
    b1 = uv[..., 1] * su
    tri_p = em.position[idx] + b0 * em.tri_e1[idx] + b1 * em.tri_e2[idx]
    n_face = m.normalize(jnp.cross(em.tri_e1[idx], em.tri_e2[idx]))
    area = 0.5 * jnp.linalg.norm(jnp.cross(em.tri_e1[idx], em.tri_e2[idx]))
    d_a = tri_p - p
    r2_a = jnp.maximum(m.length_sq(d_a), 1e-12)
    dist_a = jnp.sqrt(r2_a)
    dir_a = d_a / dist_a[..., None]
    cos_face = jnp.maximum(m.dot(n_face, -dir_a), 0.0)
    v_area = inten * (cos_face * area / r2_a)[..., None]

    # constant env NEE: uniform-sphere direction, value = L / pdf
    # = L * 4 pi (MIS-free single-strategy estimator)
    d_env = warp.square_to_uniform_sphere(uv)
    v_env = inten * (4.0 * jnp.pi)
    dist_env = 2.5 * scene_radius

    # envmap NEE: importance-sample the map; value = L(d)/pdf(d)
    d_map, pdf_map, l_map = sample_env(em.env, uv)
    v_map = l_map / (jnp.maximum(pdf_map, 1e-30)[..., None] * em.pmf[idx])

    is_dir = kind == DIRECTIONAL
    is_area = kind == AREA
    is_env = kind == CONSTANT
    is_map = kind == ENVMAP
    out_d = jnp.where(
        is_dir[..., None], d_dir,
        jnp.where(is_area[..., None], dir_a,
                  jnp.where(is_env[..., None], d_env,
                            jnp.where(is_map[..., None], d_map, dirn))),
    )
    out_v = jnp.where(
        (kind == POINT)[..., None], v_point,
        jnp.where((kind == SPOT)[..., None], v_spot,
                  jnp.where(is_area[..., None], v_area,
                            jnp.where(is_env[..., None], v_env,
                                      jnp.where(is_map[..., None], v_map,
                                                v_dir)))),
    )
    # collimated: direct sampling of a 0-dimensional response always
    # fails (sampleDirect returns pdf 0, collimated.cpp:128-132)
    out_v = jnp.where((kind == COLLIMATED)[..., None], 0.0, out_v)
    out_dist = jnp.where(
        is_dir, dist_dir,
        jnp.where(is_area, dist_a,
                  jnp.where(is_env | is_map, dist_env, dist)),
    )
    return out_d, out_v, out_dist


def nee_u_pdf(em: Emitters, u3, p, scene_radius):
    """nee_u + the solid-angle pdf of the drawn sample and whether the
    chosen emitter is MIS-able (area/env kinds BSDF sampling can also
    reach; delta kinds return pdf 0). Returns (dir, val, dist, pdf_sa,
    misable) — the quantities volpath's multiple importance sampling
    needs (the reference's miWeight over sampleEmitterDirect)."""
    cdf = jnp.cumsum(em.pmf)
    idx = jnp.clip(
        jnp.searchsorted(cdf, u3[0] * cdf[-1], side="left"),
        0, em.pmf.shape[0] - 1,
    )
    out_d, out_v, out_dist = nee_u(em, u3, p, scene_radius)
    kind = em.kind[idx]
    pmf = em.pmf[idx]
    # area: pdf_sa = pmf * r^2 / (cos_face * A)
    r2 = jnp.maximum(out_dist * out_dist, 1e-12)
    n_face = m.normalize(jnp.cross(em.tri_e1[idx], em.tri_e2[idx]))
    area = jnp.maximum(
        0.5 * jnp.linalg.norm(jnp.cross(em.tri_e1[idx], em.tri_e2[idx])),
        1e-12)
    cos_face = jnp.maximum(m.dot(n_face, -out_d), 1e-6)
    pdf_area = pmf * r2 / (cos_face * area)
    pdf_const = pmf / (4.0 * jnp.pi)
    pdf_map = pmf * pdf_env(em.env, out_d)
    is_area = kind == AREA
    is_env = kind == CONSTANT
    is_map = kind == ENVMAP
    pdf_sa = jnp.where(is_area, pdf_area,
                       jnp.where(is_env, pdf_const,
                                 jnp.where(is_map, pdf_map, 0.0)))
    misable = is_area | is_env | is_map
    return out_d, out_v, out_dist, pdf_sa, misable


def hit_emitter_nee_pdf(em: Emitters, emit_id, dist, cos_face):
    """Solid-angle pdf with which NEE would have generated the segment
    that just HIT area emitter `emit_id` at distance `dist` with facing
    cosine `cos_face` (the other half of the MIS pair)."""
    i = jnp.maximum(emit_id, 0)
    area = jnp.maximum(
        0.5 * jnp.linalg.norm(jnp.cross(em.tri_e1[i], em.tri_e2[i]),
                              axis=-1), 1e-12)
    return em.pmf[i] * jnp.maximum(dist * dist, 1e-12) / (
        jnp.maximum(cos_face, 1e-6) * area)


def env_nee_pdf(em: Emitters, d):
    """Total solid-angle pdf of NEE generating escape direction d
    through the environment emitters (sum over CONSTANT + ENVMAP
    entries weighted by their selection pmf)."""
    p_const = jnp.sum(
        jnp.where(em.kind == CONSTANT, em.pmf, 0.0)) / (4.0 * jnp.pi)
    p_map = jnp.sum(jnp.where(em.kind == ENVMAP, em.pmf, 0.0)) \
        * pdf_env(em.env, d)
    return p_const + p_map


def env_radiance(em: Emitters, d):
    """Environment radiance seen by a ray escaping in direction d:
    constant emitters plus the environment map (zero when absent).
    Counterpart of Scene::evalEnvironment."""
    const_l = jnp.sum(
        jnp.where((em.kind == CONSTANT)[:, None], em.intensity, 0.0),
        axis=0,
    )
    return const_l + eval_env(em.env, d)
