"""Scene = a pytree of arrays.

Replaces the reference's Scene object graph + plugin registry
(src/librender/scene.cpp, PluginManager): everything a render function
needs is flattened into this immutable dataclass so the whole renderer is
a jit-compiled pure function of (scene, params, key).

Materials are a struct-of-arrays table indexed by per-face material id —
the plugin dispatch of the reference (BSDF subclasses) becomes masked
arithmetic over the material kind.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from alvrl_tpu.core import struct

from alvrl_tpu.emitters.emitters import Emitters
from alvrl_tpu.media.homogeneous import HomogeneousMedium

# Material kinds (BSDF plugin equivalents, src/bsdfs/)
DIFFUSE = 0   # smooth Lambertian (diffuse.cpp; twosided.cpp is implied —
              # shading frames orient toward the incident ray)
NULL = 1      # transparent boundary enclosing media (null.cpp)
MIRROR = 2    # ideal specular conductor (conductor.cpp, delta)
DIELECTRIC = 3  # smooth dielectric (dielectric.cpp, delta)
ROUGH_CONDUCTOR = 4  # GGX microfacet conductor (roughconductor.cpp)
ROUGH_PLASTIC = 5    # GGX coat over Lambertian (roughplastic.cpp)
PHONG = 6     # modified Phong: diffuse + cos^n lobe (phong.cpp)
WARD = 7      # anisotropic Ward gaussian (ward.cpp 'balanced')
DIFFTRANS = 8 # diffuse transmission (difftrans.cpp)
PLASTIC = 9   # smooth dielectric coat over Lambert (plastic.cpp)
MASK = 10     # opacity mask over a nested BSDF (mask.cpp)
MIXTURE = 11  # two-component convex mixture (mixturebsdf/blendbsdf.cpp)
COATING = 12  # smooth dielectric layer over `nested` (coating.cpp):
              # eta = coat IOR, albedo2 = coat sigma_a, exponent = coat
              # thickness
NORMALMAP = 13  # tangent-space normal texture (tex_id) shading the
                # `nested` material (normalmap.cpp; bumpmap.cpp height
                # fields are baked to normal maps by the loader)
HK = 14       # Hanrahan-Krueger single-scattering slab (hk.cpp):
              # albedo = sigma_s, albedo2 = sigma_a, exponent =
              # thickness, alpha = HG phase mean cosine
IRAWAN = 15   # Irawan-Marschner woven cloth (irawan.cpp); the weave
              # pattern lives in Scene.weave (bsdf/irawan.py)
ROUGH_DIELECTRIC = 16  # microfacet refraction (roughdielectric.cpp):
                       # glossy reflection + transmission lobes
ROUGH_COATING = 17     # rough dielectric layer over `nested`
                       # (roughcoating.cpp): glossy coat reflection +
                       # rough-transmittance-attenuated nested BSDF


@struct.dataclass
class Materials:
    kind: jax.Array      # (M,) int32
    albedo: jax.Array    # (M, 3) diffuse reflectance / specular tint / F0
    eta: jax.Array       # (M,) ior for dielectrics (1.0 otherwise)
    alpha: jax.Array     # (M,) GGX/Ward-u roughness for rough kinds
    tex_kind: jax.Array  # (M,) texture kind (textures.procedural.TEX_*)
    tex_scale: jax.Array # (M,) texture frequency in world units
    albedo2: jax.Array   # (M, 3) secondary color for textured materials
    specular: jax.Array  # (M, 3) phong/ward specular reflectance
    exponent: jax.Array  # (M,) phong exponent
    alpha_v: jax.Array   # (M,) ward second-axis roughness
    opacity: jax.Array   # (M,) mask opacity / mixture first-lobe weight
    nested: jax.Array    # (M,) int32: nested material id (mask/mixture);
                         # nesting depth 1, leaf kinds only
    nested2: jax.Array   # (M,) int32: mixture second nested id
    tex_id: jax.Array = None  # (M,) int32 index into scene.textures
                              # (used when tex_kind == TEX_BITMAP)
    dist: jax.Array = None    # (M,) int32 microfacet distribution for
                              # rough kinds (bsdf.microfacet.MF_*);
                              # default GGX. The reference's XML default
                              # is Beckmann (microfacet.h:99-107) — the
                              # XML converter sets it explicitly.
    rt_table: jax.Array = None  # (M, 16, 8) rough-transmittance tables
                                # (ROUGH_COATING; zeros otherwise) —
                                # counterpart of the reference's
                                # data/microfacet tables + rdielprec
    rt_alpha_max: jax.Array = None  # (M,) the alpha span each table was
                                    # built over: max(0.5, material
                                    # alpha), so alpha > 0.5 coatings
                                    # interpolate instead of clamping to
                                    # the 0.5 row (ADVICE r03 item 3)
    # static: the distinct (kind, tex_kind) pairs of the table, recorded
    # while the table is concrete (None when built from traced arrays).
    # It survives jit, so the BSDF dispatch and the pair-kernel choice
    # can depend on which material kinds exist.
    kind_set: tuple = struct.field(pytree_node=False, default=None)

    def __post_init__(self):
        if self.kind_set is None:
            object.__setattr__(self, "kind_set",
                               _kind_set(self.kind, self.tex_kind))

    def replace(self, **updates):
        if "kind" in updates or "tex_kind" in updates:
            updates.setdefault("kind_set", None)  # recorded anew
        return dataclasses.replace(self, **updates)

    def kinds(self):
        """frozenset of the material kinds in the table, None if unknown."""
        if self.kind_set is None:
            return None
        return frozenset(k for k, _ in self.kind_set)


def _kind_set(kind, tex_kind):
    try:
        k = np.asarray(kind).reshape(-1)
        t = (np.zeros_like(k) if tex_kind is None
             else np.asarray(tex_kind).reshape(-1))
    except jax.errors.TracerArrayConversionError:
        return None
    if k.dtype.kind not in "iu" or t.dtype.kind not in "iu" \
            or k.shape != t.shape:
        return None
    return tuple(sorted({(int(a), int(b)) for a, b in zip(k, t)}))


def make_materials(kinds, albedos, etas=None, alphas=None,
                   tex_kinds=None, tex_scales=None, albedo2=None,
                   specular=None, exponent=None, alpha_v=None,
                   opacity=None, nested=None, nested2=None, tex_id=None,
                   dist=None):
    kinds = jnp.asarray(kinds, jnp.int32).reshape(-1)
    n = kinds.shape[0]
    alphas_a = jnp.asarray(
        alphas if alphas is not None else [0.1] * n, jnp.float32)
    return Materials(
        kind=kinds,
        albedo=jnp.asarray(albedos, jnp.float32).reshape(n, 3),
        eta=jnp.asarray(
            etas if etas is not None else [1.0] * n, jnp.float32),
        alpha=alphas_a,
        tex_kind=jnp.asarray(
            tex_kinds if tex_kinds is not None else [0] * n, jnp.int32),
        tex_scale=jnp.asarray(
            tex_scales if tex_scales is not None else [1.0] * n, jnp.float32),
        albedo2=jnp.asarray(
            albedo2 if albedo2 is not None else [[0.0] * 3] * n,
            jnp.float32).reshape(n, 3),
        specular=jnp.asarray(
            specular if specular is not None else [[0.2] * 3] * n,
            jnp.float32).reshape(n, 3),
        exponent=jnp.asarray(
            exponent if exponent is not None else [30.0] * n, jnp.float32),
        alpha_v=(jnp.asarray(alpha_v, jnp.float32)
                 if alpha_v is not None else alphas_a),
        opacity=jnp.asarray(
            opacity if opacity is not None else [1.0] * n, jnp.float32),
        nested=jnp.asarray(
            nested if nested is not None else [0] * n, jnp.int32),
        nested2=jnp.asarray(
            nested2 if nested2 is not None else [0] * n, jnp.int32),
        tex_id=jnp.asarray(
            tex_id if tex_id is not None else [0] * n, jnp.int32),
        dist=jnp.asarray(
            dist if dist is not None else [1] * n, jnp.int32),  # MF_GGX
        rt_table=_rt_tables(kinds, etas, alphas, dist, n)[0],
        rt_alpha_max=_rt_tables(kinds, etas, alphas, dist, n)[1],
    )


def _rt_tables(kinds, etas, alphas, dist, n):
    """Host-side rough-transmittance tables for ROUGH_COATING entries
    (zeros elsewhere) — computed once at scene build (and memoized per
    (eta, dist, alpha_max), so the duplicate call in make_materials is
    free). Each table spans alpha in (0, max(0.5, material alpha)] so
    rougher-than-0.5 coatings interpolate within range instead of
    silently clamping to the last row (ADVICE r03 item 3); the span is
    returned per material for the lookup normalization."""
    kinds_np = np.asarray(kinds).reshape(-1)
    out = np.zeros((n, 16, 8), np.float32)
    amax = np.full((n,), 0.5, np.float32)
    if (kinds_np == ROUGH_COATING).any():
        from alvrl_tpu.bsdf import microfacet as _mf

        etas_np = np.asarray(
            etas if etas is not None else [1.0] * n, np.float32)
        dist_np = np.asarray(
            dist if dist is not None else [1] * n, np.int32)
        alphas_np = np.asarray(
            alphas if alphas is not None else [0.1] * n, np.float32)
        for i in np.flatnonzero(kinds_np == ROUGH_COATING):
            amax[i] = max(0.5, float(alphas_np[i]))
            out[i] = np.asarray(_mf.rough_transmittance_table(
                float(etas_np[i]), int(dist_np[i]),
                alpha_max=float(amax[i])))
    return jnp.asarray(out), jnp.asarray(amax)


# sensor kinds (src/sensors/)
PERSPECTIVE = 0   # perspective.cpp (pinhole)
THINLENS = 1      # thinlens.cpp (aperture + focus distance)
ORTHOGRAPHIC = 2  # orthographic.cpp
SPHERICAL = 3     # spherical.cpp (equirectangular)
TELECENTRIC = 4   # telecentric.cpp (ortho film + finite aperture)
PERSPECTIVE_RDIST = 5  # perspective_rdist.cpp (radial distortion kc)


@struct.dataclass
class Camera:
    """Sensor (src/sensors/perspective.cpp and friends).

    to_world: (4, 4) camera-to-world; camera space looks down +z with
    x right, y up (mitsuba convention). fov is the horizontal field of
    view in degrees (perspective/thinlens); ortho_scale the half-width
    of the orthographic film in world units. Resolution and kind live
    here as static metadata so ray generation is compile-time shaped.
    """

    to_world: jax.Array
    fov_x_deg: jax.Array
    aperture_radius: float = 0.0
    focus_distance: float = 1.0
    ortho_scale: float = 1.0
    kc0: float = 0.0  # radial distortion r^2 coeff (perspective_rdist)
    kc1: float = 0.0  # radial distortion r^4 coeff
    width: int = struct.field(pytree_node=False, default=128)
    height: int = struct.field(pytree_node=False, default=128)
    kind: int = struct.field(pytree_node=False, default=PERSPECTIVE)


@struct.dataclass
class Scene:
    vertices: jax.Array   # (V, 3) f32
    faces: jax.Array      # (T, 3) i32
    material: jax.Array   # (T,) i32 per-face material id
    materials: Materials
    emitters: Emitters
    medium: HomogeneousMedium  # global medium filling the scene
    camera: Camera
    face_emitter: jax.Array = None  # (T,) i32: area-emitter id or -1
    face_uv: jax.Array = None  # (T, 3, 2) per-corner texture coords
    textures: jax.Array = None  # (K, H, W, 3) bitmap texture stack
                                # (equal-size, loader-padded)
    # per-shape nested media (media/table.py); None => the single
    # global `medium` everywhere (the reference's shapes reference
    # interior/exterior media the same way)
    media: object = None               # MediaTable | None
    face_med_int: jax.Array = None     # (T,) i32 id into `media`
    face_med_ext: jax.Array = None     # (T,) i32 id into `media`
    face_shape: jax.Array = None       # (T,) i32 high-level shape index
                                       # (the reference's shape list order;
                                       # used by the `field` integrator's
                                       # shapeIndex AOV, field.cpp)
    weave: object = None               # bsdf.irawan.WeavePattern for
                                       # IRAWAN materials (one per scene)
    vertices_t1: jax.Array = None      # (V, 3) time-1 keyframe for
                                       # deformable/animated shapes
                                       # (deformable.cpp; time 0 =
                                       # `vertices`; see integrators/
                                       # motion.py)

    def __post_init__(self):
        if self.face_emitter is None:
            object.__setattr__(
                self, "face_emitter",
                jnp.full((self.faces.shape[0],), -1, jnp.int32),
            )
        if self.face_uv is None:
            object.__setattr__(
                self, "face_uv",
                jnp.zeros((self.faces.shape[0], 3, 2), jnp.float32),
            )
        if self.textures is None:
            object.__setattr__(
                self, "textures", jnp.zeros((1, 1, 1, 3), jnp.float32)
            )
        if self.face_med_int is None:
            object.__setattr__(
                self, "face_med_int",
                jnp.zeros((self.faces.shape[0],), jnp.int32),
            )
        if self.face_med_ext is None:
            object.__setattr__(
                self, "face_med_ext",
                jnp.zeros((self.faces.shape[0],), jnp.int32),
            )
        if self.face_shape is None:
            object.__setattr__(
                self, "face_shape",
                jnp.zeros((self.faces.shape[0],), jnp.int32),
            )

    @property
    def num_tris(self) -> int:
        return self.faces.shape[0]

    def opaque_faces(self):
        """(T,) bool — triangles that block shadow rays (non-null BSDF).

        Counterpart of the null-boundary skip in Scene::evalTransmittance
        (scene.cpp:619-679)."""
        return self.materials.kind[self.material] != NULL

    def aabb(self):
        return jnp.min(self.vertices, axis=0), jnp.max(self.vertices, axis=0)


def look_at(origin, target, up):
    """Camera-to-world 4x4, mitsuba convention (+z forward, y up).

    Counterpart of Transform::lookAt (src/libcore/transform.cpp)."""
    origin = np.asarray(origin, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    fwd = target - origin
    fwd /= np.linalg.norm(fwd)
    left = np.cross(up / np.linalg.norm(up), fwd)
    left /= np.linalg.norm(left)
    new_up = np.cross(fwd, left)
    mat = np.eye(4, dtype=np.float32)
    mat[:3, 0] = left
    mat[:3, 1] = new_up
    mat[:3, 2] = fwd
    mat[:3, 3] = origin
    return jnp.asarray(mat)


def make_point_emitters(positions, intensities):
    """Point-light convenience constructor (luminance-weighted selection
    pmf, the counterpart of Scene::m_emitterPDF, scene.cpp:378-380)."""
    from alvrl_tpu.emitters.emitters import POINT, make_emitters

    positions = jnp.asarray(positions, jnp.float32).reshape(-1, 3)
    n = positions.shape[0]
    return make_emitters([POINT] * n, positions, intensities)
