"""Procedural triangle-mesh shape constructors (host-side, numpy).

Counterpart of the reference's analytic shape plugins
(src/shapes/{rectangle,cube,sphere}.cpp) — here every shape is
triangulated up front so the device-side intersector sees one uniform
triangle soup. Runs at scene-build time on host; not traced.
"""

from __future__ import annotations

import numpy as np


def rectangle(to_world=None):
    """Unit xy rectangle [-1,1]^2 at z=0, normal +z (rectangle.cpp)."""
    v = np.array(
        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], dtype=np.float32
    )
    f = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32)
    if to_world is not None:
        v = apply_transform(to_world, v)
    return v, f


def cube(to_world=None, flip_normals=False):
    """[-1,1]^3 cube with outward normals (cube.cpp)."""
    verts = []
    faces = []
    # Each face as a rectangle transformed into place.
    axes = [
        # (permutation to place rect, offset along normal axis)
        (np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]]), np.array([0, 0, 1.0])),
        (np.array([[-1, 0, 0], [0, 1, 0], [0, 0, -1]]), np.array([0, 0, -1.0])),
        (np.array([[0, 0, 1], [0, 1, 0], [1, 0, 0]]), np.array([1.0, 0, 0])),
        (np.array([[0, 0, -1], [0, 1, 0], [-1, 0, 0]]), np.array([-1.0, 0, 0])),
        (np.array([[1, 0, 0], [0, 0, 1], [0, 1, 0]]), np.array([0, 1.0, 0])),
        (np.array([[1, 0, 0], [0, 0, -1], [0, -1, 0]]), np.array([0, -1.0, 0])),
    ]
    for rot, off in axes:
        v, f = rectangle()
        rot = np.asarray(rot, dtype=np.float32)
        v = v @ rot.T + off.astype(np.float32)
        # reflection placements (det < 0) reverse the winding: without
        # this the +-x / +-y faces wound INWARD while +-z wound outward
        # (mixed!), breaking every winding-sensitive consumer (the
        # dielectric side test above all) — found by the round-5 SDS
        # study alongside the inverted sphere winding
        if np.linalg.det(rot) < 0:
            f = f[:, ::-1]
        faces.append(f + sum(len(x) for x in verts))
        verts.append(v)
    v = np.concatenate(verts, axis=0)
    f = np.concatenate(faces, axis=0)
    if flip_normals:
        f = f[:, ::-1]
    if to_world is not None:
        v = apply_transform(to_world, v)
    return v, f.copy()


def sphere(center=(0, 0, 0), radius=1.0, n_theta=16, n_phi=32):
    """UV-sphere triangulation (sphere.cpp approximated by a mesh)."""
    center = np.asarray(center, dtype=np.float32)
    thetas = np.linspace(0, np.pi, n_theta + 1)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    ring_v = []
    for th in thetas:
        st, ct = np.sin(th), np.cos(th)
        ring = np.stack(
            [st * np.cos(phis), st * np.sin(phis), np.full_like(phis, ct)],
            axis=-1,
        )
        ring_v.append(ring)
    v = np.concatenate(ring_v, axis=0).astype(np.float32)
    faces = []
    for i in range(n_theta):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            # wind OUTWARD (cross(e1, e2) away from the center): the
            # raw winding normal is the dielectric side test
            # (specular_bounce's `entering`) — the round-5 SDS study
            # caught the old inward winding making every glass sphere
            # a DIVERGING lens (no caustics possible)
            faces.append([a, d, b])
            faces.append([a, c, d])
    f = np.asarray(faces, dtype=np.int32)
    v = v * np.float32(radius) + center
    return v, f


def disk(center=(0, 0, 0), radius=1.0, n_phi=48, to_world=None):
    """Unit disk at z=0, normal +z (disk.cpp), triangle fan."""
    center = np.asarray(center, np.float32)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    rim = np.stack(
        [np.cos(phis), np.sin(phis), np.zeros_like(phis)], axis=-1
    ).astype(np.float32)
    v = np.concatenate([np.zeros((1, 3), np.float32), rim], axis=0)
    f = np.asarray(
        [[0, 1 + j, 1 + (j + 1) % n_phi] for j in range(n_phi)], np.int32
    )
    v = v * np.float32(radius) + center
    if to_world is not None:
        v = apply_transform(to_world, v)
    return v, f


def cylinder(p0=(0, 0, 0), p1=(0, 0, 1), radius=1.0, n_phi=32,
             caps=False):
    """Open cylinder from p0 to p1 (cylinder.cpp; the reference's is
    capless too). Optional end caps for watertightness."""
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    axis = p1 - p0
    length = np.linalg.norm(axis)
    w = axis / max(length, 1e-12)
    # build an orthonormal frame around w
    a = np.array([1.0, 0, 0], np.float32)
    if abs(w[0]) > 0.9:
        a = np.array([0, 1.0, 0], np.float32)
    u = np.cross(a, w)
    u /= np.linalg.norm(u)
    vv = np.cross(w, u)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    rim = (np.outer(np.cos(phis), u) + np.outer(np.sin(phis), vv)) * radius
    bottom = (p0 + rim).astype(np.float32)
    top = (p1 + rim).astype(np.float32)
    v = np.concatenate([bottom, top], axis=0)
    faces = []
    for j in range(n_phi):
        jn = (j + 1) % n_phi
        faces.append([j, jn, n_phi + jn])
        faces.append([j, n_phi + jn, n_phi + j])
    if caps:
        cb = len(v)
        v = np.concatenate([v, p0[None], p1[None]], axis=0)
        for j in range(n_phi):
            jn = (j + 1) % n_phi
            faces.append([cb, jn, j])
            faces.append([cb + 1, n_phi + j, n_phi + jn])
    return v.astype(np.float32), np.asarray(faces, np.int32)


def heightfield(heights, x_extent=2.0, y_extent=2.0, to_world=None):
    """Regular-grid heightfield (heightfield.cpp): heights (Ny, Nx) map
    to a mesh over [-x_extent/2, x_extent/2] x [-y_extent/2, y_extent/2]
    with z = heights."""
    heights = np.asarray(heights, np.float32)
    ny, nx = heights.shape
    xs = np.linspace(-x_extent / 2, x_extent / 2, nx, dtype=np.float32)
    ys = np.linspace(-y_extent / 2, y_extent / 2, ny, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    v = np.stack([gx, gy, heights], axis=-1).reshape(-1, 3)
    idx = np.arange(nx * ny).reshape(ny, nx)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    c = idx[1:, :-1].ravel()
    d = idx[1:, 1:].ravel()
    f = np.concatenate(
        [np.stack([a, b, d], axis=-1), np.stack([a, d, c], axis=-1)],
        axis=0,
    ).astype(np.int32)
    if to_world is not None:
        v = apply_transform(to_world, v)
    return v.astype(np.float32), f


def hair(control_points, radius=0.01, n_phi=4):
    """Hair fibers as tessellated tubes (hair.cpp models fibers as
    capsule segments; at render scale low-poly open tubes match).
    `control_points`: list of (K_i, 3) polylines, one per fiber."""
    parts_v, parts_f = [], []
    off = 0
    for pts in control_points:
        pts = np.asarray(pts, np.float32)
        for i in range(len(pts) - 1):
            v, f = cylinder(pts[i], pts[i + 1], radius, n_phi=n_phi)
            parts_v.append(v)
            parts_f.append(f + off)
            off += len(v)
    return (np.concatenate(parts_v, axis=0),
            np.concatenate(parts_f, axis=0))


def load_hair_file(path, radius_default=0.025):
    """Mitsuba .hair loader (hair.cpp:loadHairFile): either ASCII lines
    of 'x y z' with blank lines separating fibers, or the BINARY_HAIR
    format (magic 'BINARY_HAIR', uint32 vertex count, float triples
    with +inf x as fiber separators)."""
    with open(path, "rb") as fh:
        head = fh.read(11)
        fibers, cur = [], []
        if head == b"BINARY_HAIR":
            (n,) = np.frombuffer(fh.read(4), np.uint32)
            data = np.frombuffer(fh.read(), np.float32)
            i = 0
            read = 0
            while read < n:
                x = data[i]
                if np.isinf(x):
                    if cur:
                        fibers.append(np.asarray(cur, np.float32))
                    cur = []
                    i += 1
                else:
                    cur.append(data[i:i + 3])
                    i += 3
                read += 1
        else:
            fh.seek(0)
            for line in fh.read().decode("latin-1").splitlines():
                line = line.strip()
                if not line:
                    if cur:
                        fibers.append(np.asarray(cur, np.float32))
                    cur = []
                    continue
                cur.append([float(t) for t in line.split()[:3]])
        if cur:
            fibers.append(np.asarray(cur, np.float32))
    return [f for f in fibers if len(f) >= 2]


def instance(base_v, base_f, to_worlds):
    """Shape instancing (instance.cpp/shapegroup.cpp): replicate a mesh
    under a list of 4x4 transforms. Meshes are flattened up front and
    the BVH sees the union (the reference's kd-tree nests instead)."""
    all_v, all_f = [], []
    off = 0
    for t in to_worlds:
        all_v.append(apply_transform(t, base_v))
        all_f.append(np.asarray(base_f, np.int32) + off)
        off += len(base_v)
    return (np.concatenate(all_v, axis=0).astype(np.float32),
            np.concatenate(all_f, axis=0))


def apply_transform(mat4, verts):
    """Apply a 4x4 homogeneous transform to (N, 3) vertices."""
    mat4 = np.asarray(mat4, dtype=np.float32)
    vh = np.concatenate([verts, np.ones((len(verts), 1), np.float32)], axis=1)
    out = vh @ mat4.T
    return (out[:, :3] / out[:, 3:4]).astype(np.float32)


def translate(x, y, z):
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [x, y, z]
    return t


def scale(x, y=None, z=None):
    if y is None:
        y = z = x
    s = np.eye(4, dtype=np.float32)
    s[0, 0], s[1, 1], s[2, 2] = x, y, z
    return s


def auto_uvs(kind: str, v, f, center=None):
    """Per-face-corner texture coordinates (F, 3, 2) for the analytic
    shapes, computed from CANONICAL (pre-to_world) vertices — the UV
    parameterizations of src/shapes/{rectangle,cube,sphere}.cpp:
      * rectangle: (x, y) in [-1,1]^2 -> [0,1]^2;
      * cube: dominant-axis box projection per face;
      * sphere: equirectangular (phi/2pi, theta/pi) about `center`.
    Unknown kinds get zeros (untextured)."""
    v = np.asarray(v, np.float32)
    f = np.asarray(f, np.int32)
    corners = v[f]  # (F, 3, 3)
    if kind == "rectangle":
        return ((corners[..., :2] + 1.0) * 0.5).astype(np.float32)
    if kind == "cube":
        n = np.cross(corners[:, 1] - corners[:, 0],
                     corners[:, 2] - corners[:, 0])
        axis = np.argmax(np.abs(n), axis=-1)  # (F,)
        uv = np.zeros((len(f), 3, 2), np.float32)
        for a, (i0, i1) in enumerate([(1, 2), (0, 2), (0, 1)]):
            sel = axis == a
            uv[sel] = (corners[sel][..., [i0, i1]] + 1.0) * 0.5
        return uv
    if kind == "sphere":
        c = np.zeros(3, np.float32) if center is None else np.asarray(
            center, np.float32)
        d = corners - c
        d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
        theta = np.arccos(np.clip(d[..., 2], -1, 1))
        phi = np.arctan2(d[..., 1], d[..., 0])
        u = (phi / (2 * np.pi) + 0.5)
        # avoid the seam jump inside one triangle: rebase to corner 0
        u = u - np.round(u - u[:, :1])
        return np.stack([u, theta / np.pi], axis=-1).astype(np.float32)
    return np.zeros((len(f), 3, 2), np.float32)


def merge(parts):
    """Merge [(verts, faces, material_id[, face_uv]), ...] into one
    soup. Returns (verts, faces, mats, face_uvs (T, 3, 2))."""
    all_v, all_f, all_m, all_uv = [], [], [], []
    off = 0
    for part in parts:
        v, f, mat = part[0], part[1], part[2]
        uv = part[3] if len(part) > 3 and part[3] is not None else (
            np.zeros((len(f), 3, 2), np.float32)
        )
        all_v.append(v)
        all_f.append(f + off)
        all_m.append(np.full((len(f),), mat, dtype=np.int32))
        all_uv.append(np.asarray(uv, np.float32))
        off += len(v)
    return (
        np.concatenate(all_v, axis=0),
        np.concatenate(all_f, axis=0),
        np.concatenate(all_m, axis=0),
        np.concatenate(all_uv, axis=0),
    )
