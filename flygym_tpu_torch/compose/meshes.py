"""Runtime mesh-to-geometry derivation for user-supplied STL directories.

Port of ``flygym_tpu/compose/meshes.py``. The reference accepts any
``mesh_basedir`` of per-segment STLs at compose time (flygym
``compose/fly.py:507-543``: subdirectories per mesh type, left-side meshes
mirrored to the right via a negative-y scale). Here the same directory
layout is accepted and each mesh is reduced AT COMPOSE TIME to what the
engine consumes — mesh inertials, a capsule fit, and the capsule's analytic
inertia — with the numpy versions of the JAX package's mesh toolchain
(``flygym_tpu/native/meshtools.py``: ``_load_stl_numpy``,
``_mass_properties_numpy``, ``_capsule_fit_numpy``, copied below; its tests
hold them equal to its C++ library). No native library is needed. The
bundled ``derived_geometry.json`` asset is exactly this derivation
precomputed for the NeuroMechFly meshes.

Note: the capsule fit is a PCA axis + enclosing radius (meshtools), which
can differ slightly from MuJoCo's mesh→capsule fit used to precompute the
bundled asset; for the bundled fly model prefer the default asset path.
"""

from pathlib import Path

import numpy as np

__all__ = ["derive_geometry_from_meshes"]

#: Model works in mm; reference meshes are meters (flygym fly.py:510-512).
DEFAULT_SCALE = 1000.0


def _load_stl_numpy(path: Path) -> np.ndarray:
    raw = path.read_bytes()
    if len(raw) > 84:
        count = int.from_bytes(raw[80:84], "little")
        if len(raw) == 84 + count * 50 and count > 0:
            rec = np.frombuffer(raw[84:], dtype=np.uint8).reshape(count, 50)
            floats = (
                rec[:, :48].copy().view(np.float32).reshape(count, 4, 3)
            )
            return floats[:, 1:, :].astype(np.float64)
    # ASCII fallback.
    verts = []
    for line in raw.decode(errors="ignore").splitlines():
        parts = line.split()
        if parts[:1] == ["vertex"]:
            verts.append([float(x) for x in parts[1:4]])
    arr = np.asarray(verts, np.float64)
    if arr.size == 0 or len(arr) % 3:
        raise ValueError(f"Cannot parse STL file: {path}")
    return arr.reshape(-1, 3, 3)


def _mass_properties_numpy(tris, scale):
    v = tris * scale  # (n, 3, 3)
    a, b, c = v[:, 0], v[:, 1], v[:, 2]
    vols = np.einsum("ij,ij->i", a, np.cross(b, c)) / 6.0
    vol = vols.sum()
    sgn = -1.0 if vol < 0 else 1.0
    com = sgn * (vols[:, None] * (a + b + c) / 4.0).sum(0) / (sgn * vol)

    def P(i, j):
        return (
            vols
            / 20.0
            * (
                2 * (a[:, i] * a[:, j] + b[:, i] * b[:, j] + c[:, i] * c[:, j])
                + a[:, i] * b[:, j]
                + a[:, j] * b[:, i]
                + a[:, i] * c[:, j]
                + a[:, j] * c[:, i]
                + b[:, i] * c[:, j]
                + b[:, j] * c[:, i]
            )
        ).sum() * sgn

    xx, yy, zz = P(0, 0), P(1, 1), P(2, 2)
    xy, xz, yz = P(0, 1), P(0, 2), P(1, 2)
    vol = sgn * vol
    I = np.array(
        [
            [yy + zz, -xy, -xz],
            [-xy, xx + zz, -yz],
            [-xz, -yz, xx + yy],
        ]
    )
    d = com
    I -= vol * (
        (d @ d) * np.eye(3) - np.outer(d, d)
    )
    return float(vol), com, I


def _capsule_fit_numpy(tris, scale):
    pts = (tris * scale).reshape(-1, 3)
    mean = pts.mean(0)
    d = pts - mean
    cov = d.T @ d
    w, V = np.linalg.eigh(cov)
    axis = V[:, np.argmax(w)]
    t = d @ axis
    radial = d - t[:, None] * axis
    radius = float(np.linalg.norm(radial, axis=1).max())
    tmin, tmax = float(t.min()), float(t.max())
    half = max((tmax - tmin) / 2.0 - radius, 1e-9)
    center = mean + (tmax + tmin) / 2.0 * axis

    z = np.array([0.0, 0, 1])
    dot = float(z @ axis)
    if dot > 1 - 1e-12:
        quat = np.array([1.0, 0, 0, 0])
    elif dot < -1 + 1e-12:
        quat = np.array([0.0, 1, 0, 0])
    else:
        cr = np.cross(z, axis)
        ang = np.arctan2(np.linalg.norm(cr), dot)
        cr = cr / np.linalg.norm(cr)
        quat = np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * cr])
    return center, quat, radius, half


def _mat_to_quat_wxyz(R):
    """Rotation matrix → unit quaternion (w, x, y, z)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q / np.linalg.norm(q)


def _principal(inertia, com, mass):
    """Full inertia tensor (about com) → ipos/iquat/diag dict at ``mass``."""
    w, V = np.linalg.eigh(inertia)
    if np.linalg.det(V) < 0:
        V = V * np.array([1.0, 1.0, -1.0])
        w = w.copy()
    order = np.argsort(w)[::-1]
    w, V = w[order], V[:, order]
    if np.linalg.det(V) < 0:
        V[:, 2] = -V[:, 2]
    return {
        "ipos": [float(x) for x in com],
        "iquat": [float(x) for x in _mat_to_quat_wxyz(V)],
        "diag": [float(max(x, 1e-12)) for x in w],
        "mass": float(mass),
    }


def _capsule_inertia(pos, quat, radius, halflen, mass):
    """Analytic inertia of a capsule (cylinder + two hemispheres) at mass."""
    r, h = float(radius), 2.0 * float(halflen)
    v_cyl = np.pi * r * r * h
    v_sph = 4.0 / 3.0 * np.pi * r**3
    rho = mass / max(v_cyl + v_sph, 1e-12)
    m_c, m_s = rho * v_cyl, rho * v_sph
    # About the capsule center, axis = local z.
    iz = 0.5 * m_c * r * r + 0.4 * m_s * r * r
    ixy = (
        m_c * (h * h / 12.0 + r * r / 4.0)
        + m_s * (0.4 * r * r + 0.25 * h * h + 0.375 * r * h)
    )
    return {
        "ipos": [float(x) for x in pos],
        "iquat": [float(x) for x in quat],
        "diag": [float(ixy), float(ixy), float(iz)],
        "mass": float(mass),
    }


def _find_mesh(mesh_basedir: Path, mesh_type: str, name: str) -> Path:
    """Reference lookup order (fly.py:515-536): mesh-type subdir, then the
    fullsize fallback subdir; a flat directory of STLs is also accepted."""
    candidates = [
        mesh_basedir / mesh_type / f"{name}.stl",
        mesh_basedir / "fullsize" / f"{name}.stl",
        mesh_basedir / f"{name}.stl",
    ]
    for c in candidates:
        if c.exists():
            return c
    raise FileNotFoundError(
        f"Mesh file not found for segment {name}: tried "
        + ", ".join(str(c) for c in candidates)
    )


def derive_geometry_from_meshes(
    mesh_basedir,
    rigging: dict,
    *,
    mesh_type: str = "simplified_max2000faces",
    mirror_left2right: bool = True,
    scale: float = DEFAULT_SCALE,
) -> dict:
    """Build the derived-geometry table from a directory of STLs.

    Args:
        mesh_basedir: directory containing ``{mesh_type}/{segment}.stl``
            (with optional ``fullsize/`` fallback) or flat
            ``{segment}.stl`` files.
        rigging: per-segment dict with at least ``mass`` (the rigging.json
            schema) — segment names define which meshes to load.
        mesh_type: subdirectory to prefer, as in the reference's MeshType.
        mirror_left2right: load left-side meshes for right-side segments
            and mirror them across y (reference fly.py:521-527).
        scale: mesh-unit → model-unit scale (1000 = meters → mm).

    Returns:
        ``{segment: {mesh_inertia, capsule_inertia, capsule}}`` in the
        ``derived_geometry.json`` schema that :class:`~flygym_tpu_torch.compose.Fly`
        consumes.
    """
    mesh_basedir = Path(mesh_basedir)
    out = {}
    cache: dict[str, np.ndarray] = {}
    for name, cfg in rigging.items():
        mass = float(cfg["mass"])
        if mirror_left2right and name[0] == "r":
            src = f"l{name[1:]}"
            mirror = True
        else:
            src = name
            mirror = False
        if src not in cache:
            cache[src] = _load_stl_numpy(_find_mesh(mesh_basedir, mesh_type, src))
        tris = cache[src]
        if mirror:
            # Mirror across y and reverse the vertex order so triangle
            # winding (and hence signed volumes) stays outward.
            tris = (tris * np.array([1.0, -1.0, 1.0]))[:, ::-1, :]
        sc = (scale, scale, scale)
        vol, com, inertia_unit = _mass_properties_numpy(tris, np.asarray(sc, np.float64))
        vol = abs(float(vol))
        density = mass / max(vol, 1e-18)
        out_mesh = _principal(np.asarray(inertia_unit) * density, com, mass)

        cpos, cquat, radius, halflen = _capsule_fit_numpy(tris, np.asarray(sc, np.float64))
        out[name] = {
            "mesh_inertia": out_mesh,
            "capsule_inertia": _capsule_inertia(
                cpos, cquat, radius, halflen, mass
            ),
            "capsule": {
                "pos": [float(x) for x in cpos],
                "quat": [float(x) for x in cquat],
                "size": [float(radius), float(halflen)],
            },
        }
    return out
