"""Nearest-hit raycast of the capsule and ground-plane scene, batch-first.

Port of the part of ``flygym_tpu/render/raycast.py`` that the retina uses:
``_ray_capsule`` (:61-98), ``_ray_plane`` (:100-106), ``_capsule_segments``
(:168-177), ``_nearest_capsule_hit`` (:261-290) and ``raycast_scene``
(:322-408). Every tensor carries a leading world axis: geoms are
(B, ngeom, ...), rays (B, R, 3). Not ported: the mesh-SDF refinement
(``sdf_pack``) and the heightfield ground, which :func:`raycast_scene`
refuses; the camera renderer (``render_pixels``) and its lights.

This is the retina's oracle path (``flygym_tpu_torch/vision.py:Retina.render``),
as the jnp raycast is the JAX package's. No entry point of the port renders
through it: the env and ``Retina.make_render_batched`` take the retina
kernel K3 (``flygym_tpu_torch/ops/retina.py``). It is what the camera
renderer and the heightfield retina are to extend.
"""

import torch

from flygym_tpu_torch.engine.maths import quat_rotate
from flygym_tpu_torch.engine.model import PhysicsModel

__all__ = ["raycast_scene"]

_BIG = 1e30
_CHUNK = 8


def _ray_capsule(origin, direction, p0, p1, radius):
    """Ray vs capsule (segment p0-p1, radius r), broadcasting over leading
    axes. Returns (t, hit): the entry distance (``_BIG`` when missed)."""
    ba = p1 - p0
    oa = origin - p0
    baba = torch.sum(ba * ba, dim=-1)
    bard = torch.sum(ba * direction, dim=-1)
    baoa = torch.sum(ba * oa, dim=-1)
    rdoa = torch.sum(direction * oa, dim=-1)
    oaoa = torch.sum(oa * oa, dim=-1)

    a = baba - bard * bard
    b = baba * rdoa - baoa * bard
    c = baba * oaoa - baoa * baoa - radius * radius * baba
    h = b * b - a * c
    safe_a = torch.where(a.abs() < 1e-12, torch.full_like(a, 1e-12), a)
    t_cyl = (-b - torch.sqrt(torch.clamp(h, min=0.0))) / safe_a
    y = baoa + t_cyl * bard
    cyl_hit = (h >= 0.0) & (y > 0.0) & (y < baba) & (t_cyl > 0.0)

    def sphere_t(center):
        oc = origin - center
        b_s = torch.sum(direction * oc, dim=-1)
        c_s = torch.sum(oc * oc, dim=-1) - radius * radius
        h_s = b_s * b_s - c_s
        t_s = -b_s - torch.sqrt(torch.clamp(h_s, min=0.0))
        return torch.where((h_s >= 0.0) & (t_s > 0.0), t_s, torch.full_like(t_s, _BIG))

    t_caps = torch.minimum(sphere_t(p0), sphere_t(p1))
    t = torch.where(cyl_hit, t_cyl, t_caps)
    hit = t < _BIG
    return torch.where(hit, t, torch.full_like(t, _BIG)), hit


def _ray_plane(origin, direction, plane_z: float = 0.0):
    """Ray vs the horizontal plane z = plane_z. Returns (t, hit)."""
    dz = direction[..., 2]
    safe = torch.where(dz.abs() < 1e-12, torch.full_like(dz, 1e-12), dz)
    t = (plane_z - origin[..., 2]) / safe
    hit = (t > 0.0) & (dz.abs() > 1e-12)
    return torch.where(hit, t, torch.full_like(t, _BIG)), hit


def _capsule_segments(model: PhysicsModel, gpos, gquat):
    """World capsule segments (p0, p1 (B, ngeom, 3), radius (ngeom,))."""
    z_axis = quat_rotate(gquat, gpos.new_tensor([0.0, 0.0, 1.0]))
    half = model.geom_size[:, 1]
    radius = model.geom_size[:, 0]
    p0 = gpos - half[:, None] * z_axis
    p1 = gpos + half[:, None] * z_axis
    return p0, p1, radius


def _nearest_capsule_hit(p0, p1, radius, capsule_mask, origins, directions):
    """Nearest capsule hit per ray: (t (B, R), geom index (B, R)).

    The geoms are swept in chunks of 8 with a running minimum, as the JAX
    package sweeps them: within a chunk the first minimum wins, across
    chunks only a strictly nearer one.
    """
    B, R = origins.shape[:2]
    t_geom = origins.new_full((B, R), _BIG)
    idx_geom = torch.zeros((B, R), dtype=torch.int64, device=origins.device)
    ngeom = p0.shape[1]
    for c0 in range(0, ngeom, _CHUNK):
        c1 = min(c0 + _CHUNK, ngeom)
        t_c, _ = _ray_capsule(
            origins[:, :, None, :],
            directions[:, :, None, :],
            p0[:, None, c0:c1, :],
            p1[:, None, c0:c1, :],
            radius[None, None, c0:c1],
        )
        t_c = torch.where(capsule_mask[None, None, c0:c1] > 0, t_c, torch.full_like(t_c, _BIG))
        c_min, c_arg = torch.min(t_c, dim=-1)
        better = c_min < t_geom
        t_geom = torch.where(better, c_min, t_geom)
        idx_geom = torch.where(better, c_arg + c0, idx_geom)
    return t_geom, idx_geom


def raycast_scene(model: PhysicsModel, gpos, gquat, origins, directions, capsule_mask):
    """Nearest hit against the capsule geoms and the ground plane z = 0.

    Args:
        gpos/gquat: (B, ngeom, 3/4) world geom poses.
        origins/directions: (B, R, 3) rays.
        capsule_mask: (ngeom,) 1.0 for geoms rendered as capsules.

    Returns:
        t: (B, R) hit distance (``_BIG`` for sky).
        geom_idx: (B, R) nearest geom, -1 for the plane, -2 for sky.
        normal: (B, R, 3) surface normal at the hit.
    """
    if model.has_hfield:
        raise NotImplementedError("the PyTorch port does not render heightfield terrain")
    p0, p1, radius = _capsule_segments(model, gpos, gquat)
    t_geom, idx_geom = _nearest_capsule_hit(p0, p1, radius, capsule_mask, origins, directions)
    t_plane, _ = _ray_plane(origins, directions, 0.0)
    n_ground = origins.new_tensor([0.0, 0.0, 1.0]).expand(origins.shape)

    t = torch.minimum(t_geom, t_plane)
    minus = lambda v: torch.full_like(idx_geom, v)
    geom_idx = torch.where(
        t_geom <= t_plane, idx_geom, torch.where(t_plane < _BIG, minus(-1), minus(-2))
    )
    geom_idx = torch.where(t < _BIG, geom_idx, minus(-2))

    # Normals.
    hit_p = origins + t[..., None] * directions
    gather = lambda p: torch.gather(p, 1, idx_geom[..., None].expand(-1, -1, 3))
    seg_a, seg_b = gather(p0), gather(p1)
    ba = seg_b - seg_a
    denom = torch.clamp(torch.sum(ba * ba, dim=-1), min=1e-12)
    s = torch.clamp(torch.sum((hit_p - seg_a) * ba, dim=-1) / denom, 0.0, 1.0)
    closest = seg_a + s[..., None] * ba
    n_caps = hit_p - closest
    n_caps = n_caps / torch.clamp(
        torch.sqrt(torch.sum(n_caps * n_caps, dim=-1, keepdim=True)), min=1e-12
    )
    normal = torch.where((geom_idx >= 0)[..., None], n_caps, n_ground)
    return t, geom_idx, normal
