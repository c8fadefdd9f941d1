"""Mesh-fidelity rendering: per-segment SDF sphere-trace refinement.

Port of ``flygym_tpu/render/sdf.py``, batch-first. Each body segment's
anatomical mesh is baked offline into a small body-frame signed-distance
grid (``flygym_tpu_torch/assets/model/sdf_meshes.npz``, the port's copy of
the JAX package's pack).
The raycaster's capsule pass proposes up to two candidate geoms per ray; each
candidate's grid is sphere traced for a fixed number of steps in its body
frame near the capsule hit, and the nearest mesh hit wins, with the SDF
gradient as its normal.
"""

from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from flygym_tpu_torch.engine.maths import norm, quat_conj, quat_mul, quat_rotate
from flygym_tpu_torch.render.raycast import _gather_rows

__all__ = ["SDF_MESHES", "build_sdf_pack", "sdf_refine"]

SDF_MESHES = Path(__file__).resolve().parents[1] / "assets/model/sdf_meshes.npz"
_BIG = 1e30
N_MARCH = 40
HIT_EPS_VOX = 0.6  # a hit where the SDF is below this many voxels
RANGE_VOX = 6.0  # the search window around the capsule hit, in voxels


@lru_cache(maxsize=1)
def _load_library():
    if not SDF_MESHES.exists():
        return None
    with np.load(SDF_MESHES) as npz:
        return {k: npz[k] for k in npz.files}


def build_sdf_pack(model, geom_names):
    """Tensors for SDF sampling, aligned with the model's geoms.

    Args:
        model: The port's ``PhysicsModel``.
        geom_names: The geom names by geom id (``CompiledModel.render[
            "geom_names"]``); a segment's mesh is matched by the name's
            part after the fly's ``/``.

    Returns:
        A dict of tensors on the model's device (the flat SDF buffer and
        per-geom ``base``, ``dims``, ``origin``, ``spacing``), or None
        without the asset.
    """
    lib = _load_library()
    if lib is None:
        return None
    flat, base, dims, origin, spacing = [], [], [], [], []
    offset = 0
    for g in range(int(model.ngeom)):
        name = geom_names[g] if g < len(geom_names) else ""
        seg = name.rsplit("/", 1)[-1]
        key = f"{seg}:sdf"
        if key in lib:
            sdf = lib[key].astype(np.float32)
            flat.append(sdf.ravel())
            base.append(offset)
            dims.append(sdf.shape)
            origin.append(lib[f"{seg}:origin"])
            spacing.append(float(lib[f"{seg}:spacing"]))
            offset += sdf.size
        else:
            base.append(-1)
            dims.append((1, 1, 1))
            origin.append(np.zeros(3, np.float32))
            spacing.append(1.0)
    if not flat:
        return None
    as_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=model.device)
    return dict(
        flat=as_t(np.concatenate(flat), torch.float32),
        base=as_t(np.array(base, np.int64), torch.int64),
        dims=as_t(np.array(dims, np.int64), torch.int64),
        origin=as_t(np.array(origin, np.float32), torch.float32),
        spacing=as_t(np.array(spacing, np.float32), torch.float32),
    )


def _sample(pack, base, dims, origin, spacing, p):
    """Trilinear SDF sample at body-frame points p (..., 3). Outside the
    grid the clamped border sample is increased by the distance to the box,
    so that marches started far away still converge."""
    q = (p - origin) / spacing[..., None]
    qc = torch.minimum(torch.clamp(q, min=0.0), dims.to(q.dtype) - 1.001)
    i = torch.floor(qc)
    f = qc - i
    i = i.long()
    ny = dims[..., 1]
    nz = dims[..., 2]

    def corner(dx, dy, dz):
        idx = base + ((i[..., 0] + dx) * ny + (i[..., 1] + dy)) * nz + (i[..., 2] + dz)
        return torch.take(pack["flat"], torch.clamp(idx, min=0))

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c000, c100 = corner(0, 0, 0), corner(1, 0, 0)
    cx00 = c000 + fx * (c100 - c000)
    c010, c110 = corner(0, 1, 0), corner(1, 1, 0)
    cx10 = c010 + fx * (c110 - c010)
    c001, c101 = corner(0, 0, 1), corner(1, 0, 1)
    cx01 = c001 + fx * (c101 - c001)
    c011, c111 = corner(0, 1, 1), corner(1, 1, 1)
    cx11 = c011 + fx * (c111 - c011)
    cxy0 = cx00 + fy * (cx10 - cx00)
    cxy1 = cx01 + fy * (cx11 - cx01)
    s = cxy0 + fz * (cxy1 - cxy0)
    out = (q - qc) * spacing[..., None]
    return s + norm(out)


def _march_one(pack, model, gpos, gquat, origins, dirs, t_cap, geom):
    """Sphere-trace one candidate geom per ray: (t, normal, hit)."""
    g = torch.clamp(geom, min=0)
    base = pack["base"][g]
    has = (geom >= 0) & (base >= 0) & (t_cap < _BIG)
    dims = pack["dims"][g]
    origin = pack["origin"][g]
    spacing = pack["spacing"][g]

    # The body's world frame from the geom's world pose and its constant
    # body-to-geom offset (the grids live in the body frame).
    bq = quat_mul(_gather_rows(gquat, g), quat_conj(model.geom_quat[g]))
    bp = _gather_rows(gpos, g) - quat_rotate(bq, model.geom_pos[g])
    bq_inv = quat_conj(bq)
    o_l = quat_rotate(bq_inv, origins - bp)
    d_l = quat_rotate(bq_inv, dirs)

    radius = model.geom_size[g, 0]
    window = RANGE_VOX * spacing + radius
    t = torch.clamp(t_cap - window, min=0.0)
    t1 = t_cap + window
    eps = HIT_EPS_VOX * spacing
    min_step = 0.35 * spacing
    hit = torch.zeros_like(has)
    t_hit = torch.full_like(t, _BIG)
    for _ in range(N_MARCH):
        s = _sample(pack, base, dims, origin, spacing, o_l + t[..., None] * d_l)
        new_hit = has & ~hit & (s < eps) & (t <= t1)
        t_hit = torch.where(new_hit, t, t_hit)
        hit = hit | new_hit
        t = t + torch.where(hit, torch.zeros_like(s), torch.maximum(s, min_step))
    # The SDF gradient at the hit (central differences, body frame).
    ph = o_l + t_hit[..., None] * d_l
    h = spacing[..., None] * 0.75
    eye = torch.eye(3, dtype=ph.dtype, device=ph.device)
    n_l = torch.stack([
        _sample(pack, base, dims, origin, spacing, ph + eye[ax] * h)
        - _sample(pack, base, dims, origin, spacing, ph - eye[ax] * h)
        for ax in range(3)
    ], dim=-1)
    n_l = n_l / torch.clamp(norm(n_l, keepdim=True), min=1e-12)
    return torch.where(hit, t_hit, torch.full_like(t_hit, _BIG)), quat_rotate(bq, n_l), hit


def sdf_refine(pack, model, gpos, gquat, origins, dirs, cand_t, cand_idx):
    """Refine capsule candidate hits against the mesh SDFs.

    Args:
        cand_t / cand_idx: Lists of (B, R) candidate hit distances and geom
            indices, nearest first, from the capsule pass.

    Returns:
        (t, geom_idx, normal, hit): the nearest mesh hit per ray. Rays whose
        candidates all miss their meshes, or carry no SDF, report hit False.
    """
    best_t = torch.full_like(cand_t[0], _BIG)
    best_idx = torch.full_like(cand_idx[0], -2)
    best_n = torch.zeros_like(origins)
    any_hit = torch.zeros(best_t.shape, dtype=torch.bool, device=best_t.device)
    for t_c, idx_c in zip(cand_t, cand_idx):
        t_m, n_m, hit_m = _march_one(pack, model, gpos, gquat, origins, dirs, t_c, idx_c)
        better = hit_m & (t_m < best_t)
        best_t = torch.where(better, t_m, best_t)
        best_idx = torch.where(better, idx_c, best_idx)
        best_n = torch.where(better[..., None], n_m, best_n)
        any_hit = any_hit | hit_m
    return best_t, best_idx, best_n, any_hit
