"""Quaternion and spatial (Plücker) algebra on batched tensors.

Port of ``flygym_tpu/engine/maths.py``; conventions are the same:

- Quaternions are (w, x, y, z), normalised, rotating local into world.
- Spatial motion vectors are 6D ``(angular, linear)`` in world axes about a
  reference point; spatial forces are ``(torque, force)`` about it.

Every function broadcasts over leading dimensions. Vector norms are written
as ``sqrt(sum(x * x))``, which is what ``jnp.linalg.norm`` computes, so that
the port rounds where the reference does.
"""

import torch

__all__ = [
    "cross",
    "norm",
    "quat_mul",
    "quat_conj",
    "quat_rotate",
    "quat_rotate_inv",
    "quat_from_axis_angle",
    "quat_integrate",
    "quat_to_mat",
    "mat_to_quat",
    "normalize_quat",
    "skew",
    "motion_cross",
    "force_cross",
    "spatial_inertia",
]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product of (..., 3) vectors, broadcasting like ``jnp.cross``."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b for (..., 4) quaternions."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (= inverse for unit quaternions)."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors (..., 3) by quaternions (..., 4): local → world."""
    qw = q[..., :1]
    qv = q[..., 1:]
    # v' = v + 2 qw (qv × v) + 2 qv × (qv × v)
    uv = cross(qv, v)
    return v + 2.0 * (qw * uv + cross(qv, uv))


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate by the inverse quaternion: world → local."""
    return quat_rotate(quat_conj(q), v)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit quaternion for a rotation of ``angle`` (...,) about ``axis`` (..., 3)."""
    half = 0.5 * angle[..., None]
    xyz = torch.sin(half) * axis
    w = torch.cos(half).expand(xyz.shape[:-1] + (1,))
    return torch.cat([w, xyz], dim=-1)


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """Integrate orientation by a world-frame angular velocity over dt.

    Exact exponential map: q' = exp(ω dt / 2) ⊗ q.
    """
    rot = omega_world * dt
    angle = norm(rot)
    # Safe normalise: the axis is irrelevant when the angle is ~0.
    axis = rot / torch.clamp(angle[..., None], min=1e-12)
    dq = quat_from_axis_angle(axis, angle)
    return normalize_quat(quat_mul(dq, q))


def normalize_quat(q: torch.Tensor) -> torch.Tensor:
    return q / norm(q, keepdim=True)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) → rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) → unit quaternion (..., 4), w-first.

    Branch-free Shepperd's method: all four candidates, the strongest chosen
    with ``where``.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw_t = 0.5 * safe_sqrt(1.0 + tr)
    q_t = torch.stack(
        [qw_t, (m21 - m12) / (4 * qw_t), (m02 - m20) / (4 * qw_t),
         (m10 - m01) / (4 * qw_t)], dim=-1)
    qx_x = 0.5 * safe_sqrt(1.0 + m00 - m11 - m22)
    q_x = torch.stack(
        [(m21 - m12) / (4 * qx_x), qx_x, (m01 + m10) / (4 * qx_x),
         (m02 + m20) / (4 * qx_x)], dim=-1)
    qy_y = 0.5 * safe_sqrt(1.0 - m00 + m11 - m22)
    q_y = torch.stack(
        [(m02 - m20) / (4 * qy_y), (m01 + m10) / (4 * qy_y), qy_y,
         (m12 + m21) / (4 * qy_y)], dim=-1)
    qz_z = 0.5 * safe_sqrt(1.0 - m00 - m11 + m22)
    q_z = torch.stack(
        [(m10 - m01) / (4 * qz_z), (m02 + m20) / (4 * qz_z),
         (m12 + m21) / (4 * qz_z), qz_z], dim=-1)

    use_t = tr > 0.0
    use_x = (~use_t) & (m00 >= m11) & (m00 >= m22)
    use_y = (~use_t) & (~use_x) & (m11 >= m22)
    q = torch.where(
        use_t[..., None], q_t,
        torch.where(use_x[..., None], q_x, torch.where(use_y[..., None], q_y, q_z)),
    )
    return normalize_quat(q)


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrices of (..., 3) vectors: (..., 3, 3)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def motion_cross(m: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product m ×̂ other for (..., 6) motion vectors."""
    w, v = m[..., :3], m[..., 3:]
    ow, ov = other[..., :3], other[..., 3:]
    return torch.cat([cross(w, ow), cross(w, ov) + cross(v, ow)], dim=-1)


def force_cross(m: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product m ×̂* f (motion (..., 6) acting on force)."""
    w, v = m[..., :3], m[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, n) + cross(v, fl), cross(w, fl)], dim=-1)


def spatial_inertia(
    mass: torch.Tensor, inertia_world: torch.Tensor, com_offset: torch.Tensor
) -> torch.Tensor:
    """Spatial inertia (..., 6, 6) about a reference point.

    Args:
        mass: (...,) body mass.
        inertia_world: (..., 3, 3) rotational inertia about the com, world axes.
        com_offset: (..., 3) com relative to the reference point, world axes.

    Featherstone: I = [[Ī + m c× c×ᵀ, m c×], [m c×ᵀ, m·1]].
    """
    c = skew(com_offset)
    ct = c.transpose(-1, -2)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=com_offset.dtype, device=com_offset.device).expand(c.shape)
    top_left = inertia_world + m * (c @ ct)
    top_right = m * c
    bottom_left = m * ct
    bottom_right = m * eye
    top = torch.cat([top_left, top_right], dim=-1)
    bottom = torch.cat([bottom_left, bottom_right], dim=-1)
    return torch.cat([top, bottom], dim=-2)
