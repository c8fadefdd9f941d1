"""Per-leg ground-contact netforce sensors, batch-first.

Port of ``flygym_tpu/engine/sensors.py``. Each sensor row has the
reference's 16 values: ``found, force(3), torque(3), pos(3), normal(3),
tangent(3)``, with force and torque in the contact frame (x = normal) and
the rest in the world frame.
"""

import torch

from flygym_tpu_torch.engine.maths import cross, norm
from flygym_tpu_torch.engine.model import PhysicsModel

__all__ = ["contact_sensor_data"]


def _scatter_sum(values: torch.Tensor, slot: torch.Tensor, n: int) -> torch.Tensor:
    """Sum (B, K, ...) values into (B, n, ...) bins by (B, K) slot."""
    index = slot.reshape(slot.shape + (1,) * (values.dim() - 2)).expand_as(values)
    out = values.new_zeros((values.shape[0], n) + values.shape[2:])
    return out.scatter_add(1, index, values)


def contact_sensor_data(model: PhysicsModel, info, batch_size: int) -> torch.Tensor:
    """Reduce the selected contacts into (B, nsensor_contact, 16) rows."""
    ns = model.nsensor_contact
    if ns == 0 or info is None:
        return torch.zeros(
            (batch_size, ns, 16), dtype=torch.float32, device=model.device
        )

    # Inactive or unsensored contacts go to a scratch slot.
    on = info.active & (info.sensor >= 0)
    slot = torch.where(on, info.sensor, ns)
    w = on.to(info.pos.dtype)
    count = _scatter_sum(w, slot, ns + 1)
    found = (count[:, :ns] > 0).to(w.dtype)

    force_frame = _scatter_sum(info.force_frame * w[..., None], slot, ns + 1)

    # Representative position: force-magnitude-weighted mean contact point.
    fmag = torch.abs(info.force_frame[..., 0]) * w
    fmag_sum = _scatter_sum(fmag, slot, ns + 1)
    pos_w = _scatter_sum(info.pos * fmag[..., None], slot, ns + 1)
    pos_plain = _scatter_sum(info.pos * w[..., None], slot, ns + 1)
    pos = torch.where(
        fmag_sum[:, :ns, None] > 1e-12,
        pos_w[:, :ns] / torch.clamp(fmag_sum[:, :ns, None], min=1e-12),
        pos_plain[:, :ns] / torch.clamp(count[:, :ns, None], min=1.0),
    )

    # Representative frame: weighted mean normal, re-orthogonalised tangent.
    n_sum = _scatter_sum(info.frame[..., 0, :] * w[..., None], slot, ns + 1)
    t_sum = _scatter_sum(info.frame[..., 1, :] * w[..., None], slot, ns + 1)
    normal = n_sum[:, :ns]
    nrm = norm(normal, keepdim=True)
    normal = torch.where(
        nrm > 1e-9,
        normal / torch.clamp(nrm, min=1e-12),
        normal.new_tensor([0.0, 0.0, 1.0]),
    )
    tangent = t_sum[:, :ns]
    tangent = tangent - torch.sum(tangent * normal, -1, keepdim=True) * normal
    tnorm = norm(tangent, keepdim=True)
    tangent = torch.where(
        tnorm > 1e-9,
        tangent / torch.clamp(tnorm, min=1e-12),
        tangent.new_tensor([1.0, 0.0, 0.0]),
    )

    # Net torque about the representative position, in the sensor frame.
    rep = torch.gather(
        pos, 1, torch.clamp(slot, 0, ns - 1)[..., None].expand(slot.shape + (3,))
    )
    torque_world = cross(info.pos - rep, info.force_world) * w[..., None]
    tw = _scatter_sum(torque_world, slot, ns + 1)[:, :ns]
    t2 = cross(normal, tangent)
    torque_frame = torch.stack(
        [
            torch.sum(tw * normal, -1),
            torch.sum(tw * tangent, -1),
            torch.sum(tw * t2, -1),
        ],
        dim=-1,
    )

    return torch.cat(
        [found[..., None], force_frame[:, :ns], torque_frame, pos, normal, tangent],
        dim=-1,
    )
