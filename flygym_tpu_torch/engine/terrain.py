"""Heightfield ground planes under the contact candidates.

Port of ``flygym_tpu/engine/terrain.py`` (lines 102-291). On a heightfield
world the mega-step kernel K2 takes, per contact candidate, the local
ground plane (height and unit normal) under the candidate's capsule end as
input rows, sampled outside the kernel from the state's cached pose
(``State.xpos``/``xquat``, the pre-integration forward kinematics of the
last step). The JAX package samples outside its Pallas kernel too, so plain
PyTorch is this module's port: the four-corner gather of its ``take``
method and the arithmetic of ``endpoints_xy`` and ``finish``.

The JAX package jits its sampler, and XLA's CPU backend contracts a
multiply feeding an add or a subtract into one fused multiply-add (LLVM's
DAG combiner; which product of a sum it fuses depends on the program, and
the pairs below are those of the JAX sampler as the goldens jit it). So the
quaternion products and rotations of the capsule ends, the bilinear height
and slopes, and the normal's squared length round once per such pair here
too (:func:`~flygym_tpu_torch.engine.maths.fma32`); the grid values are exact
selections in both.

Not ported (see ROADMAP "Not to port"): the ``onehot`` and ``window``
methods and ``candidate_group_windows``, one-hot matrix products that
select the same grid values exactly on a TPU's matrix unit.

``samples["planes"]`` counts calls of a sampler.
"""

import torch

from flygym_tpu_torch.engine.maths import fma32
from flygym_tpu_torch.engine.model import PhysicsModel

__all__ = ["make_plane_sampler", "reset_samples", "samples"]

samples = {"planes": 0}


def reset_samples() -> None:
    samples["planes"] = 0


def _cross(a, b):
    """a × b as XLA fuses ``jnp.cross``: fma(a1, b2, -(a2 b1)), ..."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([fma32(a1, b2, -(a2 * b1)), fma32(a2, b0, -(a0 * b2)),
                        fma32(a0, b1, -(a1 * b0))], dim=-1)


def _quat_rotate(q, v):
    """``quat_rotate`` fused: v + 2 (qw uv + qv × uv), uv = qv × v."""
    qw, qv = q[..., :1], q[..., 1:]
    uv = _cross(qv, v)
    t = fma32(qw, uv, _cross(qv, uv))
    return fma32(torch.full_like(t, 2.0), t, v)


def _quat_mul(a, b):
    """``quat_mul`` fused: each component a chain of fused multiply-adds
    from its first two products on."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        fma32(-az, bz, fma32(-ay, by, fma32(aw, bw, -(ax * bx)))),
        fma32(-az, by, fma32(ay, bz, fma32(aw, bx, ax * bw))),
        fma32(az, bx, fma32(ay, bw, fma32(aw, by, -(ax * bz)))),
        fma32(az, bw, fma32(-ay, bx, fma32(aw, bz, ax * by))),
    ], dim=-1)


def make_plane_sampler(model: PhysicsModel):
    """``sample(xpos, xquat) -> (B, ncand, 4)`` rows [h, nx, ny, nz] of the
    ground under each candidate, from batched body poses (B, nbody, 3/4),
    rounded as the JAX package's jitted sampler rounds them; None for a
    flat world."""
    if not model.has_hfield:
        return None
    g = model.can_geom
    body, gpos_l, gquat_l = model.geom_body[g], model.geom_pos[g], model.geom_quat[g]
    end = (model.can_end * model.geom_size[g, 1])[:, None]
    data = model.hfield_data
    nr, nc = data.shape
    # The clip bounds as float32, like the JAX package's weak-typed ones.
    hi_x = float(torch.tensor(nc - 1.001, dtype=torch.float32))
    hi_y = float(torch.tensor(nr - 1.001, dtype=torch.float32))

    def sample(xpos: torch.Tensor, xquat: torch.Tensor) -> torch.Tensor:
        q = xquat[:, body]
        gpos = xpos[:, body] + _quat_rotate(q, gpos_l)
        # The z axis made on the device: a copy from the host would wait
        # for the card's queue to drain.
        ez = torch.cat([xpos.new_zeros(2), xpos.new_ones(1)]).expand(gpos.shape)
        ep = fma32(end.expand(gpos.shape), _quat_rotate(_quat_mul(q, gquat_l), ez), gpos)
        fx = torch.clamp((ep[..., 0] - model.hfield_xy0[0]) / model.hfield_cell[0], 0.0, hi_x)
        fy = torch.clamp((ep[..., 1] - model.hfield_xy0[1]) / model.hfield_cell[1], 0.0, hi_y)
        ix, iy = torch.floor(fx), torch.floor(fy)
        tx, ty = fx - ix, fy - iy
        ix, iy = ix.long(), iy.long()
        h00, h01 = data[iy, ix], data[iy, ix + 1]
        h10, h11 = data[iy + 1, ix], data[iy + 1, ix + 1]
        sx, sy = 1 - tx, 1 - ty
        h = fma32(h11 * tx, ty, fma32(h10 * sx, ty, fma32(h00 * sx, sy, (h01 * tx) * sy)))
        dh_dx = fma32(h11 - h10, ty, (h01 - h00) * sy) / model.hfield_cell[0]
        dh_dy = fma32(h11 - h01, tx, (h10 - h00) * sx) / model.hfield_cell[1]
        n = torch.stack([-dh_dx, -dh_dy, torch.ones_like(h)], dim=-1)
        sq = fma32(n[..., 2], n[..., 2], fma32(n[..., 1], n[..., 1], n[..., 0] * n[..., 0]))
        samples["planes"] += 1
        return torch.cat([h[..., None], n / torch.sqrt(sq.double()).float()[..., None]], dim=-1)

    return sample
