"""Heightfield ground planes under the contact candidates.

Port of ``flygym_tpu/engine/terrain.py`` (lines 102-291). On a heightfield
world the mega-step kernel K2 takes, per contact candidate, the local
ground plane (height and unit normal) under the candidate's capsule end as
input rows, sampled outside the kernel from the state's cached pose
(``State.xpos``/``xquat``, the pre-integration forward kinematics of the
last step). The JAX package samples outside its Pallas kernel too, so plain
PyTorch is this module's port: the four-corner gather and the arithmetic of
its ``take`` method and ``finish`` (:func:`~flygym_tpu_torch.engine.
contact.ground_height_normal`).

Not ported (see ROADMAP "Not to port"): the ``onehot`` and ``window``
methods and ``candidate_group_windows``, one-hot matrix products that
select the same grid values exactly on a TPU's matrix unit.

``samples["planes"]`` counts calls of a sampler.
"""

import torch

from flygym_tpu_torch.engine.contact import candidate_endpoints, ground_height_normal
from flygym_tpu_torch.engine.kinematics import geom_poses
from flygym_tpu_torch.engine.model import PhysicsModel

__all__ = ["make_plane_sampler", "reset_samples", "samples"]

samples = {"planes": 0}


def reset_samples() -> None:
    samples["planes"] = 0


def make_plane_sampler(model: PhysicsModel):
    """``sample(xpos, xquat) -> (B, ncand, 4)`` rows [h, nx, ny, nz] of the
    ground under each candidate, from batched body poses (B, nbody, 3/4);
    None for a flat world."""
    if not model.has_hfield:
        return None

    def sample(xpos: torch.Tensor, xquat: torch.Tensor) -> torch.Tensor:
        gpos, gquat = geom_poses(model, xpos, xquat)
        h, n = ground_height_normal(model, candidate_endpoints(model, gpos, gquat)[..., :2])
        samples["planes"] += 1
        return torch.cat([h[..., None], n], dim=-1)

    return sample
