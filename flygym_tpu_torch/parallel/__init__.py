"""Worlds split over several devices (``flygym_tpu/parallel``' counterpart)."""

from flygym_tpu_torch.parallel.mesh import (
    WorldMesh,
    gather_world_axis,
    make_world_mesh,
    replicate_model,
    shard_world_axis,
)

__all__ = ["WorldMesh", "gather_world_axis", "make_world_mesh", "replicate_model",
           "shard_world_axis"]
