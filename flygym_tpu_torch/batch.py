"""Batched multi-world simulation: N identical worlds stepped together.

Port of ``flygym_tpu/batch.py``. Every state tensor has a leading
``n_worlds`` axis, and the getters and setters work on (n_worlds, ...)
data. The engine is batch-first already, so where the JAX package vmaps its
per-world step, this class only sizes the batch. Its renderer's frames keep
the world axis: (n_selected, H, W, 3) of the ``world_ids`` chosen.

With ``mesh=`` the worlds are split over the mesh's devices
(:mod:`flygym_tpu_torch.parallel`): the model is copied to each device, the
state is kept as one block of worlds per shard, and every step runs on each
shard with no operation across shards (K2 once per shard, or the engine
step with K1 and K1b per shard).
"""

import torch

from flygym_tpu_torch.parallel.mesh import canonical_device
from flygym_tpu_torch.simulation import Simulation
from flygym_tpu_torch.utils.profiling import print_perf_report_parallel

__all__ = ["BatchSimulation"]


class BatchSimulation(Simulation):
    """``n_worlds`` copies of one world on ``device`` (the card by default):
    a composed world, which it compiles, or a :class:`CompiledModel`;
    ``megastep``, ``megastep_k`` and ``terrain_resample`` as for
    :class:`Simulation`.

    Args:
        mesh: A :class:`~flygym_tpu_torch.parallel.WorldMesh` to split the
            worlds over; ``n_worlds`` must be a multiple of its size. The
            model, the initial state and the readouts are then on the mesh's
            first device, which ``device`` may name (None takes it).

    Without ``mesh`` the worlds are one shard on ``device``. Getters return
    (n_worlds, ...) tensors on ``device``; setters take (n,) values for
    every world or (n_worlds, n) per world. On a mesh the
    getters, ``state`` and ``rollout``'s trajectory join the shards on the
    mesh's first device (the JAX package returns arrays sharded over the
    mesh there); setting ``state`` splits the given state over the mesh.
    """

    _batched_frames = True

    def __init__(self, world, n_worlds: int, *, device=None, mesh=None,
                 megastep: bool | None = None, megastep_k: int = 8,
                 terrain_resample: int = 8) -> None:
        if n_worlds < 1:
            raise ValueError(f"n_worlds must be >= 1, got {n_worlds}")
        self.n_worlds = int(n_worlds)
        self.mesh = mesh
        if mesh is not None:
            if n_worlds % mesh.size != 0:
                raise ValueError(
                    f"n_worlds={n_worlds} not divisible by mesh axis "
                    f"'{mesh.axis_name}' of size {mesh.size}"
                )
            if device is not None and canonical_device(torch.device(device)) != mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's first device "
                                 f"{mesh.devices[0]}")
            device = mesh.devices[0]
        super().__init__(world, device="cuda" if device is None else device, megastep=megastep,
                         megastep_k=megastep_k, terrain_resample=terrain_resample)

    def _batch(self, state):
        return state.map(lambda x: x.expand((self.n_worlds,) + x.shape[1:]).clone())

    def _out(self, x):
        return x

    def print_performance_report(self, show_in_notebook="auto") -> None:
        """The parallel report (aggregate columns times ``n_worlds``,
        ``flygym_tpu/batch.py:297-313``), with the renderer's worlds."""
        print_perf_report_parallel(
            n_steps=self._curr_step,
            n_frames_rendered=self._frames_rendered,
            total_physics_time_ns=self._total_physics_time_ns,
            total_render_time_ns=self._total_render_time_ns,
            timestep=self.timestep,
            n_worlds=self.n_worlds,
            n_worlds_rendered=0 if self.renderer is None else len(self.renderer.world_ids),
            show_in_notebook=show_in_notebook,
        )
