"""Batched multi-world simulation: N identical worlds stepped together.

Port of ``flygym_tpu/batch.py``. Every state tensor has a leading
``n_worlds`` axis, and the getters and setters work on (n_worlds, ...)
data. The engine is batch-first already, so where the JAX package vmaps its
per-world step, this class only sizes the batch. Its renderer's frames keep
the world axis: (n_selected, H, W, 3) of the ``world_ids`` chosen.
"""

from flygym_tpu_torch.simulation import Simulation
from flygym_tpu_torch.utils.profiling import print_perf_report_parallel

__all__ = ["BatchSimulation"]


class BatchSimulation(Simulation):
    """``n_worlds`` copies of one world on ``device`` (the card by default):
    a composed world, which it compiles, or a :class:`CompiledModel`;
    ``megastep``, ``megastep_k`` and ``terrain_resample`` as for
    :class:`Simulation`.

    Getters return (n_worlds, ...) tensors on ``device``; setters take
    (n,) values for every world or (n_worlds, n) per world.
    """

    _batched_frames = True

    def __init__(self, world, n_worlds: int, *, device="cuda",
                 megastep: bool | None = None, megastep_k: int = 8,
                 terrain_resample: int = 8) -> None:
        if n_worlds < 1:
            raise ValueError(f"n_worlds must be >= 1, got {n_worlds}")
        self.n_worlds = int(n_worlds)
        super().__init__(world, device=device, megastep=megastep, megastep_k=megastep_k,
                         terrain_resample=terrain_resample)

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
