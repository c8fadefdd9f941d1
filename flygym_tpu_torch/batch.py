"""Batched multi-world simulation: N identical worlds stepped together.

Port of ``flygym_tpu/batch.py``. Every state tensor has a leading
``n_worlds`` axis, and the getters and setters work on (n_worlds, ...)
data. The engine is batch-first already, so where the JAX package vmaps its
per-world step, this class only sizes the batch.
"""

from flygym_tpu_torch.compose.bridge import CompiledModel
from flygym_tpu_torch.simulation import Simulation

__all__ = ["BatchSimulation"]


class BatchSimulation(Simulation):
    """``n_worlds`` copies of one compiled world on ``device`` (the card by
    default); ``megastep``, ``megastep_k`` and ``terrain_resample`` as for
    :class:`Simulation`.

    Getters return (n_worlds, ...) tensors on ``device``; setters take
    (n,) values for every world or (n_worlds, n) per world.
    """

    def __init__(self, compiled: CompiledModel, n_worlds: int, *, device="cuda",
                 megastep: bool | None = None, megastep_k: int = 8,
                 terrain_resample: int = 8) -> None:
        if n_worlds < 1:
            raise ValueError(f"n_worlds must be >= 1, got {n_worlds}")
        self.n_worlds = int(n_worlds)
        super().__init__(compiled, device=device, megastep=megastep, megastep_k=megastep_k,
                         terrain_resample=terrain_resample)

    def _batch(self, state):
        return state.map(lambda x: x.expand((self.n_worlds,) + x.shape[1:]).clone())

    def _out(self, x):
        return x
