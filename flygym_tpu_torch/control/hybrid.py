"""Hybrid controller: the CPG plus reflexes from mechanosensory feedback.

Port of ``flygym_tpu/control/hybrid.py``, batched over worlds (config 3 of
``BASELINE.json``, the hybrid controller on rugged terrain). The CPG gives
the rhythm; two reflex rules correct it per leg:

- **retraction**: a leg whose tip is markedly lower than the third-lowest
  tip (stuck in a gap) is lifted;
- **stumbling**: a leg whose contact force opposes the heading is lifted
  to step over the obstacle.

Each correction is a leaky accumulator (up at a rate while its trigger
holds, decaying otherwise), applied as a joint-angle offset along per-leg
correction vectors; a leg lifted by more than 0.2 releases its adhesion.
"""

from dataclasses import dataclass

import numpy as np
import torch

from flygym_tpu_torch.control.cpg import CPGController, CPGState, _f32

__all__ = ["HybridController", "HybridState"]


@dataclass(frozen=True)
class HybridState:
    """The CPG's state and the two corrections, (B, 6) each."""

    cpg: CPGState
    retraction: torch.Tensor
    stumbling: torch.Tensor

    @classmethod
    def init(cls, n_worlds: int, generator: torch.Generator | None = None,
             device="cuda") -> "HybridState":
        cpg = CPGState.init(n_worlds, generator, device)
        return cls(cpg=cpg, retraction=torch.zeros_like(cpg.phase),
                   stumbling=torch.zeros_like(cpg.phase))

    @classmethod
    def from_numpy(cls, arrays: dict, device="cuda") -> "HybridState":
        """A state from (B, 6) arrays named ``phase``, ``amplitude``,
        ``damplitude``, ``retraction`` and ``stumbling`` (a batch of the JAX
        package's ``HybridState``), on the card unless ``device`` says
        otherwise."""
        cpg = CPGState.from_numpy(arrays["phase"], arrays["amplitude"], arrays["damplitude"],
                                  device=device)
        t = lambda a: torch.tensor(np.asarray(a, np.float32), device=cpg.phase.device)
        return cls(cpg=cpg, retraction=t(arrays["retraction"]), stumbling=t(arrays["stumbling"]))


@dataclass
class HybridController:
    """A :class:`CPGController` with the retraction and stumbling rules.

    Args:
        cpg: the rhythm generator.
        correction_vectors: (6, 7) per-leg joint-space lift direction; None
            raises the trochanter-femur pitch and flexes the tibia.
        retraction_rate, stumbling_rate: accumulation rates (1/s).
        decay_rate: decay of a correction whose trigger is off (1/s).
        retraction_margin: how far (mm) below the third-lowest tip triggers.
        stumble_force_threshold: the opposing force that triggers.
    """

    cpg: CPGController
    correction_vectors: np.ndarray = None
    retraction_rate: float = 800.0
    stumbling_rate: float = 900.0
    decay_rate: float = 160.0
    retraction_margin: float = 0.05
    stumble_force_threshold: float = 1.0
    max_correction: float = 1.0

    def __post_init__(self):
        if self.correction_vectors is None:
            vec = np.zeros((6, 7), np.float32)
            vec[:, 3] = -0.8  # trochanter-femur pitch up
            vec[:, 5] = 0.5  # tibia flexion
            self.correction_vectors = vec
        dev = self.cpg.device
        self._vec = torch.as_tensor(np.asarray(self.correction_vectors, np.float32), device=dev)
        # exp(-decay dt) in float32, as JAX evaluates it on a weak scalar.
        self._decay = torch.exp(torch.tensor(-self.decay_rate * self.cpg.timestep,
                                             dtype=torch.float32)).item()

    def init_state(self, n_worlds: int, generator: torch.Generator | None = None) -> HybridState:
        return HybridState.init(n_worlds, generator, self.cpg.device)

    def __call__(self, state: HybridState, tip_heights: torch.Tensor,
                 contact_forces: torch.Tensor, heading: torch.Tensor, drive: float = 1.0):
        """Advance every world by one physics step.

        Args:
            state: the controllers' state.
            tip_heights: (B, 6) leg tip z.
            contact_forces: (B, 6, 3) per-leg contact force in world axes.
            heading: (B, 3) unit forward vector of each fly.

        Returns:
            (new state, joint targets (B, n_dofs), adhesion controls (B, 6)).
        """
        dt = self.cpg.timestep
        cpg_state, targets, adhesion = self.cpg(state.cpg, drive)

        third_lowest = torch.sort(tip_heights, dim=-1).values[..., 2:3]
        stuck = tip_heights < third_lowest - _f32(self.retraction_margin)
        retraction = torch.where(stuck, state.retraction + _f32(self.retraction_rate * dt),
                                 state.retraction * self._decay)
        retraction = torch.clamp(retraction, 0.0, self.max_correction)

        f, h = contact_forces, heading[..., None, :]
        opposing = -(f[..., 0] * h[..., 0] + f[..., 1] * h[..., 1] + f[..., 2] * h[..., 2])
        stumbled = opposing > _f32(self.stumble_force_threshold)
        stumbling = torch.where(stumbled, state.stumbling + _f32(self.stumbling_rate * dt),
                                state.stumbling * self._decay)
        stumbling = torch.clamp(stumbling, 0.0, self.max_correction)

        correction = torch.maximum(retraction, stumbling)
        offsets = correction[..., None] * self._vec
        dof_map = self.cpg.dof_map
        targets = targets + offsets[:, dof_map[:, 0], dof_map[:, 1]]
        adhesion = torch.where(correction > 0.2, 1.0, adhesion)
        return HybridState(cpg=cpg_state, retraction=retraction, stumbling=stumbling), targets, adhesion
