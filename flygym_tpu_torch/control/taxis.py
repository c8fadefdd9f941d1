"""Visual taxis: retina-driven object following, batched over worlds
(config 4 of ``BASELINE.json``).

Port of ``flygym_tpu/control/taxis.py``. The compound eyes render the scene
at every control step; each eye's mean darkness is turned into an
asymmetric descending drive, and the CPG turns the asymmetry into a turn:
the legs on the side of the dark object slow down and shorten their
strides. Every world has its own vision, drive and CPG.
"""

from dataclasses import dataclass, field

import torch

from flygym_tpu_torch.control.cpg import CPGController, CPGState

__all__ = ["VisualTaxisController", "object_azimuth_drive"]


def object_azimuth_drive(vision: torch.Tensor, gain: float = 8.0,
                         base_drive: float = 1.0) -> torch.Tensor:
    """Per-leg drive steering toward the darker visual hemifield.

    Args:
        vision: (B, 2, n_ommatidia, 2) retina intensities (eye 0 = left).
        gain: Steering gain.
        base_drive: Forward drive when the stimulus is centred.

    Returns:
        (B, 6) drive per world and leg: a dark object on the left
        (``turn`` > 0) slows the left legs, the drives clipped to [0.2, 1.8]
        (``flygym_tpu/control/taxis.py:24-45``).
    """
    left_dark = 1.0 - vision[:, 0].mean(dim=(-2, -1))
    right_dark = 1.0 - vision[:, 1].mean(dim=(-2, -1))
    turn = gain * (left_dark - right_dark)
    left = torch.clamp(base_drive - turn, 0.2, 1.8)
    right = torch.clamp(base_drive + turn, 0.2, 1.8)
    # Leg order lf, lm, lh, rf, rm, rh: 1 on the left legs, made on the
    # device (a copy from the host would wait for the card's queue).
    mask = (torch.arange(6, device=vision.device) < 3).to(vision.dtype)
    return mask * left[:, None] + (1.0 - mask) * right[:, None]


@dataclass
class VisualTaxisController:
    """CPG walking steered by the retina, for B worlds at once.

    Args:
        cpg: the rhythmic pattern generator.
        retina: a :class:`~flygym_tpu_torch.vision.Retina` of the tracked
            fly; each world renders through
            :meth:`~flygym_tpu_torch.vision.Retina.make_render_batched` (the
            retina kernel K3 on the card, then the acceptance blur).
        gain: steering gain (drive asymmetry per unit brightness difference).
    """

    cpg: CPGController
    retina: object
    gain: float = 8.0
    _renders: dict = field(default_factory=dict, repr=False)

    def init_state(self, n_worlds: int, generator: torch.Generator | None = None) -> CPGState:
        return self.cpg.init_state(n_worlds, generator)

    def render_fn(self, model):
        """The batched render of ``model``: (B,) State → (B, 2, n_omm, 2),
        built once per model (it carries ``.kernel`` and ``.blur``)."""
        entry = self._renders.get(id(model))
        if entry is None:
            entry = self._renders[id(model)] = (model, self.retina.make_render_batched(model))
        return entry[1]

    def steer(self, cpg_state: CPGState, vision: torch.Tensor,
              drive: torch.Tensor | None = None):
        """Vision → drive → one CPG step: (new CPG state, joint targets (B,
        n_dofs), adhesion (B, 6), drive (B, 6)); ``drive`` replaces the
        vision's where given (a replay of another run's drives)."""
        if drive is None:
            drive = object_azimuth_drive(vision, self.gain)
        new_state, targets, adhesion = self.cpg(cpg_state, drive=drive)
        return new_state, targets, adhesion, drive

    def __call__(self, cpg_state: CPGState, model, sim_state, drive: torch.Tensor | None = None):
        """One control step: render → drive → CPG targets.

        Returns:
            (new CPG state, joint targets (B, n_dofs), adhesion (B, 6),
            vision (B, 2, n_omm, 2), drive (B, 6)).
        """
        vision = self.render_fn(model)(sim_state)
        new_state, targets, adhesion, drive = self.steer(cpg_state, vision, drive)
        return new_state, targets, adhesion, vision, drive
