"""Central pattern generator (CPG) locomotor control, batched over worlds.

Port of ``flygym_tpu/control/cpg.py``: six coupled phase oscillators, one
per leg, with amplitude dynamics,

    dθi/dt = 2π νi + Σj rj wij sin(θj − θi − φij)
    d²ri/dt² = α (α/4 (Ri − ri) − dri/dt),

tripod coupling ({lf, lh, rm} in phase, antiphase to {lm, rf, rh}), and
per-leg joint-angle step tables indexed by phase, extracted from the
Spotlight clip (:func:`extract_preprogrammed_steps`, numpy, as in the JAX
package). Adhesion is on in stance and off in swing.

The state is batched: (B, 6) tensors, one row per world. The arithmetic
repeats the JAX package's float32 rounding step for step: ``sin`` is
glibc's ``sinf`` (as XLA's CPU backend rounds it), the phase wraps as
``jnp.mod`` does (a truncated remainder with a sign fix), the coupling sum
runs over the legs in order, and the Python constants are rounded to
float32 where JAX rounds them.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from flygym_tpu_torch.engine.maths import sinf as _sinf
from flygym_tpu_torch.ops import checked_device

__all__ = [
    "tripod_phase_biases",
    "extract_preprogrammed_steps",
    "CPGNetwork",
    "CPGState",
    "CPGController",
]

# Canonical leg order: lf, lm, lh, rf, rm, rh.
# Group 0 = {lf, lh, rm}, group 1 = {lm, rf, rh}.
_TRIPOD_GROUP = np.array([0, 1, 0, 1, 0, 1])
_TWO_PI = 2 * math.pi


def tripod_phase_biases() -> np.ndarray:
    """(6, 6) phase bias matrix: 0 within a tripod group, π across groups."""
    same = _TRIPOD_GROUP[:, None] == _TRIPOD_GROUP[None, :]
    return np.where(same, 0.0, np.pi)


def extract_preprogrammed_steps(snippet, dof_order, *, n_bins: int = 64,
                                stride_freq_hz: float | None = None) -> dict:
    """Per-leg phase-indexed step tables from the recorded clip.

    The stride frequency comes from the autocorrelation of the front-leg
    signal; each leg's joint trajectories are folded over the stride and
    averaged per phase bin. Stance is labelled from the leg tip's height
    (the ``tarsus5`` keypoint's z in the ego frame): a leg is in stance
    where its tip is at most 5% above its median height.

    Args:
        snippet: a :class:`~flygym_tpu_torch.demo.spotlight.MotionSnippet`.
        dof_order: the simulator's actuated DoF order, as ``JointDOF``
            objects (``fly.get_actuated_jointdofs_order``) or as (leg, parent link,
            child link, axis) tuples (``Simulation.actuated_dofs``).

    Returns:
        dict with ``tables`` (6, n_bins, 7) angles, ``stance`` (6, n_bins)
        flags, ``freq_hz``, ``dof_map`` (n_dofs, 2) (leg, DoF slot) and
        ``neutral`` (6, 7) mean posture.
    """
    angles = snippet.joint_angles
    fps = snippet.data_fps
    T = angles.shape[0]

    if stride_freq_hz is None:
        sig = angles[:, 0, :].mean(axis=1)
        sig = sig - sig.mean()
        ac = np.correlate(sig, sig, mode="full")[T - 1:]
        lag_min = int(fps / 30)  # strides of at most 30 Hz
        lag_max = int(fps / 2)  # and at least 2 Hz
        lag = lag_min + int(np.argmax(ac[lag_min:lag_max]))
        stride_freq_hz = fps / lag

    phase = (np.arange(T) / fps * stride_freq_hz * 2 * np.pi) % (2 * np.pi)
    bins = np.minimum((phase / (2 * np.pi) * n_bins).astype(int), n_bins - 1)

    tables = np.zeros((6, n_bins, 7), np.float32)
    counts = np.zeros(n_bins, np.int64)
    np.add.at(counts, bins, 1)
    for b in range(n_bins):
        mask = bins == b
        if mask.any():
            tables[:, b, :] = angles[mask].mean(axis=0).astype(np.float32)
    for b in range(n_bins):  # empty bins take their nearest filled one
        if counts[b] == 0:
            nearest = np.argmin(
                np.minimum(np.abs(np.arange(n_bins) - b), counts.size) + 1e9 * (counts == 0)
            )
            tables[:, b, :] = tables[:, nearest, :]

    stance = np.zeros((6, n_bins), np.float32)
    tip_idx = []
    for leg in snippet.legs:
        matches = [
            i for i, kp in enumerate(snippet.keypoints)
            if isinstance(kp, tuple) and len(kp) >= 2 and kp[0] == leg
            and any("tarsus5" in str(p) for p in kp[1:])
        ]
        if matches:
            tip_idx.append(matches[0])
    if len(tip_idx) == 6:
        tip_z = snippet.fwdkin_egoxyz[:, tip_idx, 2]
        thresh = np.median(tip_z, axis=0, keepdims=True)
        grounded = (tip_z <= thresh + 0.05 * np.abs(thresh)).astype(np.float32)
        for b in range(n_bins):
            mask = bins == b
            if mask.any():
                stance[:, b] = grounded[mask].mean(axis=0)
        stance = (stance > 0.5).astype(np.float32)
    else:  # no tip keypoints: stance while the femur-tibia joint flexes
        for leg in range(6):
            sig = tables[leg, :, 2]
            stance[leg] = (sig < np.median(sig)).astype(np.float32)

    keys = [d if isinstance(d, tuple) else (d.child.pos, d.parent.link, d.child.link, d.axis.value)
            for d in dof_order]
    dof_map = np.array(
        [(snippet.legs.index(leg), snippet.dofs_per_leg.index((p, c, a)))
         for leg, p, c, a in keys],
        np.int32,
    )
    return {
        "tables": tables,
        "stance": stance,
        "freq_hz": float(stride_freq_hz),
        "dof_map": dof_map,
        "neutral": tables.mean(axis=1).astype(np.float32),
    }


def _f32(x: float) -> float:
    """A Python constant rounded to float32, as JAX rounds a weak scalar."""
    return float(np.float32(x))


def _mod_2pi(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mod(x, 2π)``: the truncated remainder, moved up by 2π where it
    is negative and not zero."""
    two_pi = _f32(_TWO_PI)
    r = torch.fmod(x, two_pi)
    return torch.where((r < 0.0) & (r != 0.0), r + two_pi, r)


@dataclass(frozen=True)
class CPGState:
    """Oscillator states of B worlds: (B, 6) float32 tensors."""

    phase: torch.Tensor
    amplitude: torch.Tensor
    damplitude: torch.Tensor

    @classmethod
    def init(cls, n_worlds: int, generator: torch.Generator | None = None,
             device="cuda") -> "CPGState":
        """Phases uniform in [0, 2π) from ``generator``; amplitudes at rest."""
        device = torch.device(device)
        phase = torch.rand((n_worlds, 6), generator=generator, device=device) * _f32(_TWO_PI)
        zeros = torch.zeros((n_worlds, 6), device=device)
        return cls(phase=phase, amplitude=zeros, damplitude=zeros.clone())

    @classmethod
    def from_numpy(cls, phase, amplitude, damplitude, device="cuda") -> "CPGState":
        """A state from (B, 6) arrays, e.g. a batch of the JAX package's
        ``CPGState`` arrays, on the card unless ``device`` says otherwise."""
        device = checked_device(device)
        t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        return cls(phase=t(phase), amplitude=t(amplitude), damplitude=t(damplitude))


@dataclass(frozen=True)
class CPGNetwork:
    """Coupled-oscillator parameters."""

    intrinsic_freq_hz: float = 12.0
    coupling_weight: float = 10.0
    convergence_rate: float = 20.0
    target_amplitude: float = 1.0
    phase_biases: np.ndarray = None  # (6, 6); None is the tripod gait

    def __post_init__(self):
        if self.phase_biases is None:
            object.__setattr__(self, "phase_biases", tripod_phase_biases())
        # The biases as a tensor per device, copied once: a copy from the
        # host at every step would wait for the card's queue to drain.
        object.__setattr__(self, "_phi", {})

    def step(self, state: CPGState, dt: float, drive=1.0) -> CPGState:
        """One Euler step of the oscillators of every world. ``drive``
        scales both the frequency and the target amplitude: a Python float
        for every leg of every world, or a (B, 6) tensor, one per world and
        leg (the visual taxis's steering).

        With a float, the products 2π f drive and R drive are Python
        arithmetic rounded once to float32, as JAX folds them; with a
        tensor, the constants are rounded to float32 first and multiplied
        in float32, as XLA multiplies a weak constant by an array."""
        theta, r = state.phase, state.amplitude
        phi = self._phi.get(theta.device)
        if phi is None:
            phi = self._phi[theta.device] = torch.as_tensor(
                np.asarray(self.phase_biases, np.float32), device=theta.device)
        # [b, i, j] = r_j w sin(θj − θi − φij), summed over j in leg order.
        terms = (r[:, None, :] * _f32(self.coupling_weight)) * _sinf(
            theta[:, None, :] - theta[:, :, None] - phi
        )
        coupling = terms[..., 0]
        for j in range(1, terms.shape[-1]):
            coupling = coupling + terms[..., j]
        if isinstance(drive, torch.Tensor):
            omega = _f32(2 * math.pi * self.intrinsic_freq_hz) * drive
            R = _f32(self.target_amplitude) * drive
        else:
            omega = _f32(2 * math.pi * self.intrinsic_freq_hz * drive)
            R = _f32(self.target_amplitude * drive)
        dtheta = omega + coupling
        a = self.convergence_rate
        ddr = _f32(a) * (_f32(a / 4.0) * (R - r) - state.damplitude)
        dt32 = _f32(dt)
        return CPGState(
            phase=_mod_2pi(theta + dt32 * dtheta),
            amplitude=r + dt32 * state.damplitude,
            damplitude=state.damplitude + dt32 * ddr,
        )


class CPGController:
    """The CPG network and the step tables → joint targets and adhesion,
    for B worlds at once."""

    def __init__(self, steps_data: dict, network: CPGNetwork | None = None, *,
                 timestep: float = 1e-4, device="cuda"):
        self.network = network or CPGNetwork(intrinsic_freq_hz=steps_data["freq_hz"])
        self.timestep = timestep
        self.device = checked_device(device)
        t = lambda a: torch.as_tensor(np.asarray(a), device=self.device)
        self.tables = t(steps_data["tables"])  # (6, n_bins, 7)
        self.stance = t(steps_data["stance"])  # (6, n_bins)
        self.neutral = t(steps_data["neutral"])  # (6, 7)
        self.dof_map = t(steps_data["dof_map"]).long()  # (n_dofs, 2)
        self.n_bins = self.tables.shape[1]
        self._legs = torch.arange(6, device=self.device)

    def init_state(self, n_worlds: int, generator: torch.Generator | None = None) -> CPGState:
        return CPGState.init(n_worlds, generator, self.device)

    def __call__(self, state: CPGState, drive=1.0):
        """Advance every world's CPG by one physics step; ``drive`` as for
        :meth:`CPGNetwork.step`.

        Returns:
            (new state, joint targets (B, n_dofs), adhesion controls (B, 6)).
        """
        new = self.network.step(state, self.timestep, drive)
        # A true division: on the card torch divides a tensor by a Python
        # float as a product with its reciprocal, which rounds otherwise
        # than JAX's division (up to 6e-8 in the phase's bin position).
        pos = new.phase / torch.full_like(new.phase, _f32(_TWO_PI)) * float(self.n_bins)
        fl = torch.floor(pos)
        b0 = torch.remainder(fl.to(torch.int32), self.n_bins).long()
        b1 = torch.remainder(b0 + 1, self.n_bins)
        w = (pos - fl)[..., None]  # (B, 6, 1)
        legs = self._legs
        ang = (1 - w) * self.tables[legs, b0] + w * self.tables[legs, b1]
        ang = self.neutral + new.amplitude[..., None] * (ang - self.neutral)
        targets = ang[:, self.dof_map[:, 0], self.dof_map[:, 1]]
        stance = (1 - w[..., 0]) * self.stance[legs, b0] + w[..., 0] * self.stance[legs, b1]
        adhesion = torch.where(stance > 0.5, 100.0, 1.0)
        return new, targets, adhesion
