"""Actuator force models and activation dynamics, batch-first.

Port of ``flygym_tpu/engine/actuation.py``: the eight MuJoCo actuator kinds
(motor, position, velocity, intvelocity, damper, cylinder, muscle,
adhesion) with their force limits. Joint-transmission actuators give
generalised forces here; adhesion actuators act inside the contact solver,
along the contact normals. The muscle is MuJoCo's: normalised
force-length and force-velocity curves, a quadratic passive force, peak
force from the compile-time ``acc0`` when ``force < 0``, and first-order
activation dynamics with activation-dependent time constants.
"""

import torch

from flygym_tpu_torch.engine.model import ActKind, PhysicsModel

__all__ = ["clamp_ctrl", "actuator_forces", "integrate_act"]

_EPS = 1e-9


def _select(conds, values, default):
    """``jnp.select``: the value of the first condition that holds."""
    out = default
    for cond, value in reversed(list(zip(conds, values))):
        out = torch.where(cond, value, out)
    return out


def clamp_ctrl(model: PhysicsModel, ctrl: torch.Tensor) -> torch.Tensor:
    """Controls clipped to their range where the actuator is ctrl-limited."""
    lo, hi = model.act_ctrlrange[:, 0], model.act_ctrlrange[:, 1]
    return torch.where(
        model.act_ctrllimited > 0, torch.minimum(torch.maximum(ctrl, lo), hi), ctrl
    )


def _muscle_gain_length(L, lmin, lmax):
    """Normalised active force-length curve (a piecewise quadratic bump)."""
    a = 0.5 * (lmin + 1.0)
    b = 0.5 * (1.0 + lmax)
    x_rise = (L - lmin) / torch.clamp(a - lmin, min=_EPS)
    x_peak_lo = (1.0 - L) / torch.clamp(1.0 - a, min=_EPS)
    x_peak_hi = (L - 1.0) / torch.clamp(b - 1.0, min=_EPS)
    x_fall = (lmax - L) / torch.clamp(lmax - b, min=_EPS)
    zero = torch.zeros_like(L)
    return _select(
        [L <= lmin, L <= a, L <= 1.0, L <= b, L <= lmax],
        [zero, 0.5 * (x_rise * x_rise), 1.0 - 0.5 * (x_peak_lo * x_peak_lo),
         1.0 - 0.5 * (x_peak_hi * x_peak_hi), 0.5 * (x_fall * x_fall)],
        zero,
    )


def _muscle_gain_velocity(V, fvmax):
    """Normalised force-velocity curve."""
    y = fvmax - 1.0
    return _select(
        [V <= -1.0, V <= 0.0, V <= y],
        [torch.zeros_like(V), (V + 1.0) * (V + 1.0),
         fvmax - (y - V) * (y - V) / torch.clamp(y, min=_EPS)],
        torch.zeros_like(V) + fvmax,
    )


def _muscle_forces(model: PhysicsModel, length, vel):
    """Active gain per unit activation and passive bias of every actuator
    as a muscle, (B, nu) each."""
    prm = model.act_muscleprm
    range0, range1 = prm[:, 0], prm[:, 1]
    force, scale = prm[:, 2], prm[:, 3]
    lmin, lmax, vmax = prm[:, 4], prm[:, 5], prm[:, 6]
    fpmax, fvmax = prm[:, 7], prm[:, 8]
    lr0, lr1 = model.act_lengthrange[:, 0], model.act_lengthrange[:, 1]

    L0 = (lr1 - lr0) / torch.clamp(range1 - range0, min=_EPS)
    L = range0 + (length - lr0) / torch.clamp(L0, min=_EPS)
    V = vel / torch.clamp(L0 * vmax, min=_EPS)
    # The peak force from the acceleration scale where force < 0 (MuJoCo).
    peak = torch.where(force < 0, scale / torch.clamp(model.act_acc0, min=_EPS), force)

    gain = -peak * _muscle_gain_length(L, lmin, lmax) * _muscle_gain_velocity(V, fvmax)
    b = 0.5 * (1.0 + lmax)
    x_ramp = (L - 1.0) / torch.clamp(b - 1.0, min=_EPS)
    x_lin = (L - b) / torch.clamp(b - 1.0, min=_EPS)
    bias = _select(
        [L <= 1.0, L <= b],
        [torch.zeros_like(L), -peak * fpmax * 0.5 * (x_ramp * x_ramp)],
        -peak * fpmax * (0.5 + x_lin),
    )
    return gain, bias


def actuator_forces(model: PhysicsModel, qpos, qvel, ctrl, act):
    """Per-actuator scalar forces and the generalised force vector.

    Returns:
        qfrc_actuator: (B, nv)
        actuator_force: (B, nu); adhesion rows are 0 here and filled by the
            step with the commanded force.
    """
    B = qpos.shape[0]
    if model.nu == 0:
        return qpos.new_zeros((B, model.nv)), qpos.new_zeros((B, 0))

    c = clamp_ctrl(model, ctrl)
    hs = torch.clamp(model.act_hinge, min=0)
    q = qpos[:, model.hinge_qadr[hs]]
    v = qvel[:, model.hinge_vadr[hs]]
    gain, kv = model.act_gain, model.act_kv
    a_slot = act[:, torch.clamp(model.act_actadr, min=0)] if model.na else torch.zeros_like(c)
    m_gain, m_bias = _muscle_forces(model, q, v)

    kind = model.act_kind
    force = _select(
        [kind == k for k in (ActKind.MOTOR, ActKind.POSITION, ActKind.VELOCITY,
                             ActKind.INTVELOCITY, ActKind.DAMPER, ActKind.CYLINDER,
                             ActKind.MUSCLE)],
        [gain * c, gain * (c - q) - kv * v, gain * (c - v), gain * (a_slot - q) - kv * v,
         -gain * c * v, gain * a_slot, m_gain * a_slot + m_bias],
        torch.zeros_like(c),  # adhesion: applied in the contact solver
    )
    flo, fhi = model.act_forcerange[:, 0], model.act_forcerange[:, 1]
    force = torch.where(
        model.act_forcelimited > 0, torch.minimum(torch.maximum(force, flo), fhi), force
    )

    joint_force = torch.where(model.act_hinge >= 0, force, torch.zeros_like(force))
    qfrc = qpos.new_zeros((B, model.nv)).index_add(1, model.hinge_vadr[hs], joint_force)
    return qfrc, force


def integrate_act(model: PhysicsModel, act, ctrl, dt):
    """Advance the activation states (B, na) by one step from the controls
    and the activations at the start of the step.

    - intvelocity: act += dt ctrl (the integrated velocity target);
    - cylinder: a first-order filter toward ctrl, time constant dynprm[0];
    - muscle: MuJoCo's activation dynamics, with the activation time
      constant dynprm[0] and the deactivation one dynprm[1] each scaled by
      the activation, the result kept in [0, 1].
    """
    if model.na == 0:
        return act
    adr = torch.clamp(model.act_actadr, min=0)
    has_slot = model.act_actadr >= 0
    c = clamp_ctrl(model, ctrl)
    a = act[:, adr]

    d_intvel = dt * c
    tau_cyl = torch.clamp(model.act_dynprm[:, 0], min=_EPS)
    d_cyl = dt * (c - a) / tau_cyl
    cm = torch.clamp(c, 0.0, 1.0)
    tau_act = torch.clamp(model.act_dynprm[:, 0], min=_EPS)
    tau_deact = torch.clamp(model.act_dynprm[:, 1], min=_EPS)
    tau = torch.where(cm > a, tau_act * (0.5 + 1.5 * a), tau_deact / (0.5 + 1.5 * a))
    d_muscle = dt * (cm - a) / torch.clamp(tau, min=_EPS)

    kind = model.act_kind
    delta = _select(
        [kind == ActKind.INTVELOCITY, kind == ActKind.CYLINDER, kind == ActKind.MUSCLE],
        [d_intvel, d_cyl, d_muscle],
        torch.zeros_like(c),
    )
    delta = torch.where(has_slot, delta, torch.zeros_like(delta))
    new_act = act.index_add(1, adr, delta)
    # A slot is clamped where the last actuator that maps to it is a muscle
    # with a slot: the reference's scatter (``.at[adr].set``) lets the last
    # write win, and the slotless actuators (adhesion, actadr -1) map to
    # slot 0, so a muscle that owns slot 0 loses its clamp to an adhesion
    # actuator after it. JAX's emitter clamps every muscle slot; the
    # reference's engine and emitter differ there, and this is the engine.
    last = torch.full((model.na,), -1, dtype=torch.int64, device=act.device).scatter_reduce(
        0, adr, torch.arange(model.nu, device=act.device), reduce="amax")
    muscle = has_slot & (kind == ActKind.MUSCLE)
    is_muscle_slot = (last >= 0) & muscle[torch.clamp(last, min=0)]
    return torch.where(is_muscle_slot, torch.clamp(new_act, 0.0, 1.0), new_act)
