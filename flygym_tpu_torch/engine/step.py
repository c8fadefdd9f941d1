"""The full physics step on a batch of worlds.

Port of ``flygym_tpu/engine/step.py`` (lines 36-185, 229-316):
FK → motion subspaces → velocities → spatial inertias → CRBA → RNEA bias →
passive and actuator forces (with the soft welds' restoring forces) →
contact solve → semi-implicit Euler with implicit joint damping (MuJoCo's
Euler integrator).

The cached outputs (xpos, sensors, ...) describe the configuration before
integration, as ``MjData`` does after ``mj_step``. Where the reference
scans an episode with ``lax.scan``, :func:`rollout` (one world) and
:func:`rollout_batched` are Python loops of eager steps.
"""

from dataclasses import replace
from functools import partial

import torch

from flygym_tpu_torch.engine import actuation, contact, dynamics, sensors
from flygym_tpu_torch.engine.kinematics import (
    dof_subspace,
    geom_poses,
    kinematics_full,
    velocity_pass,
)
from flygym_tpu_torch.engine.maths import norm, quat_conj, quat_integrate, quat_mul
from flygym_tpu_torch.engine.model import ActKind, PhysicsModel, State, compute_site_xpos
from flygym_tpu_torch.parallel.mesh import make_world_mesh, replicate_model

__all__ = ["make_step_fn", "make_step_sharded", "rollout", "rollout_batched", "step"]


def step(model: PhysicsModel, state: State, widx=None) -> State:
    """Advance every world of ``state`` by one timestep.

    Args:
        widx: Optional (B, n_groups) pinned winners of the compressed pair
            groups (group-local indices, e.g. from
            :func:`~flygym_tpu_torch.engine.contact.make_pair_winner_sampler`);
            None picks each group's nearest member in the step
            (``flygym_tpu/engine/step.py:36-41``).
    """
    dt = model.timestep
    qpos, qvel, ctrl = state.qpos, state.qvel, state.ctrl

    # ---- position stage ----
    xpos, xquat, hinge_xaxis = kinematics_full(model, qpos)
    ref = xpos[:, model.ref_body]
    S = dof_subspace(model, xpos, hinge_xaxis, ref)
    gpos, gquat = geom_poses(model, xpos, xquat)

    # ---- velocity stage ----
    cvel, cacc_bias = velocity_pass(model, qvel, xpos, S)

    # ---- inertia / bias ----
    I_body = dynamics.body_spatial_inertias(model, xpos, xquat, ref)
    M = dynamics.crba(model, I_body, S)
    qfrc_bias = dynamics.rnea_bias(model, I_body, S, cvel, cacc_bias)

    # ---- forces ----
    qfrc_passive = dynamics.passive_forces(model, qpos, qvel)
    qfrc_act, actuator_force = actuation.actuator_forces(
        model, qpos, qvel, ctrl, state.act
    )
    qfrc_smooth = qfrc_passive + qfrc_act - qfrc_bias
    if model.welds:
        qfrc_smooth = qfrc_smooth + _weld_forces(model, qpos, qvel, M)

    # Implicit joint damping: solve (M + h diag(B)) a = f (MuJoCo Euler).
    Mh = M + dt * torch.diag(model.dof_damping)

    # ---- contacts (adds adhesion forces, solves constraints) ----
    qacc, con_info = contact.solve_contacts(
        model, Mh, qfrc_smooth, qvel, state.qacc, xpos, S, gpos, gquat, ctrl, ref, widx
    )

    # ---- integrate ----
    qvel_new = qvel + dt * qacc
    qpos_new = _integrate_qpos(model, qpos, qvel_new, dt)
    act_new = actuation.integrate_act(model, state.act, ctrl, dt)

    # ---- cached outputs (pre-integration configuration) ----
    sensordata = sensors.contact_sensor_data(model, con_info, qpos.shape[0])
    if model.nu:
        # Adhesion actuators report the commanded force (MuJoCo semantics).
        actuator_force = torch.where(
            model.act_kind == ActKind.ADHESION,
            model.act_gain * actuation.clamp_ctrl(model, ctrl),
            actuator_force,
        )

    return State(
        qpos=qpos_new,
        qvel=qvel_new,
        ctrl=ctrl,
        act=act_new,
        time=state.time + dt,
        qacc=qacc,
        xpos=xpos,
        xquat=xquat,
        site_xpos=compute_site_xpos(model, xpos, xquat),
        actuator_force=actuator_force,
        contact_sensordata=sensordata,
    )


def _weld_forces(model: PhysicsModel, qpos, qvel, M):
    """The soft welds' restoring forces on their free roots (a
    ``TetheredWorld(weld="soft")``; ``flygym_tpu/engine/step.py:129-170``).

    MuJoCo's weld is a 6-row soft constraint with (solref, solimp)
    dynamics; the reference applies it as a penalty: the reference
    acceleration a_ref = -imp (k err + b vel) on the root's 6 DoFs, mapped
    to generalised forces through those columns of M, integrated
    explicitly. The rotation error is the world-frame small-rotation vector
    of q · conj(refquat), sign-fixed to the short arc.
    """
    qfrc = qpos.new_zeros((qpos.shape[0], model.nv))
    refpos, refquat, solimps = model.weld_ref
    for i, (_body, qadr, vadr, _pos, _quat, solref, solimp) in enumerate(model.welds):
        e_lin = qpos[:, qadr : qadr + 3] - refpos[i]
        q_err = quat_mul(qpos[:, qadr + 3 : qadr + 7], quat_conj(refquat[i]))
        e_rot = 2.0 * torch.sign(q_err[:, 0:1]) * q_err[:, 1:4]
        err = torch.cat([e_lin, e_rot], dim=-1)
        imp = contact._impedance(solimps[i], -norm(err))
        tc, dr = solref
        dmax = solimp[1]
        k = 1.0 / (dmax * dmax * tc * tc * dr * dr)
        b = 2.0 / (dmax * tc)
        a_ref = -imp[:, None] * (k * err + b * qvel[:, vadr : vadr + 6])
        qfrc = qfrc + (M[:, :, vadr : vadr + 6] @ a_ref[..., None])[..., 0]
    return qfrc


def _integrate_qpos(model: PhysicsModel, qpos, qvel, dt):
    """Semi-implicit Euler position update (quaternion-exact for free roots)."""
    qpos_new = qpos.clone()
    if model.nhinge:
        adr = model.hinge_qadr
        qpos_new[:, adr] = qpos[:, adr] + dt * qvel[:, model.hinge_vadr]
    for _body, qadr, vadr in model.free_joints:
        qpos_new[:, qadr : qadr + 3] = qpos[:, qadr : qadr + 3] + dt * qvel[:, vadr : vadr + 3]
        qpos_new[:, qadr + 3 : qadr + 7] = quat_integrate(
            qpos[:, qadr + 3 : qadr + 7], qvel[:, vadr + 3 : vadr + 6], dt
        )
    return qpos_new


def make_step_fn(model: PhysicsModel):
    """The step closed over ``model``: ``fn(state) -> state``
    (``flygym_tpu/engine/step.py:188-192``; torch has no buffer donation)."""
    return partial(step, model)


def rollout(model: PhysicsModel, state: State, ctrl_seq: torch.Tensor | None, n_steps: int,
            record: bool = True):
    """Step one world ``n_steps`` times (``flygym_tpu/engine/step.py:195-227``).

    Args:
        state: A one-world State (batch of 1, as :class:`~flygym_tpu_torch.
            Simulation` holds it).
        ctrl_seq: (n_steps, nu) controls per step; NaN entries keep the
            previous control. None holds the current controls.
        record: Stack the per-step qpos trajectory.

    Returns:
        (final state, (n_steps, nq) qpos trajectory or None).
    """
    if state.qpos.shape[0] != 1:
        raise ValueError(f"rollout steps one world, got a batch of {state.qpos.shape[0]}; "
                         "use rollout_batched")
    step_fn = make_step_sharded(model, make_world_mesh([state.qpos.device]))
    seqs = None if ctrl_seq is None else [ctrl_seq[:, None, :]]
    (final,), trajs = rollout_batched([state], seqs, n_steps, batched_step=step_fn,
                                      record=record)
    return final, (trajs[0][:, 0] if record else None)


def make_step_sharded(model: PhysicsModel, mesh):
    """The engine step over the world axis of ``mesh``: each shard's block
    of worlds stepped by :func:`step` on the model's copy on its device,
    as JAX's ``BatchSimulation`` jits its step with the state's shardings
    (``flygym_tpu/batch.py:100-104``). ``fn(states) -> states`` takes and
    gives a list of per-shard States
    (:func:`~flygym_tpu_torch.parallel.shard_world_axis`); a mesh of one
    device is the unsharded step."""
    models = replicate_model(model, mesh)

    def fn(states: list) -> list:
        if len(states) != mesh.size:
            raise ValueError(f"{len(states)} shards given for a mesh of {mesh.size}")
        return [step(m, s) for m, s in zip(models, states)]

    fn.sample_planes = None
    return fn


def _held(ctrl, ctrl_seq, t0: int, K: int) -> torch.Tensor:
    """The (K, B, nu) controls of steps t0 .. t0 + K - 1, NaN entries of
    ``ctrl_seq`` (or all of them, where it is None) holding the previous
    step's control, ``ctrl`` before the first."""
    eff = []
    for t in range(t0, t0 + K):
        if ctrl_seq is not None:
            ctrl = torch.where(torch.isnan(ctrl_seq[t]), ctrl, ctrl_seq[t])
        eff.append(ctrl)
    return torch.stack(eff)


def rollout_batched(states: list, ctrl_seq: list | None, n_steps: int, *, batched_step=None,
                    kstep_fn=None, record: bool = True, terrain_resample: int = 8):
    """Step the shards of a batch ``n_steps`` times: every shard is stepped
    (launched, on the card) at each step or chunk before the next, with no
    host read between. An unsharded batch is one shard.

    Args:
        states: The per-shard States
            (:func:`~flygym_tpu_torch.parallel.shard_world_axis`).
        ctrl_seq: The per-shard (n_steps, b, nu) controls per step; NaN
            entries keep the previous control. None holds the current
            controls throughout.
        batched_step: A one-step function over the shards:
            :func:`make_step_sharded`, or a K = 1
            :func:`~flygym_tpu_torch.ops.megastep.make_megastep_sharded`.
        kstep_fn: A K-step fused one (``make_megastep_sharded(model, mesh,
            K)``), in place of ``batched_step``; ``n_steps`` must be a
            multiple of its ``k_steps``. The loop then makes n_steps / K
            launches per shard, forward-filling the NaN controls of each
            chunk before its launch (``flygym_tpu/engine/step.py:256-277``).
        record: Stack the per-step qpos trajectory.
        terrain_resample: On a heightfield world, or one with compressed
            pair rows, a mega-step carries ``sample_planes``: the ground
            planes, the pair groups' winners, or on a heightfield world with
            compressed pair rows both in one tensor, that it reads for all
            its steps.
            The K-chunk path samples them once per chunk; the one-step path
            once every ``terrain_resample`` steps when that number (> 1)
            divides ``n_steps``, and otherwise the step samples them at
            every step (``flygym_tpu/engine/step.py:269, 283-308``).
            Candidates move ~1e-3 mm per step against 0.25 mm terrain cells.

    Returns:
        (per-shard final States, per-shard (n_steps, b, nq) qpos
        trajectories or None).
    """
    n = len(states)
    seqs = [None] * n if ctrl_seq is None else ctrl_seq
    trajs = [[] for _ in range(n)]
    if kstep_fn is not None:
        K = kstep_fn.k_steps
        if n_steps % K:
            raise ValueError(f"n_steps={n_steps} is not a multiple of k_steps={K}")
        sample_planes = getattr(kstep_fn, "sample_planes", None)
        for t0 in range(0, n_steps, K):
            eff = [_held(s.ctrl, c, t0, K) for s, c in zip(states, seqs)]
            if sample_planes is None:
                states, rows = kstep_fn(states, eff)
            else:
                states, rows = kstep_fn(states, eff, sample_planes(states))
            if record:
                for t, r in zip(trajs, rows):
                    t.append(r)
        return states, ([torch.cat(t) for t in trajs] if record else None)

    sample_planes = getattr(batched_step, "sample_planes", None)
    chunked = sample_planes is not None and terrain_resample > 1 and n_steps % terrain_resample == 0
    for t in range(n_steps):
        if chunked and t % terrain_resample == 0:
            planes = sample_planes(states)
        if ctrl_seq is not None:
            states = [replace(s, ctrl=torch.where(torch.isnan(c[t]), s.ctrl, c[t]))
                      for s, c in zip(states, seqs)]
        states = batched_step(states, planes) if chunked else batched_step(states)
        if record:
            for tr, s in zip(trajs, states):
                tr.append(s.qpos)
    return states, ([torch.stack(t) for t in trajs] if record else None)
