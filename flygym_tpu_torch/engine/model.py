"""Static physics model and batched simulation state.

Port of ``flygym_tpu/engine/model.py``. A :class:`PhysicsModel` holds the
compiled world as tensors (float32 values, int64 indices) plus the static
metadata as Python values; a :class:`State` holds the dynamic state of a
batch of worlds, batch-first: every field has a leading world axis (B, ...),
and one world is B = 1. Both are frozen dataclasses with ``.to(device)``.
"""

from dataclasses import dataclass, fields

import torch

from flygym_tpu_torch.engine.linalg import LdlTables, tensors_to

__all__ = [
    "PhysicsModel",
    "State",
    "ActKind",
    "make_initial_state",
    "compute_site_xpos",
]


class ActKind:
    """Integer codes for actuator kinds (same values as the JAX package)."""

    MOTOR = 0
    POSITION = 1
    VELOCITY = 2
    INTVELOCITY = 3
    DAMPER = 4
    ADHESION = 5
    CYLINDER = 6
    MUSCLE = 7


@dataclass(frozen=True)
class PhysicsModel:
    """Compiled, static description of a world.

    The fields and their index conventions are those of the JAX
    ``PhysicsModel`` (``flygym_tpu/engine/model.py:57-236``), with two
    changes: ``ancestor_jumps`` is a tuple of int64 index tensors, so that FK
    gathers with tensors already on the model's device, and ``ldl`` adds the
    tree-LDL tables built from ``dof_chains`` and the level lists.
    """

    # ---- static metadata ----
    nbody: int
    nq: int
    nv: int
    nu: int
    na: int
    nhinge: int
    nsite: int
    ngeom: int
    ncand: int
    ncand_pair: int
    pair_groups: tuple
    pair_compress: bool
    ncon: int
    condim: int
    nsensor_contact: int
    timestep: float
    solver_type: str
    solver_iterations: int
    solver_exact: bool
    solver_relaxation: float
    differentiable: bool
    levels: tuple
    ancestor_jumps: tuple
    ref_body: int
    free_joints: tuple
    dof_height_levels: tuple
    dof_depth_levels: tuple
    dof_chains: tuple
    geom_types: tuple
    has_hfield: bool
    welds: tuple

    # ---- bodies ----
    gravity: torch.Tensor
    body_parent: torch.Tensor
    body_pos: torch.Tensor
    body_quat: torch.Tensor
    body_mass: torch.Tensor
    body_ipos: torch.Tensor
    body_iquat: torch.Tensor
    body_inertia: torch.Tensor
    body_hinge_idx: torch.Tensor
    body_free_qadr: torch.Tensor
    body_free_vadr: torch.Tensor
    body_subtree_mask: torch.Tensor

    # ---- hinge joints ----
    hinge_body: torch.Tensor
    hinge_slot: torch.Tensor
    hinge_axis: torch.Tensor
    hinge_qadr: torch.Tensor
    hinge_vadr: torch.Tensor
    hinge_stiffness: torch.Tensor
    hinge_damping: torch.Tensor
    hinge_springref: torch.Tensor

    # ---- full DoF space ----
    dof_body: torch.Tensor
    dof_armature: torch.Tensor
    dof_damping: torch.Tensor
    dof_ancestor_mask: torch.Tensor
    dof_anc: torch.Tensor

    # ---- geoms ----
    geom_body: torch.Tensor
    geom_pos: torch.Tensor
    geom_quat: torch.Tensor
    geom_size: torch.Tensor
    geom_rgba: torch.Tensor
    geom_matprops: torch.Tensor
    geom_tex: torch.Tensor

    # ---- contact candidates ----
    can_geom: torch.Tensor
    can_body: torch.Tensor
    can_geom2: torch.Tensor
    can_body2: torch.Tensor
    can_end: torch.Tensor
    can_friction: torch.Tensor
    can_solref: torch.Tensor
    can_solimp: torch.Tensor
    can_margin: torch.Tensor
    can_adh_act: torch.Tensor
    can_sensor: torch.Tensor
    can_invweight: torch.Tensor
    ground_pos: torch.Tensor
    ground_normal: torch.Tensor
    hfield_data: torch.Tensor
    hfield_xy0: torch.Tensor
    hfield_cell: torch.Tensor

    # ---- actuators ----
    act_kind: torch.Tensor
    act_hinge: torch.Tensor
    act_body: torch.Tensor
    act_gain: torch.Tensor
    act_kv: torch.Tensor
    act_ctrlrange: torch.Tensor
    act_ctrllimited: torch.Tensor
    act_forcerange: torch.Tensor
    act_forcelimited: torch.Tensor
    act_actadr: torch.Tensor
    act_dynprm: torch.Tensor
    act_muscleprm: torch.Tensor
    act_lengthrange: torch.Tensor
    act_acc0: torch.Tensor

    # ---- sites ----
    site_body: torch.Tensor
    site_pos: torch.Tensor

    # ---- neutral keyframe ----
    qpos0: torch.Tensor
    ctrl0: torch.Tensor

    # ---- tree-LDL tables (port only) ----
    ldl: LdlTables

    # ---- the soft welds' refpos (n, 3), refquat (n, 4) and solimp (n, 5)
    # from ``welds``, as tensors on the model's device (port only) ----
    weld_ref: tuple

    @property
    def device(self) -> torch.device:
        return self.qpos0.device

    def to(self, device) -> "PhysicsModel":
        return tensors_to(self, device)


@dataclass(frozen=True)
class State:
    """Dynamic state of a batch of worlds (the ``MjData`` analog).

    Fields after ``time`` are outputs cached by the last ``step``.
    """

    qpos: torch.Tensor  # (B, nq)
    qvel: torch.Tensor  # (B, nv)
    ctrl: torch.Tensor  # (B, nu)
    act: torch.Tensor  # (B, na)
    time: torch.Tensor  # (B,) float32
    qacc: torch.Tensor  # (B, nv) last acceleration (solver warm start)
    xpos: torch.Tensor  # (B, nbody, 3)
    xquat: torch.Tensor  # (B, nbody, 4)
    site_xpos: torch.Tensor  # (B, nsite, 3)
    actuator_force: torch.Tensor  # (B, nu)
    contact_sensordata: torch.Tensor  # (B, nsensor_contact, 16)

    def to(self, device) -> "State":
        return tensors_to(self, device)

    def map(self, fn) -> "State":
        """Apply ``fn`` to every field (e.g. to slice or expand the batch)."""
        return State(**{f.name: fn(getattr(self, f.name)) for f in fields(self)})


def make_initial_state(model: PhysicsModel, batch_size: int = 1, fused: bool = False) -> State:
    """Neutral-keyframe state of ``batch_size`` worlds.

    ``fused`` rounds the poses as the JAX package's jitted
    ``make_initial_state`` does on the CPU (the fused multiply-adds of
    :func:`~flygym_tpu_torch.engine.kinematics.forward_kinematics`); the
    compile takes it, so that a composed world's initial state is the JAX
    compile's."""
    from flygym_tpu_torch.engine.kinematics import forward_kinematics

    B = batch_size
    qpos = model.qpos0.expand(B, model.nq).clone()
    xpos, xquat = forward_kinematics(model, qpos, fused)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=model.device)
    return State(
        qpos=qpos,
        qvel=zeros(B, model.nv),
        ctrl=model.ctrl0.expand(B, model.nu).clone(),
        act=zeros(B, model.na),
        time=zeros(B),
        qacc=zeros(B, model.nv),
        xpos=xpos,
        xquat=xquat,
        site_xpos=compute_site_xpos(model, xpos, xquat, fused),
        actuator_force=zeros(B, model.nu),
        contact_sensordata=zeros(B, model.nsensor_contact, 16),
    )


def compute_site_xpos(model: PhysicsModel, xpos, xquat, fused: bool = False) -> torch.Tensor:
    from flygym_tpu_torch.engine.maths import quat_rotate, quat_rotate_fma

    if model.nsite == 0:
        return xpos.new_zeros((xpos.shape[0], 0, 3))
    body_q = xquat[:, model.site_body]
    body_p = xpos[:, model.site_body]
    return body_p + (quat_rotate_fma if fused else quat_rotate)(body_q, model.site_pos)
