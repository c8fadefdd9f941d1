"""Kinematic pose conversion between joint axis orders, by inverse kinematics
on the exact gradients of the forward kinematics.

Port of ``flygym_tpu/utils/pose_conversion.py``. The JAX package fits the
joint angles with optax's Adam on ``jax.grad`` of its forward kinematics;
here the cost is the same, on the port's
:func:`~flygym_tpu_torch.engine.kinematics.forward_kinematics`, its
gradient comes from autograd, and the optimiser is ``torch.optim.Adam``
under optax's ``cosine_decay_schedule(lr, max_iters, 1e-2)``. The fit runs
on the model's device; on the card each step's cost and gradient are one
CUDA graph (:func:`graphed_backward`).
"""

import math

import numpy as np
import torch

from flygym_tpu_torch.anatomy import AxisOrder, JointDOF, JointPreset, Skeleton
from flygym_tpu_torch.ops import checked_device

__all__ = [
    "fit_qpos_to_xpos_xquat",
    "graphed_backward",
    "pose_cost",
    "qpos_to_kinematic_pose",
    "convert_pose_axis_order",
]

COSINE_ALPHA = 1e-2  # optax.cosine_decay_schedule's alpha in the JAX fit


def pose_cost(model, target_xpos, target_xquat, fitting_pos_weight: float = 1.0,
              fitting_rot_weight: float = 1.0):
    """``cost(qpos) -> scalar`` of one world's qpos (nq,): the JAX fit's
    cost (``flygym_tpu/utils/pose_conversion.py:51-61``), per body
    ``pos_w * |dpos|^2 + rot_w * (1 - (q1·q2)^2)``, the rotation term blind
    to the quaternions' double cover."""
    from flygym_tpu_torch.engine.kinematics import forward_kinematics

    as_f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=model.device)
    target_xpos, target_xquat = as_f32(target_xpos), as_f32(target_xquat)
    tq = target_xquat / torch.linalg.vector_norm(target_xquat, dim=-1, keepdim=True)

    def cost(qpos: torch.Tensor) -> torch.Tensor:
        xpos, xquat = forward_kinematics(model, qpos[None])
        dpos = xpos[0] - target_xpos
        pos_cost = torch.sum(dpos * dpos)
        fq = xquat[0] / torch.linalg.vector_norm(xquat[0], dim=-1, keepdim=True)
        dot = torch.clamp(torch.abs(torch.sum(fq * tq, dim=-1)), 0.0, 1.0)
        rot_cost = torch.sum(1.0 - dot**2)
        return fitting_pos_weight * pos_cost + fitting_rot_weight * rot_cost

    return cost


def cosine_decay(learning_rate: float, max_iters: int, t: int) -> float:
    """optax's ``cosine_decay_schedule(learning_rate, max_iters, 1e-2)`` at
    step t: lr · (α + (1 − α) · ½ (1 + cos(π min(t, T) / T)))."""
    decay = 0.5 * (1.0 + math.cos(math.pi * min(t, max_iters) / max_iters))
    return learning_rate * (COSINE_ALPHA + (1.0 - COSINE_ALPHA) * decay)


def fit_qpos_to_xpos_xquat(
    model,
    target_xpos: np.ndarray,
    target_xquat: np.ndarray,
    fitting_pos_weight: float = 1.0,
    fitting_rot_weight: float = 1.0,
    max_iters: int = 2000,
    learning_rate: float = 0.05,
) -> np.ndarray:
    """Fit qpos so that the model's body poses match the targets, by Adam
    from qpos = 0 on :func:`pose_cost`, on the model's device.

    Returns:
        The fitted qpos, (nq,) float32.
    """
    cost = pose_cost(model, target_xpos, target_xquat, fitting_pos_weight, fitting_rot_weight)
    qpos = torch.zeros(model.nq, dtype=torch.float32, device=model.device, requires_grad=True)
    opt = torch.optim.Adam([qpos], lr=learning_rate)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: cosine_decay(learning_rate, max_iters, t) / learning_rate)
    backward = graphed_backward(cost, qpos) if qpos.is_cuda else None
    for _ in range(max_iters):
        if backward is None:
            opt.zero_grad(set_to_none=False)
            cost(qpos).backward()
        else:
            backward()
        opt.step()
        sched.step()
    return qpos.detach().cpu().numpy()


def graphed_backward(cost, qpos: torch.Tensor):
    """``cost(qpos).backward()`` captured as one CUDA graph; calling the
    returned function replays it, writing the gradient at qpos's current
    value into ``qpos.grad`` (a buffer of the graph's, not accumulated).

    One evaluation is some 1,200 small kernels, forward and backward, which
    the host launches more slowly than the card runs them: a replay launches
    them all at once."""
    side = torch.cuda.Stream(qpos.device)
    side.wait_stream(torch.cuda.current_stream(qpos.device))
    with torch.cuda.stream(side):  # warm up outside the capture, as CUDA graphs require
        for _ in range(3):
            qpos.grad = None
            cost(qpos).backward()
    torch.cuda.current_stream(qpos.device).wait_stream(side)
    qpos.grad = None
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cost(qpos).backward()
    return graph.replay


def qpos_to_kinematic_pose(compiled, qpos: np.ndarray, axis_order: AxisOrder):
    """A qpos vector as a KinematicPose (the left side; the right side
    mirrors it, ``flygym_tpu/utils/pose_conversion.py:87-102``)."""
    from flygym_tpu_torch.compose.pose import KinematicPose

    angles = {}
    for joint_name, qadr in compiled.hinge_qadr.items():
        dof = JointDOF.from_name(joint_name.split("/")[-1])
        if dof.child.name[0] != "r":
            angles[dof.name] = float(qpos[qadr])
    return KinematicPose(
        joint_angles_rad_dict=angles,
        axis_order=axis_order,
        mirror_left2right=True,
    )


def convert_pose_axis_order(
    pose,
    target_axis_order: AxisOrder,
    joint_preset: JointPreset = JointPreset.ALL_BIOLOGICAL,
    ref_fly_kwargs: dict = {},
    fitted_fly_kwargs: dict = {},
    device="cuda",
):
    """A KinematicPose converted to another axis order by inverse kinematics.

    Composes two flies with the port's :class:`~flygym_tpu_torch.compose.fly.Fly`
    (the pose's axis order and the target's), takes the first's body poses
    at the pose, and fits the second's joint angles to them
    (:func:`fit_qpos_to_xpos_xquat`, 2000 Adam steps) on
    ``device``: the card unless the caller asks for the CPU.
    """
    from flygym_tpu_torch.compose.fly import Fly

    device = checked_device(device)
    ref_fly = Fly(**ref_fly_kwargs)
    ref_fly.add_joints(Skeleton(axis_order=pose.axis_order, joint_preset=joint_preset),
                       neutral_pose=pose)
    _ref_model, ref_state = ref_fly.compile()

    fitted_fly = Fly(**fitted_fly_kwargs)
    fitted_fly.add_joints(Skeleton(axis_order=target_axis_order, joint_preset=joint_preset),
                          neutral_pose=pose)
    fitted_model, _ = fitted_fly.compile()

    if list(ref_fly.compiled.body_name2id) != list(fitted_fly.compiled.body_name2id):
        raise RuntimeError("Fly models have different body names.")

    solved_qpos = fit_qpos_to_xpos_xquat(
        fitted_model.to(device),
        target_xpos=ref_state.xpos[0].numpy(),
        target_xquat=ref_state.xquat[0].numpy(),
    )
    return qpos_to_kinematic_pose(fitted_fly.compiled, solved_qpos, target_axis_order)
