"""The port's pose conversion (``flygym_tpu_torch/utils/pose_conversion.py``)
against the JAX package's (``flygym_tpu/utils/pose_conversion.py``), on the
CPU.

The fit's cost and its autograd gradient against JAX's cost and
``jax.grad`` at a seeded qpos (:data:`COST_BAR`); the optimiser (torch's
Adam under the cosine schedule) against optax's, step by step; a short fit
against JAX's fit by cost; the full 2000-step conversion YPR → PRY on
LEGS_ONLY reproducing the body positions within 0.1 mm, JAX's test's bar
(``tests/core/test_pose_conversion.py:36-68``, ~12 s here).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from flygym_tpu.compose.fly import Fly as JFly
from flygym_tpu.engine.kinematics import forward_kinematics as j_fk
from flygym_tpu.utils import pose_conversion as j_pc

from flygym_tpu_torch.anatomy import AxisOrder, JointPreset, Skeleton
from flygym_tpu_torch.compose import KinematicPosePreset
from flygym_tpu_torch.compose.fly import Fly
from flygym_tpu_torch.utils import pose_conversion as pc

torch.set_num_threads(1)

# The cost and its gradient against JAX's, relative: the same float32
# kinematics (glibc's sin and cos, the same products) summed over the
# bodies in another order (measured: cost 1.2e-7, gradient 1.5e-7 of its
# largest entry).
COST_BAR = 1e-5
# The schedule against optax's, relative to the learning rate: the same
# formula, in float64 here and in float32 there (measured: 7.6e-8).
ADAM_BAR = 1e-6
# 200 Adam steps of each package's fit from the same targets: the costs
# reached and the angles, float32 Adam in two frameworks (measured: cost
# 6e-6 relative, angles 1.6e-5 rad; the cost falls from 142.7 to 10.25).
FIT_COST_BAR = 1e-4
FIT_ANGLE_BAR = 1e-4


def _pose():
    return KinematicPosePreset.NEUTRAL.get_pose_by_axis_order(AxisOrder.YPR)


@pytest.fixture(scope="module")
def flies():
    """The reference fly (YPR) at the neutral pose and the fly to fit (PRY),
    in both packages: ``(port model, port targets, JAX model, JAX targets)``."""
    from flygym_tpu.anatomy import AxisOrder as JAxisOrder
    from flygym_tpu.anatomy import JointPreset as JJointPreset
    from flygym_tpu.anatomy import Skeleton as JSkeleton
    from flygym_tpu.compose import KinematicPosePreset as JPreset

    ref = Fly()
    ref.add_joints(Skeleton(axis_order=AxisOrder.YPR, joint_preset=JointPreset.LEGS_ONLY),
                   neutral_pose=_pose())
    _m, ref_state = ref.compile()
    fit = Fly()
    fit.add_joints(Skeleton(axis_order=AxisOrder.PRY, joint_preset=JointPreset.LEGS_ONLY),
                   neutral_pose=_pose())
    model, _s = fit.compile()

    jpose = JPreset.NEUTRAL.get_pose_by_axis_order(JAxisOrder.YPR)
    jref = JFly()
    jref.add_joints(JSkeleton(axis_order=JAxisOrder.YPR, joint_preset=JJointPreset.LEGS_ONLY),
                    neutral_pose=jpose)
    _jm, jref_state = jref.compile()
    jfit = JFly()
    jfit.add_joints(JSkeleton(axis_order=JAxisOrder.PRY, joint_preset=JJointPreset.LEGS_ONLY),
                    neutral_pose=jpose)
    jmodel, _js = jfit.compile()
    return (model, (ref_state.xpos[0].numpy(), ref_state.xquat[0].numpy()), fit,
            jmodel, (np.asarray(jref_state.xpos), np.asarray(jref_state.xquat)), jfit)


def _jax_cost(jmodel, target_xpos, target_xquat):
    """The JAX fit's cost (``flygym_tpu/utils/pose_conversion.py:51-61``)."""
    tq = target_xquat / jnp.linalg.norm(target_xquat, axis=-1, keepdims=True)

    def cost(qpos):
        xpos, xquat = j_fk(jmodel, qpos)
        dpos = xpos - target_xpos
        fq = xquat / jnp.linalg.norm(xquat, axis=-1, keepdims=True)
        dot = jnp.clip(jnp.abs(jnp.sum(fq * tq, axis=-1)), 0.0, 1.0)
        return jnp.sum(dpos * dpos) + jnp.sum(1.0 - dot**2)

    return cost


def test_targets_are_the_jax_fly_poses(flies):
    _model, (xpos, xquat), _fit, _jm, (jxpos, jxquat), _jfit = flies
    np.testing.assert_array_equal(xpos, jxpos)
    np.testing.assert_array_equal(xquat, jxquat)


@pytest.mark.parametrize("seed", [0, 1])
def test_cost_and_gradient_equal_jax(flies, seed):
    model, targets, _fit, jmodel, _jt, _jfit = flies
    qpos = np.random.default_rng(seed).uniform(-0.5, 0.5, model.nq).astype(np.float32)
    q = torch.from_numpy(qpos).requires_grad_(True)
    cost = pc.pose_cost(model, *targets)(q)
    cost.backward()
    jcost = _jax_cost(jmodel, *(jnp.asarray(t) for t in targets))
    jv, jg = jax.value_and_grad(jcost)(jnp.asarray(qpos))
    assert abs(cost.item() - float(jv)) <= COST_BAR * abs(float(jv))
    jg = np.asarray(jg)
    assert np.abs(q.grad.numpy() - jg).max() <= COST_BAR * np.abs(jg).max()


def test_schedule_equals_optax():
    want = optax.cosine_decay_schedule(0.05, 2000, 1e-2)
    for t in (0, 1, 2, 500, 1000, 1999, 2000, 2500):
        assert abs(pc.cosine_decay(0.05, 2000, t) - float(want(t))) <= ADAM_BAR * 0.05


def test_adam_under_the_schedule_equals_optax():
    """Torch's Adam with the LambdaLR the fit makes, against optax's adam on
    the cosine schedule, 30 steps on a seeded quadratic, in float64 so that
    the comparison sees the algorithm and not float32's roundings (which
    part the two by up to 7e-6 here)."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((6, 6))
    A = A @ A.T + np.eye(6)
    x0 = rng.standard_normal(6)
    x = torch.from_numpy(x0.copy()).requires_grad_(True)
    topt = torch.optim.Adam([x], lr=0.05)
    sched = torch.optim.lr_scheduler.LambdaLR(topt, lambda t: pc.cosine_decay(0.05, 30, t) / 0.05)
    At = torch.from_numpy(A)
    with jax.enable_x64(True):
        f = lambda v: 0.5 * v @ (jnp.asarray(A) @ v)
        opt = optax.adam(optax.cosine_decay_schedule(0.05, 30, 1e-2))
        xj = jnp.asarray(x0)
        sj = opt.init(xj)
        for _ in range(30):
            upd, sj = opt.update(jax.grad(f)(xj), sj)
            xj = optax.apply_updates(xj, upd)
            topt.zero_grad()
            (0.5 * x @ (At @ x)).backward()
            topt.step()
            sched.step()
        xj = np.asarray(xj)
    np.testing.assert_allclose(x.detach().numpy(), xj, rtol=0.0, atol=1e-12)


def test_short_fit_matches_jax_fit_by_cost(flies):
    """200 Adam steps from qpos = 0 on both packages: the costs they reach
    agree within :data:`FIT_COST_BAR`, and the fitted angles within
    :data:`FIT_ANGLE_BAR`."""
    model, targets, _fit, jmodel, jtargets, _jfit = flies
    q = pc.fit_qpos_to_xpos_xquat(model, *targets, max_iters=200)
    jq = j_pc.fit_qpos_to_xpos_xquat(jmodel, *jtargets, max_iters=200)
    cost = pc.pose_cost(model, *targets)
    c, jc = cost(torch.tensor(q)).item(), cost(torch.tensor(jq)).item()
    assert c < cost(torch.zeros(model.nq)).item() / 10
    assert abs(c - jc) <= FIT_COST_BAR * jc, (c, jc)
    assert np.abs(q - jq).max() < FIT_ANGLE_BAR


def test_qpos_to_kinematic_pose_equals_jax(flies):
    _model, _t, fit, _jm, _jt, jfit = flies
    qpos = np.random.default_rng(7).uniform(-1, 1, fit.compiled.model.nq).astype(np.float32)
    got = pc.qpos_to_kinematic_pose(fit.compiled, qpos, AxisOrder.PRY)
    from flygym_tpu.anatomy import AxisOrder as JAxisOrder

    want = j_pc.qpos_to_kinematic_pose(jfit.compiled, qpos, JAxisOrder.PRY)
    assert got.joint_angles_lookup_rad == want.joint_angles_lookup_rad
    assert got.axis_order.name == want.axis_order.name == "PITCH_ROLL_YAW"


def test_axis_order_round_trip_within_0_1_mm():
    """JAX's test on the port: YPR → PRY on LEGS_ONLY with the full 2000
    Adam steps, then both poses through each fly's compile."""
    pose = _pose()
    converted = pc.convert_pose_axis_order(pose, AxisOrder.PRY,
                                           joint_preset=JointPreset.LEGS_ONLY, device="cpu")
    assert converted.axis_order is AxisOrder.PRY

    def fk(p, order):
        fly = Fly()
        fly.add_joints(Skeleton(axis_order=order, joint_preset=JointPreset.LEGS_ONLY),
                       neutral_pose=p)
        _model, state = fly.compile()
        return state.xpos[0].numpy()

    err = np.abs(fk(pose, AxisOrder.YPR) - fk(converted, AxisOrder.PRY)).max()
    assert err < 0.1, err


def test_conversion_runs_on_the_card_by_default():
    """Like every entry point, the conversion takes the card unless the
    caller passes ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pc.convert_pose_axis_order(_pose(), AxisOrder.PRY, joint_preset=JointPreset.LEGS_ONLY)
