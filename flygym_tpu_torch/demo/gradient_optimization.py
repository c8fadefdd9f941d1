"""Example 10: gradient-based optimisation through the physics, and the
differentiable test world.

``main`` is ``examples/10_gradient_optimization.py`` in torch: a per-DoF
offset added to the neutral stance's position targets is optimised so that
the fly leans forward as far as it can in ``n_steps`` engine steps without
its thorax dropping by more than 0.15 mm, by Adam (written out, as the
example writes it) on the loss's exact gradient. The world is compiled in
differentiable mode, so the engine step's contact solve runs the tree-LDL
kernels under autograd (K1 once and K1b twice a step forward, one more K1b
launch per solve backward: :func:`flygym_tpu_torch.ops.ldl.tree_ldl_solve_grad`).

:func:`capsule_world` and :func:`capsule_loss` are the JAX package's
differentiable test (``tests/engine/test_differentiable.py:29-64``): a free
capsule resting on a ground plane, and ``sum(qpos[:3] ** 2)`` after 15
steps from a given qvel0.
"""

import time
from dataclasses import replace

import torch

from flygym_tpu_torch.engine.step import step
from flygym_tpu_torch.ops import checked_device

__all__ = ["capsule_world", "capsule_spec", "capsule_loss", "stance_loss", "main"]


def capsule_world():
    """The JAX differentiable test's world, composed and compiled by the
    port on the CPU: :class:`~flygym_tpu_torch.compose.bridge.CompiledModel`."""
    return capsule_spec().compile()


def capsule_spec():
    """The :class:`~flygym_tpu_torch.compose.spec.ModelSpec` of :func:`capsule_world`."""
    from flygym_tpu_torch.compose.spec import BodySpec, GeomSpec, JointSpec, ModelSpec, PairSpec

    spec = ModelSpec("diff_world")
    spec.world_geoms.append(GeomSpec(name="ground", type="plane", size=(100.0, 100.0, 1.0)))
    body = BodySpec(name="ball", parent=None)
    body.add_joint(JointSpec(name="ballfree", type="free"))
    body.add_geom(GeomSpec(name="ballgeom", type="capsule", size=(0.5, 0.3), mass=1e-3))
    spec.add_body(body)
    spec.pairs.append(PairSpec(
        geom1="ballgeom", geom2="ground", friction=(1.0, 1.0, 0.02, 1e-4, 1e-4),
        solref=(2e-4, 1.0), solimp=(0.98, 0.99, 1e-5, 0.5, 3.0), margin=1e-3))
    # Start in contact so the constraint solve is on the gradient path.
    spec.neutral_joint_qpos["ballfree"] = [0, 0, 0.55, 1, 0, 0, 0]
    spec.options["differentiable"] = True
    return spec


def capsule_loss(model, state, qvel0: torch.Tensor, n_steps: int = 15) -> torch.Tensor:
    """``sum(qpos[:3] ** 2)`` of world 0 after ``n_steps`` engine steps from
    ``state`` with qvel ``qvel0`` (B, nv)."""
    st = replace(state, qvel=qvel0)
    for _ in range(n_steps):
        st = step(model, st)
    return torch.sum(st.qpos[0, :3] ** 2)


def stance_loss(n_steps: int, device):
    """Example 10's fly, world and loss, built as the example builds them:
    the LEGS_ONLY fly in its neutral pose, position actuators at kp 50 and
    leg adhesion, spawned at (0, 0, 1.1) on flat ground in differentiable
    mode, on ``device``. Returns ``(loss, offset0)``: ``loss(offset)`` of a
    stance offset (n_act,) adds it to the position targets, sets adhesion
    on at 100, runs ``n_steps`` engine steps from the compiled state and
    gives ``(-lean + 25 · fall², lean, thorax z)``, with ``lean`` the
    thorax's forward displacement (mm) and ``fall`` its drop beyond 0.15
    mm; ``offset0`` is the zero offset."""
    from flygym_tpu_torch.anatomy import Skeleton
    from flygym_tpu_torch.compose import ActuatorType, FlatGroundWorld, Fly, KinematicPosePreset
    from flygym_tpu_torch.utils.math import Rotation3D

    fly = Fly(name="f")
    fly.add_joints(Skeleton(axis_order="ypr", joint_preset="legs_only"),
                   neutral_pose=KinematicPosePreset.NEUTRAL)
    fly.add_actuators(fly.skeleton.get_actuated_dofs_from_preset("legs_active_only"),
                      ActuatorType.POSITION, kp=50.0, neutral_input=KinematicPosePreset.NEUTRAL)
    fly.add_leg_adhesion()
    world = FlatGroundWorld()
    world.add_fly(fly, (0, 0, 1.1), Rotation3D("quat", (1, 0, 0, 0)))
    world.spec.options["differentiable"] = True
    model, state0 = world.compile()
    model, state0 = model.to(device), state0.to(device)

    c = world.compiled
    ids = lambda names: torch.tensor([c.actuator_name2id[n] for n in names],
                                     dtype=torch.int64, device=device)
    act_ids = ids([a.full_identifier for a in
                   fly.jointdof_to_specactuator_by_type[ActuatorType.POSITION].values()])
    adh_ids = ids([fly.leg_to_adhesionactuator[leg].full_identifier
                   for leg in fly.get_legs_order()])
    root = c.body_name2id[f"f/{fly.root_segment.name}"]
    z0 = state0.xpos[0, root, 2]

    def loss(offset: torch.Tensor):
        ctrl = state0.ctrl.index_add(1, act_ids, offset[None]).index_fill(1, adh_ids, 100.0)
        st = replace(state0, ctrl=ctrl)
        for _ in range(n_steps):
            st = step(model, st)
        lean = st.xpos[0, root, 0]
        fall = torch.clamp(z0 - st.xpos[0, root, 2] - 0.15, min=0.0)
        return -lean + 25.0 * fall**2, lean, st.xpos[0, root, 2]

    return loss, torch.zeros(len(act_ids), device=device)


def main(n_steps: int = 400, n_iters: int = 30, device="cuda", verbose: bool = True) -> list:
    """Optimise the stance offset by Adam through ``n_steps`` contact steps
    at B = 1, ``n_iters`` times, on ``device`` (the card unless the caller
    asks for the CPU). Returns one record per iteration: ``loss``, ``lean``,
    ``z`` (before that iteration's update) and ``seconds`` (its forward,
    backward and update, the card synchronised)."""
    device = checked_device(device)
    loss_fn, offset = stance_loss(n_steps, device)
    m, v = torch.zeros_like(offset), torch.zeros_like(offset)
    lr, b1, b2 = 0.02, 0.9, 0.999
    history = []
    for i in range(n_iters):
        t0 = time.perf_counter()
        x = offset.clone().requires_grad_(True)
        val, lean, z = loss_fn(x)
        (g,) = torch.autograd.grad(val, x)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1 ** (i + 1))
        vh = v / (1 - b2 ** (i + 1))
        offset = torch.clamp(offset - lr * mh / (torch.sqrt(vh) + 1e-8), -0.5, 0.5)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rec = {"loss": val.item(), "lean": lean.item(), "z": z.item(),
               "seconds": time.perf_counter() - t0}
        history.append(rec)
        if verbose:
            print(f"iter {i:3d}: loss {rec['loss']:+.4f}  lean {rec['lean']:+.3f} mm  "
                  f"thorax z {rec['z']:.3f} mm  ({rec['seconds']:.2f} s)")
    if verbose:
        print(f"optimized stance leans {history[-1]['lean']:+.3f} mm forward (started at "
              f"+0.000) without falling: gradient descent through {n_steps} contact steps.")
    return history


if __name__ == "__main__":
    main()
