"""Export JAX's gradients through the contact step for the PyTorch port's tests.

The world is the differentiable test world of
``tests/engine/test_differentiable.py``: a free capsule (radius 0.5 mm,
half-length 0.3 mm, 1 mg) resting in contact with a ground plane, in
differentiable mode. From its initial state with qvel0 = (50, 0, 0, 0, 0,
0) (sliding along +x), the loss is ``sum(qpos[:3] ** 2)`` after 15 engine
steps. ``jax.grad`` of it is taken once, jitted on the CPU backend, with
respect to qvel0 and to the gravity vector, and the loss's central
differences along qvel0's x and z (step 1e-2), as JAX's test takes them.

The benchmark fly (``flygym_tpu/demo/benchmark.py:make_model``) in
differentiable mode gives a second case: from settled world 0 of
``flygym_tpu_torch/assets/benchmark_fly_golden.npz``, the loss
``qpos[0] + qpos[2] + 1e-3 sum(qvel) + 1e-4 sum(contact_sensordata)``
after 2 engine steps, and its ``jax.grad`` with respect to ctrl and qvel:
every contact row of the standing fly, the impedance's pow and the sensors
are on its path.

Example 10 (``examples/10_gradient_optimization.py``) gives a third: its
world (the LEGS_ONLY fly with position actuators at kp 50 and leg
adhesion, at (0, 0, 1.1) on flat ground, differentiable) and its loss at
``STANCE_STEPS`` steps, ``jax.value_and_grad`` jitted as the example jits
it, at the zero offset and at a seeded offset in [-0.1, 0.1].

Writes ``flygym_tpu_torch/assets/grad_golden.npz``: ``qvel0``, ``loss``,
``qpos`` (the final qpos), ``grad_qvel0``, ``grad_gravity``, ``fd_index``,
``fd_qvel0``, ``n_steps`` and ``fd_eps`` of the capsule, and ``fly.loss``,
``fly.grad_ctrl``, ``fly.grad_qvel`` and ``fly.n_steps`` of the fly, and
``stance.offset`` (2, n_act), ``stance.loss``, ``stance.lean``,
``stance.z``, ``stance.grad`` (2, n_act) and ``stance.n_steps`` of example
10. Run from the repository root (a few minutes, most of it XLA compiling
the backward passes)::

    JAX_PLATFORMS=cpu python scripts/export_grad_golden.py
"""

import dataclasses
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
GOLDEN_PATH = REPO / "flygym_tpu_torch" / "assets" / "grad_golden.npz"

N_STEPS = 15
FLY_STEPS = 2
FD_EPS = 1e-2
FD_INDEX = (0, 2)  # the slide DoF (friction path) and the normal DoF (contact)
STANCE_STEPS = 5
STANCE_SEED = 0


def capsule_world():
    """The JAX test's world, compiled by the JAX package."""
    from flygym_tpu.compose.spec import BodySpec, GeomSpec, JointSpec, ModelSpec, PairSpec
    from flygym_tpu.engine.model import make_initial_state

    spec = ModelSpec("diff_world")
    spec.world_geoms.append(GeomSpec(name="ground", type="plane", size=(100.0, 100.0, 1.0)))
    body = BodySpec(name="ball", parent=None)
    body.add_joint(JointSpec(name="ballfree", type="free"))
    body.add_geom(GeomSpec(name="ballgeom", type="capsule", size=(0.5, 0.3), mass=1e-3))
    spec.add_body(body)
    spec.pairs.append(PairSpec(
        geom1="ballgeom", geom2="ground", friction=(1.0, 1.0, 0.02, 1e-4, 1e-4),
        solref=(2e-4, 1.0), solimp=(0.98, 0.99, 1e-5, 0.5, 3.0), margin=1e-3))
    spec.neutral_joint_qpos["ballfree"] = [0, 0, 0.55, 1, 0, 0, 0]
    spec.options["differentiable"] = True
    compiled = spec.compile()
    return compiled.model, make_initial_state(compiled.model)


def fly_loss(model, state, n_steps: int = FLY_STEPS):
    """``loss(ctrl, qvel)`` of the benchmark fly's case; ``state`` is one
    world's JAX State."""
    import jax.numpy as jnp

    from flygym_tpu.engine.step import step

    def loss(ctrl, qvel):
        s = dataclasses.replace(state, ctrl=ctrl, qvel=qvel)
        for _ in range(n_steps):
            s = step(model, s)
        return (s.qpos[0] + s.qpos[2] + 1e-3 * jnp.sum(s.qvel)
                + 1e-4 * jnp.sum(s.contact_sensordata))

    return loss


def fly_case() -> dict:
    """The benchmark fly's gradients, jitted as :func:`main`'s."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.demo.benchmark import make_model
    from flygym_tpu.engine.model import State

    _fly, world, _cam = make_model()
    model, _state = world.compile()
    model = dataclasses.replace(model, differentiable=True)
    with np.load(REPO / "flygym_tpu_torch" / "assets" / "benchmark_fly_golden.npz") as g:
        state = State(**{f.name: jnp.asarray(g[f"state.{f.name}"][0])
                         for f in dataclasses.fields(State)})
    loss = fly_loss(model, state)
    value, (g_ctrl, g_qvel) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        state.ctrl, state.qvel)
    return {"fly.loss": np.float32(value), "fly.grad_ctrl": np.asarray(g_ctrl),
            "fly.grad_qvel": np.asarray(g_qvel), "fly.n_steps": np.int64(FLY_STEPS)}


def stance_case() -> dict:
    """Example 10's loss and gradient at two offsets, its world and loss as
    ``examples/10_gradient_optimization.py:main`` builds them."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.anatomy import Skeleton
    from flygym_tpu.compose import ActuatorType, FlatGroundWorld, Fly, KinematicPosePreset
    from flygym_tpu.engine.step import step
    from flygym_tpu.utils.math import Rotation3D

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
    c = world.compiled
    act_ids = jnp.asarray([c.actuator_name2id[a.full_identifier] for a in
                           fly.jointdof_to_specactuator_by_type[ActuatorType.POSITION].values()])
    adh_ids = jnp.asarray([c.actuator_name2id[fly.leg_to_adhesionactuator[leg].full_identifier]
                           for leg in fly.get_legs_order()])
    root = c.body_name2id[f"f/{fly.root_segment.name}"]
    z0 = float(state0.xpos[root, 2])

    def loss(offset):
        ctrl = state0.ctrl.at[act_ids].add(offset).at[adh_ids].set(100.0)
        st = dataclasses.replace(state0, ctrl=ctrl)

        def body(s, _):
            return step(model, s), None

        st, _ = jax.lax.scan(body, st, None, length=STANCE_STEPS)
        lean = st.xpos[root, 0]
        fall = jnp.maximum(z0 - st.xpos[root, 2] - 0.15, 0.0)
        return -lean + 25.0 * fall**2, (lean, st.xpos[root, 2])

    grad_fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    rng = np.random.default_rng(STANCE_SEED)
    offsets = np.stack([np.zeros(len(act_ids), np.float32),
                        rng.uniform(-0.1, 0.1, len(act_ids)).astype(np.float32)])
    out = [grad_fn(jnp.asarray(o)) for o in offsets]
    return {"stance.offset": offsets,
            "stance.loss": np.asarray([v for (v, _aux), _g in out], np.float32),
            "stance.lean": np.asarray([aux[0] for (_v, aux), _g in out], np.float32),
            "stance.z": np.asarray([aux[1] for (_v, aux), _g in out], np.float32),
            "stance.grad": np.stack([np.asarray(g) for _vx, g in out]),
            "stance.n_steps": np.int64(STANCE_STEPS)}


def main():
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from flygym_tpu.engine.step import step

    model, state = capsule_world()

    def rollout(m, qvel0):
        def body(s, _):
            return step(m, s), None

        st, _ = jax.lax.scan(body, dataclasses.replace(state, qvel=qvel0), None,
                             length=N_STEPS)
        return st.qpos

    loss = lambda m, v: jnp.sum(rollout(m, v)[:3] ** 2)
    qvel0 = jnp.zeros(model.nv, jnp.float32).at[0].set(50.0)

    def loss_of_gravity(g):
        return loss(dataclasses.replace(model, gravity=g), qvel0)

    t0 = time.time()
    qpos = np.asarray(jax.jit(lambda v: rollout(model, v))(qvel0))
    f = jax.jit(lambda v: loss(model, v))
    grad_qvel0 = np.asarray(jax.jit(jax.grad(lambda v: loss(model, v)))(qvel0))
    grad_gravity = np.asarray(jax.jit(jax.grad(loss_of_gravity))(model.gravity))
    fd = [(float(f(qvel0.at[i].add(FD_EPS))) - float(f(qvel0.at[i].add(-FD_EPS))))
          / (2 * FD_EPS) for i in FD_INDEX]
    print(f"gradients in {time.time() - t0:.1f} s: qvel0 {grad_qvel0}, gravity {grad_gravity}, "
          f"central differences {fd}")
    fly = fly_case()
    print(f"benchmark fly: loss {fly['fly.loss']}, max |grad ctrl| "
          f"{np.abs(fly['fly.grad_ctrl']).max()}, max |grad qvel| "
          f"{np.abs(fly['fly.grad_qvel']).max()}")
    stance = stance_case()
    print(f"example 10 at {STANCE_STEPS} steps: losses {stance['stance.loss']}, max |grad| "
          f"{np.abs(stance['stance.grad']).max(axis=1)}")
    np.savez(GOLDEN_PATH, qvel0=np.asarray(qvel0), loss=np.float32(f(qvel0)), qpos=qpos,
             grad_qvel0=grad_qvel0, grad_gravity=grad_gravity,
             fd_index=np.asarray(FD_INDEX, np.int64), fd_qvel0=np.asarray(fd, np.float64),
             n_steps=np.int64(N_STEPS), fd_eps=np.float64(FD_EPS), **fly, **stance)
    print(f"wrote {GOLDEN_PATH}")


if __name__ == "__main__":
    main()
