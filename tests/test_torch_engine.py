"""The port's engine modules against the JAX engine, stage by stage.

Inputs are the JAX package's settled benchmark state (the first two worlds
of ``flygym_tpu_torch/assets/benchmark_fly_golden.npz``: 2,500 steps with
adhesion on, all six legs in contact). The JAX pipeline runs once, jitted
and vmapped; each port module then gets the JAX inputs of its stage as
tensors, so a mismatch points at one module. The full step is held to the
bars of ``tests/engine/test_megastep.py:120-145``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flygym_tpu.demo.benchmark import make_model
from flygym_tpu.engine import actuation as j_actuation
from flygym_tpu.engine import contact as j_contact
from flygym_tpu.engine import dynamics as j_dynamics
from flygym_tpu.engine import kinematics as j_kinematics
from flygym_tpu.engine import maths as j_maths
from flygym_tpu.engine import sensors as j_sensors
from flygym_tpu.engine.model import State as JState
from flygym_tpu.engine.step import step as j_step

from flygym_tpu_torch import load_compiled
from flygym_tpu_torch.compose.bridge import load_golden
from flygym_tpu_torch.engine import actuation, contact, dynamics, kinematics, maths, sensors
from flygym_tpu_torch.engine.model import State, make_initial_state
from flygym_tpu_torch.engine.step import step

torch.set_num_threads(1)

B = 2


@pytest.fixture(scope="module")
def jax_model():
    _fly, world, _cam = make_model()
    return world.compile()


@pytest.fixture(scope="module")
def model():
    return load_compiled().model


@pytest.fixture(scope="module")
def settled():
    """The first B worlds of the JAX settled state, as numpy."""
    st = load_golden()["state"]
    return {f.name: getattr(st, f.name)[:B].numpy().copy() for f in dataclasses.fields(State)}


def _jax_pipeline(model, st):
    """One world through the JAX engine's stages (``engine/step.py:49-102``)."""
    qpos, qvel, ctrl = st.qpos, st.qvel, st.ctrl
    xpos, xquat, hinge_xaxis = j_kinematics.kinematics_full(model, qpos)
    ref = xpos[model.ref_body]
    S = j_kinematics.dof_subspace(model, xpos, hinge_xaxis, ref)
    gpos, gquat = j_kinematics.geom_poses(model, xpos, xquat)
    cvel, cacc = j_kinematics.velocity_pass(model, qvel, xpos, S)
    I_body = j_dynamics.body_spatial_inertias(model, xpos, xquat, ref)
    M = j_dynamics.crba(model, I_body, S)
    bias = j_dynamics.rnea_bias(model, I_body, S, cvel, cacc)
    passive = j_dynamics.passive_forces(model, qpos, qvel)
    qfrc_act, actuator_force = j_actuation.actuator_forces(model, qpos, qvel, ctrl, st.act)
    qfrc_smooth = passive + qfrc_act - bias
    Mh = M + model.timestep * jnp.diag(model.dof_damping)
    qacc, info = j_contact.solve_contacts(
        model, Mh, qfrc_smooth, qvel, st.qacc, xpos, S, gpos, gquat, ctrl, ref
    )
    return dict(
        xpos=xpos, xquat=xquat, hinge_xaxis=hinge_xaxis, ref=ref, S=S, gpos=gpos,
        gquat=gquat, cvel=cvel, cacc=cacc, I_body=I_body, M=M, bias=bias,
        passive=passive, qfrc_act=qfrc_act, actuator_force=actuator_force,
        qfrc_smooth=qfrc_smooth, Mh=Mh, qacc=qacc, sel=info.sel, dist=info.dist,
        pos=info.pos, active=info.active, force_frame=info.force_frame,
        force_world=info.force_world, frame=info.frame, sensor=info.sensor,
        sensordata=j_sensors.contact_sensor_data(model, info),
    )


@pytest.fixture(scope="module")
def ref(jax_model, settled):
    jm, _ = jax_model
    st = JState(**{k: jnp.asarray(v) for k, v in settled.items()})
    out = jax.jit(jax.vmap(_jax_pipeline, in_axes=(None, 0)))(jm, st)
    return {k: torch.tensor(np.asarray(v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def state(settled):
    return State(**{k: torch.from_numpy(v) for k, v in settled.items()})


def close(got, want, atol, rtol=0.0):
    torch.testing.assert_close(got, want.to(got.dtype), atol=atol, rtol=rtol)


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


_MATHS_CASES = {
    "quat_mul": lambda r: (_unit(r.normal(size=(7, 4))), _unit(r.normal(size=(7, 4)))),
    "quat_conj": lambda r: (_unit(r.normal(size=(7, 4))),),
    "quat_rotate": lambda r: (_unit(r.normal(size=(7, 4))), r.normal(size=(7, 3))),
    "quat_rotate_inv": lambda r: (_unit(r.normal(size=(7, 4))), r.normal(size=(7, 3))),
    "quat_from_axis_angle": lambda r: (_unit(r.normal(size=(7, 3))), r.normal(size=7)),
    "quat_integrate": lambda r: (_unit(r.normal(size=(7, 4))), r.normal(size=(7, 3)), 1e-4),
    "quat_to_mat": lambda r: (_unit(r.normal(size=(7, 4))),),
    "mat_to_quat": lambda r: (np.asarray(j_maths.quat_to_mat(_unit(r.normal(size=(7, 4))))),),
    "normalize_quat": lambda r: (r.normal(size=(7, 4)),),
    "skew": lambda r: (r.normal(size=(7, 3)),),
    "motion_cross": lambda r: (r.normal(size=(7, 6)), r.normal(size=(7, 6))),
    "force_cross": lambda r: (r.normal(size=(7, 6)), r.normal(size=(7, 6))),
    "spatial_inertia": lambda r: (
        r.random(7), r.normal(size=(7, 3, 3)), r.normal(size=(7, 3))
    ),
}


@pytest.mark.parametrize("name", sorted(_MATHS_CASES))
def test_maths_matches_jax(name):
    args = [
        np.asarray(a, np.float32) if isinstance(a, np.ndarray) else a
        for a in _MATHS_CASES[name](np.random.default_rng(0))
    ]
    want = np.asarray(getattr(j_maths, name)(*[
        jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args
    ]))
    got = getattr(maths, name)(*[
        torch.tensor(a) if isinstance(a, np.ndarray) else a for a in args
    ])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_engine_sin_cos_round_as_jax():
    """The engine's sin and cos (``quat_from_axis_angle``, used by the free
    joints' integration) against the JAX package's jitted, to the last bit:
    glibc's sinf/cosf algorithm, which XLA's CPU backend calls."""
    rng = np.random.default_rng(0)
    axis = _unit(rng.normal(size=(20000, 3))).astype(np.float32)
    angle = np.concatenate([rng.uniform(-3.0, 3.0, 19000), rng.uniform(-1e-3, 1e-3, 1000)])
    angle = angle.astype(np.float32)
    want = np.asarray(jax.jit(j_maths.quat_from_axis_angle)(jnp.asarray(axis), jnp.asarray(angle)))
    got = maths.quat_from_axis_angle(torch.from_numpy(axis), torch.from_numpy(angle))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("power", [3.0, 2.0, 1.5])
def test_powf_rounds_as_jax(power):
    """The impedance's pow against the JAX package's ``x ** power`` on the
    CPU (glibc's powf), to the last bit, over [0, 1] with tiny and
    subnormal-result arguments; with a float and with a tensor exponent."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0.0, 1.0, 400000).astype(np.float32)
    x[::7] *= 1e-6
    x[::13] *= np.float32(2.0**-40)
    x[:6] = [0.0, 1.0, 0.5, 1e-45, 3e-39, 2.0**-42]
    want = np.asarray(jnp.asarray(x) ** power)
    np.testing.assert_array_equal(maths.powf(torch.from_numpy(x), power).numpy(), want)
    tensor_power = torch.full((x.size,), power)
    np.testing.assert_array_equal(maths.powf(torch.from_numpy(x), tensor_power).numpy(), want)


def test_initial_state_matches_jax(jax_model, model):
    _, s0 = jax_model
    st = make_initial_state(model, batch_size=1)
    for name in ("qpos", "ctrl", "xpos", "xquat", "site_xpos"):
        close(getattr(st, name)[0], torch.tensor(np.asarray(getattr(s0, name))), atol=1e-6)


def test_kinematics(model, state, ref):
    xpos, xquat, hinge_xaxis = kinematics.kinematics_full(model, state.qpos)
    close(xpos, ref["xpos"], atol=1e-6)
    close(xquat, ref["xquat"], atol=1e-6)
    close(hinge_xaxis, ref["hinge_xaxis"], atol=1e-6)
    S = kinematics.dof_subspace(model, ref["xpos"], ref["hinge_xaxis"], ref["ref"])
    close(S, ref["S"], atol=1e-6)
    gpos, gquat = kinematics.geom_poses(model, ref["xpos"], ref["xquat"])
    close(gpos, ref["gpos"], atol=1e-6)
    close(gquat, ref["gquat"], atol=1e-6)


def test_velocity_pass(model, state, ref):
    cvel, cacc = kinematics.velocity_pass(model, state.qvel, ref["xpos"], ref["S"])
    close(cvel, ref["cvel"], atol=1e-5, rtol=1e-5)
    close(cacc, ref["cacc"], atol=1e-5, rtol=1e-5)


def test_mass_matrix_and_bias(model, state, ref):
    I_body = dynamics.body_spatial_inertias(model, ref["xpos"], ref["xquat"], ref["ref"])
    close(I_body, ref["I_body"], atol=1e-9, rtol=1e-5)
    M = dynamics.crba(model, ref["I_body"], ref["S"])
    close(M, ref["M"], atol=1e-9, rtol=1e-5)
    bias = dynamics.rnea_bias(model, ref["I_body"], ref["S"], ref["cvel"], ref["cacc"])
    close(bias, ref["bias"], atol=1e-7, rtol=1e-5)
    close(dynamics.passive_forces(model, state.qpos, state.qvel), ref["passive"], atol=1e-7)


def test_actuator_forces(model, state, ref):
    qfrc, force = actuation.actuator_forces(
        model, state.qpos, state.qvel, state.ctrl, state.act
    )
    close(qfrc, ref["qfrc_act"], atol=1e-6)
    close(force, ref["actuator_force"], atol=1e-6)


def test_contacts(model, state, ref):
    qacc, info = contact.solve_contacts(
        model, ref["Mh"], ref["qfrc_smooth"], state.qvel, state.qacc, ref["xpos"],
        ref["S"], ref["gpos"], ref["gquat"], state.ctrl, ref["ref"],
    )
    # The same contacts, in the same order, are handed to the solver.
    assert torch.equal(info.sel, ref["sel"].long())
    assert torch.equal(info.active, ref["active"])
    assert int(info.active.sum()) > 0
    close(info.dist, ref["dist"], atol=1e-7)
    close(info.pos, ref["pos"], atol=1e-6)
    close(info.frame, ref["frame"], atol=1e-6)
    # Newton on the same rows: fp32 summation order differs between XLA's
    # and PyTorch's matmuls on near-cancelling terms.
    close(qacc, ref["qacc"], atol=0.05, rtol=1e-3)
    close(info.force_frame, ref["force_frame"], atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("seed", range(4))
def test_contact_selection_breaks_ties_like_jax(model, seed):
    """Equal distances (left and right legs at rest) keep the lower
    candidate index first, as ``jax.lax.top_k`` does."""
    rng = np.random.default_rng(seed)
    dist = rng.integers(-3, 4, size=(5, model.ncand)).astype(np.float32) * 1e-3
    _, want = jax.lax.top_k(-jnp.asarray(dist), model.ncon)
    got = contact.select_contacts(model, torch.from_numpy(dist))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sensors(model, ref):
    info = contact.ContactInfo(
        **{k: ref[k] for k in ("pos", "force_frame", "force_world", "frame")},
        active=ref["active"],
        sensor=ref["sensor"].long(),
    )
    got = sensors.contact_sensor_data(model, info, B)
    close(got, ref["sensordata"], atol=1e-6, rtol=1e-5)


def test_full_step_matches_jax_step(jax_model, model, settled):
    """One replay step: the settled state with the first replay targets as
    controls, as in the benchmark's first step, against ``jax.jit(step)``.

    At the quiescent state itself qacc is ill-determined: the second Newton
    iteration's line search runs along a nearly flat direction, and a
    1e-6 relative difference in the bias force moves its step from 1.33 to
    0.34 and qacc by 3 (of 10.7), while qvel agrees to 3e-4. The contact
    solve there is compared on identical inputs in ``test_contacts``.
    """
    jm, _ = jax_model
    golden = load_golden()
    ids = load_compiled().flies["nmf"]["act_ids"]["position"]
    start = dict(settled)
    start["ctrl"] = settled["ctrl"].copy()
    start["ctrl"][:, ids] = golden["targets"][:B, 0]

    jstep = jax.jit(j_step)
    want = {}
    for w in range(B):
        out = jstep(jm, JState(**{k: jnp.asarray(v[w]) for k, v in start.items()}))
        for f in dataclasses.fields(JState):
            want.setdefault(f.name, []).append(np.asarray(getattr(out, f.name)))
    want = {k: torch.from_numpy(np.stack(v)) for k, v in want.items()}
    got = step(model, State(**{k: torch.from_numpy(v) for k, v in start.items()}))
    dt = model.timestep
    close(got.xpos, want["xpos"], atol=1e-5)
    close(got.qacc, want["qacc"], atol=0.2, rtol=6e-3)
    close(got.qvel, want["qvel"], atol=1e-3)
    close(got.qpos, want["qpos"], atol=1e-6 + 2e-4 * dt)
    close(got.contact_sensordata[..., :4], want["contact_sensordata"][..., :4], atol=2e-3)
    close(got.actuator_force, want["actuator_force"], atol=1e-4, rtol=1e-4)
    close(got.time, want["time"], atol=0)
