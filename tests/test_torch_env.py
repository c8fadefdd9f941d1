"""The port's RL env (config 5: vision and odor) against the JAX package's.

Inputs are the JAX settled env state and the actions of
``flygym_tpu_torch/assets/env_fly_golden.npz``; the JAX side is
``VectorFlyEnv.make_batched_step()`` on the CPU (the vmapped engine step and
the jnp retina) and, for the mega-step path, the golden of the JAX
emitter. The port runs on the CPU: the engine step with ``megastep=False``,
K3's plain version for vision.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu_torch.compose.bridge import (
    ENV_FLY,
    _read_npz,
    load_compiled,
    load_env_golden,
)
from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE
from flygym_tpu_torch.env import VectorFlyEnv
from flygym_tpu_torch.olfaction import OdorField
from flygym_tpu_torch.ops import retina as rk

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
B = 2
N_STEPS = 2
# Observation bars against the JAX engine path on the CPU, by kind: poses
# and orientation (FK of qpos within 1e-6), velocities and forces (the
# engine's qvel agrees to ~5e-4 over 20 steps, measured), and vision (the
# JAX package's bar for its retina kernel against its jnp oracle,
# tests/engine/test_retina_kernel.py:97-98: 99.5% within 1e-3).
POSE_ATOL = 1e-5
RATE_ATOL = 5e-3
OBS_KEYS = ["joints", "fly", "contact_forces", "end_effectors", "fly_orientation",
            "odor_intensity", "vision"]


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_obs(key: str, got: np.ndarray, want: np.ndarray) -> None:
    """One observation against JAX's, to the bars above."""
    assert got.shape == want.shape, key
    if key == "vision":
        assert (np.abs(got - want) <= 1e-3).mean() >= 0.995
    elif key == "odor_intensity":
        np.testing.assert_allclose(got, want, rtol=1e-5)
    elif key == "joints":  # pos, vel, force rows
        np.testing.assert_allclose(got[:, 0], want[:, 0], atol=POSE_ATOL)
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=RATE_ATOL)
    elif key == "fly":  # pos, vel, heading, angular velocity rows
        np.testing.assert_allclose(got[:, 0::2], want[:, 0::2], atol=POSE_ATOL)
        np.testing.assert_allclose(got[:, 1::2], want[:, 1::2], atol=RATE_ATOL)
    elif key == "contact_forces":
        np.testing.assert_allclose(got, want, atol=RATE_ATOL)
    else:
        np.testing.assert_allclose(got, want, atol=POSE_ATOL)


@pytest.fixture(scope="module")
def compiled():
    return load_compiled(ENV_FLY)


@pytest.fixture(scope="module")
def golden():
    return load_env_golden()


@pytest.fixture(scope="module")
def exporter():
    return _load_script("export_env_golden")


@pytest.fixture(scope="module")
def jax_env(exporter):
    return exporter.build_env()


def _jax_state(state, n):
    """The first n worlds of a port State as a JAX State."""
    import jax.numpy as jnp

    from flygym_tpu.engine.model import State as JaxState

    return JaxState(**{
        f.name: jnp.asarray(getattr(state, f.name)[:n].numpy())
        for f in dataclasses.fields(state)
    })


def _port_env(compiled, **kw):
    return VectorFlyEnv(compiled, device="cpu", enable_vision=True,
                        odor_field=OdorField.for_compiled(compiled), **kw)


def _action(golden, i, n=B):
    return {"joints": torch.as_tensor(golden["joints"][i, :n]),
            "adhesion": torch.as_tensor(golden["adhesion"][i, :n])}


@pytest.fixture(scope="module")
def jax_rollout(jax_env, golden):
    """N_STEPS of JAX make_batched_step() from B settled worlds."""
    import jax
    import jax.numpy as jnp

    _fly, _world, env = jax_env
    states = _jax_state(golden["state"], B)
    step = env.make_batched_step()
    out = []
    for i in range(N_STEPS):
        action = {k: jnp.asarray(v.numpy()) for k, v in _action(golden, i).items()}
        states, obs, reward, done, _ = step(states, action)
        out.append(dict(
            qpos=np.asarray(states.qpos), qvel=np.asarray(states.qvel),
            obs={k: np.asarray(v) for k, v in obs.items()},
            reward=np.asarray(reward), done=np.asarray(done),
        ))
    return out


@pytest.fixture(scope="module")
def port_rollout(compiled, golden):
    env = _port_env(compiled, megastep=False)
    step = env.make_batched_step()
    states = golden["state"].map(lambda x: x[:B].clone())
    out = []
    for i in range(N_STEPS):
        states, obs, reward, done, _ = step(states, _action(golden, i))
        out.append(dict(
            qpos=states.qpos.numpy(), qvel=states.qvel.numpy(),
            obs={k: v.numpy() for k, v in obs.items()},
            reward=reward.numpy(), done=done.numpy(),
        ))
    return out


def test_committed_env_asset_equals_a_fresh_export(exporter, jax_env):
    import flygym_tpu

    exp = _load_script("export_torch_model")
    _fly, world, env = jax_env
    arrays, meta = exp.export(world, flygym_tpu.Simulation(world))
    committed, committed_meta = _read_npz(ENV_FLY)
    assert sorted(committed) == sorted(arrays)
    for key, value in arrays.items():
        np.testing.assert_array_equal(committed[key], value, err_msg=key)
    meta["env"] = exporter.env_meta(env)
    assert committed_meta == meta


@pytest.mark.parametrize("diffusion", ["inverse_square", "gaussian"])
def test_odor_sample_matches_jax(compiled, golden, jax_env, diffusion):
    import jax

    _fly, _world, env = jax_env
    want_field = dataclasses.replace(env.odor_field, diffusion=diffusion, gaussian_scale=20.0)
    states = golden["state"].map(lambda x: x[:4].clone())
    jstate = _jax_state(golden["state"], 4)
    want = np.asarray(jax.vmap(lambda s: want_field.sample(env.model, s))(jstate))
    field = OdorField.for_compiled(compiled, diffusion=diffusion, gaussian_scale=20.0)
    got = field.sample(compiled.model, states).numpy()
    assert got.shape == want.shape == (4, 1, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(
        field.sensor_positions(states).numpy(),
        np.asarray(jax.vmap(want_field.sensor_positions)(jstate)), atol=1e-6,
    )


@pytest.mark.parametrize("step", range(N_STEPS))
@pytest.mark.parametrize("key", OBS_KEYS)
def test_env_observations_match_jax(jax_rollout, port_rollout, key, step):
    check_obs(key, port_rollout[step]["obs"][key], jax_rollout[step]["obs"][key])


@pytest.mark.parametrize("step", range(N_STEPS))
def test_env_state_reward_done_match_jax(jax_rollout, port_rollout, step):
    got, want = port_rollout[step], jax_rollout[step]
    assert np.abs(got["qpos"] - want["qpos"]).max() <= GOLDEN_TOLERANCE["qpos"]
    assert np.abs(got["qvel"] - want["qvel"]).max() <= GOLDEN_TOLERANCE["qvel"]
    np.testing.assert_allclose(got["reward"], want["reward"], atol=1e-6)
    np.testing.assert_array_equal(got["done"], want["done"])


@pytest.mark.parametrize("step", range(N_STEPS))
def test_committed_engine_golden_equals_fresh_jax(golden, jax_rollout, step):
    """The committed engine golden (8 worlds) is what JAX computes for its
    first B worlds. JAX itself rounds otherwise at another batch size (qvel
    4.5e-4 apart, measured), so the bars are the port's."""
    rec, want = golden["engine"], jax_rollout[step]
    np.testing.assert_allclose(rec["qpos"][step, :B], want["qpos"], atol=POSE_ATOL)
    np.testing.assert_allclose(rec["qvel"][step, :B], want["qvel"], atol=RATE_ATOL)
    for key in OBS_KEYS:
        check_obs(key, rec["obs"][key][step, :B], want["obs"][key])
    np.testing.assert_allclose(rec["reward"][step, :B], want["reward"], atol=1e-6)
    np.testing.assert_array_equal(rec["done"][step, :B], want["done"])


def test_megastep_env_step_tracks_the_emitter_golden(compiled, golden):
    """One env step of one world through the mega-step path on the CPU: 10
    plain-emitter steps in one K = 10 call, against the JAX emitter golden
    (measured bit-identical in qpos and qvel)."""
    env = _port_env(compiled, megastep=True)
    assert env.megastep and env._megastep_fn.k_steps == 10
    states = golden["state"].map(lambda x: x[:1].clone())
    states, obs, reward, done, _ = env.make_batched_step()(states, _action(golden, 0, 1))
    rec = golden["emitter"]
    assert np.abs(states.qpos.numpy() - rec["qpos"][0, :1]).max() <= 1e-6
    assert np.abs(states.qvel.numpy() - rec["qvel"][0, :1]).max() <= 1e-3
    for key in OBS_KEYS:
        check_obs(key, obs[key].numpy(), rec["obs"][key][0, :1])
    np.testing.assert_allclose(reward.numpy(), rec["reward"][0, :1], atol=1e-6)
    assert float(states.time[0]) == pytest.approx(float(golden["state"].time[0]) + 1e-3, abs=1e-6)


def test_auto_reset_replaces_exactly_the_done_worlds(compiled, golden):
    env = _port_env(compiled, megastep=False)
    launched = rk.launches["retina"]
    states = golden["state"].map(lambda x: x[:4].clone())
    qpos = states.qpos.clone()
    qpos[1::2, 3:7] = torch.tensor([0.0, 1.0, 0.0, 0.0])  # worlds 1 and 3 upside down: done
    states = dataclasses.replace(states, qpos=qpos)
    action = _action(golden, 0, 4)
    plain_states, _obs, plain_reward, plain_done, _ = env.make_batched_step()(states, action)
    step = env.make_batched_step(auto_reset=True)
    new, obs, reward, done, _ = step(states, action, torch.Generator().manual_seed(7))
    assert done.tolist() == [False, True, False, True]
    assert torch.equal(done, plain_done) and torch.equal(reward, plain_reward)
    fresh = env.reset_batched(torch.Generator().manual_seed(7), 4)
    for f in dataclasses.fields(new):
        got, kept, reset = (getattr(s, f.name) for s in (new, plain_states, fresh))
        assert torch.equal(got[1::2], reset[1::2]), f.name
        assert torch.equal(got[0::2], kept[0::2]), f.name
    np.testing.assert_allclose(obs["joints"][1::2, 0].numpy(),
                               fresh.qpos[1::2][:, env._qpos_adrs].numpy())
    assert obs["vision"].shape == (4, 2, 721, 2)
    assert rk.launches["retina"] == launched  # the CPU runs K3's plain version


def test_step_and_observe_render_through_the_kernel_wrapper(compiled, golden):
    """``step`` and ``observe`` take vision from K3's wrapper and the blur
    (on the CPU: K3's plain version), as the training step does."""
    env = _port_env(compiled, megastep=False)
    launched = rk.launches["retina"]
    states = golden["state"].map(lambda x: x[:B].clone())
    states, obs, _reward, _done, _ = env.step(states, _action(golden, 0))
    tables = env.render_vision.kernel.tables
    want = env.retina.apply_acceptance(
        rk.retina_plain(tables, rk.pack_rows(tables, states.xpos, states.xquat)))
    assert torch.equal(obs["vision"], want)
    assert torch.equal(env.observe(states)["vision"], want)
    assert rk.launches["retina"] == launched


@pytest.fixture
def cuda_compiled():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return load_compiled(ENV_FLY)


@pytest.mark.cuda
def test_step_on_the_card_launches_the_retina_kernel(cuda_compiled):
    """On the card, ``step`` and ``observe`` launch K3 once each."""
    env = VectorFlyEnv(cuda_compiled, enable_vision=True)
    states = load_env_golden()["state"].map(lambda x: x[:B].clone()).to("cuda")
    action = {"joints": env._state0.ctrl[:, env._act_ids], "adhesion": torch.ones(6)}
    before = rk.launches["retina"]
    states, obs, _reward, _done, _ = env.step(states, action)
    assert rk.launches["retina"] == before + 1
    env.observe(states)
    assert rk.launches["retina"] == before + 2
    assert obs["vision"].shape == (B, 2, 721, 2)
    assert torch.isfinite(obs["vision"]).all()


def test_reset_noise(compiled):
    env = _port_env(compiled, megastep=False)
    one = env.reset(torch.Generator().manual_seed(0))
    assert one.qpos.shape == (1, compiled.model.nq)
    a = env.reset_batched(torch.Generator().manual_seed(3), 5)
    b = env.reset_batched(torch.Generator().manual_seed(3), 5)
    c = env.reset_batched(torch.Generator().manual_seed(4), 5)
    assert torch.equal(a.qpos, b.qpos) and not torch.equal(a.qpos, c.qpos)
    q0 = compiled.initial_state.qpos
    for _b, qadr, _v in compiled.model.free_joints:
        assert torch.equal(a.qpos[:, qadr + 3 : qadr + 7], q0[:, qadr + 3 : qadr + 7].expand(5, 4))
    noise = a.qpos - q0
    assert 0.005 < noise.std().item() < 0.02
    assert torch.equal(a.xpos, compiled.initial_state.xpos.expand_as(a.xpos))


def test_env_defaults_to_the_card(compiled):
    """No device means CUDA: without a card the constructor raises instead
    of running on the CPU."""
    if torch.cuda.is_available():
        assert VectorFlyEnv(compiled).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            VectorFlyEnv(compiled)


def test_env_needs_env_metadata():
    with pytest.raises(ValueError, match="env metadata"):
        VectorFlyEnv(load_compiled(), device="cpu")
    env = _port_env(load_compiled(ENV_FLY), megastep=False)
    assert env.decision_interval == 10 and env.n_actuated == 42
    assert env.timestep == pytest.approx(1e-3)
