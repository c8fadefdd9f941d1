"""The port's single-world ``FlyEnv`` against the JAX package's, on the CPU.

Config 5's world (vision and odor). The two envs start from the same state
(settled world 0 of ``env_fly_golden.npz``), set into each env's core, and
take the same action: their states and observations are compared, not their
random streams (JAX's ``PRNGKey`` and the port's ``torch.Generator`` draw
different noise). The JAX side steps its engine jitted, as ``FlyEnv.step``
does; the port's CPU step is the engine step too.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu_torch.compose.bridge import ENV_FLY, load_compiled, load_env_golden
from flygym_tpu_torch.demo.render_cases import FRAME_BARS
from flygym_tpu_torch.env import FlyEnv, env_frame
from flygym_tpu_torch.env.gym import FRAME_QUAT, RESET_NOISE
from flygym_tpu_torch.olfaction import OdorField

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# As tests/test_torch_env.py holds the batched env: poses to 1e-5, rates
# and forces to 5e-3, vision 99.5% within 1e-3, odor 1e-5 relative.
POSE_ATOL, RATE_ATOL = 1e-5, 5e-3


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_env_golden", REPO / "scripts" / "export_env_golden.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def compiled():
    return load_compiled(ENV_FLY)


@pytest.fixture(scope="module")
def golden():
    return load_env_golden()


@pytest.fixture
def env(compiled):
    return FlyEnv(compiled, device="cpu", enable_vision=True,
                  odor_field=OdorField.for_compiled(compiled))


@pytest.fixture(scope="module")
def jax_env():
    from flygym_tpu.env.gym import FlyEnv as JaxFlyEnv

    exporter = _exporter()
    fly, world, _env = exporter.build_env()
    from flygym_tpu.olfaction import OdorField as JaxOdorField

    odor = JaxOdorField.for_fly(world, fly.name, **exporter.ODOR)
    return JaxFlyEnv(world, fly.name, enable_vision=True, odor_field=odor,
                     decision_interval=exporter.DECISION_INTERVAL)


def _settled(golden):
    return golden["state"].map(lambda x: x[:1].clone())


def test_spaces_hold_the_observations(env):
    obs, info = env.reset(seed=0)
    assert info == {}
    assert env.observation_space.contains({k: v.astype(np.float32) for k, v in obs.items()})
    assert set(obs) == {"joints", "fly", "contact_forces", "end_effectors", "fly_orientation",
                        "vision", "odor_intensity"}
    assert obs["vision"].shape == (2, 721, 2) and obs["joints"].shape == (3, 42)
    action = env.action_space.sample()
    assert set(action) == {"joints", "adhesion"} and action["joints"].shape == (42,)
    obs, reward, terminated, truncated, info = env.step(action)
    assert isinstance(reward, float) and isinstance(terminated, bool) and truncated is False
    assert env.observation_space.contains({k: v.astype(np.float32) for k, v in obs.items()})


def test_reset_is_seeded(env, compiled):
    """reset(seed=) seeds the generator: the same seed gives the same state,
    another seed another; the noise is RESET_NOISE on qpos, none on the free
    joint's quaternion."""
    env.reset(seed=3)
    first = env._state.qpos.clone()
    env.reset(seed=3)
    assert torch.equal(env._state.qpos, first)
    env.reset()
    assert not torch.equal(env._state.qpos, first)
    noise = (first - compiled.initial_state.qpos)[0]
    _b, qadr, _v = compiled.model.free_joints[0]
    assert (noise[qadr + 3 : qadr + 7] == 0).all()
    assert 0.5 * RESET_NOISE < noise.std() < 2 * RESET_NOISE


def test_step_from_a_shared_state_matches_jax(env, jax_env, golden):
    """Two env steps from the same settled state with the golden's actions:
    the states and every observation agree with JAX's FlyEnv."""
    import jax.numpy as jnp

    from flygym_tpu.engine.model import State as JaxState

    state = _settled(golden)
    env._state = state
    jax_env._state = JaxState(**{k: jnp.asarray(getattr(state, k)[0].numpy())
                                 for k in state.__dataclass_fields__})
    for i in range(2):
        action = {"joints": golden["joints"][i, 0], "adhesion": golden["adhesion"][i, 0]}
        obs, reward, done, _trunc, _info = env.step(action)
        want, jreward, jdone, _t, _i = jax_env.step(action)
        np.testing.assert_allclose(env._state.qpos[0].numpy(), np.asarray(jax_env._state.qpos),
                                   atol=POSE_ATOL)
        np.testing.assert_allclose(env._state.qvel[0].numpy(), np.asarray(jax_env._state.qvel),
                                   atol=RATE_ATOL)
        assert set(obs) == set(want)
        for key in ("end_effectors", "fly_orientation"):
            np.testing.assert_allclose(obs[key], want[key], atol=POSE_ATOL)
        np.testing.assert_allclose(obs["joints"][0], want["joints"][0], atol=POSE_ATOL)
        np.testing.assert_allclose(obs["joints"][1:], want["joints"][1:], atol=RATE_ATOL)
        np.testing.assert_allclose(obs["fly"][0::2], want["fly"][0::2], atol=POSE_ATOL)
        np.testing.assert_allclose(obs["fly"][1::2], want["fly"][1::2], atol=RATE_ATOL)
        np.testing.assert_allclose(obs["contact_forces"], want["contact_forces"], atol=RATE_ATOL)
        np.testing.assert_allclose(obs["odor_intensity"], want["odor_intensity"], rtol=1e-5)
        assert (np.abs(obs["vision"] - want["vision"]) <= 1e-3).mean() >= 0.995
        assert reward == pytest.approx(jreward, abs=1e-6) and done == jdone


def test_render_matches_jax(env, jax_env, golden):
    """FlyEnv.render's 240 x 320 uint8 frame from the same state as JAX's:
    the bars of the float frames, read on the uint8 levels (one level more
    for the cast's truncation)."""
    import jax.numpy as jnp

    from flygym_tpu.engine.model import State as JaxState

    state = _settled(golden)
    env._state = state
    jax_env._state = JaxState(**{k: jnp.asarray(getattr(state, k)[0].numpy())
                                 for k in state.__dataclass_fields__})
    got, want = env.render(), np.asarray(jax_env.render())
    assert got.shape == want.shape == (240, 320, 3) and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    assert (d.max(axis=-1) <= FRAME_BARS["atol"] * 255 + 1).mean() >= FRAME_BARS["share"]
    assert d.mean() / 255 <= FRAME_BARS["mean"]
    assert got.std() > 10


def test_env_frame_needs_no_gymnasium(compiled, golden):
    """The frame function behind render, on a batch, without the env."""
    state = golden["state"].map(lambda x: x[:2].clone())
    frames = env_frame(compiled.model, state, int(compiled.env["root_body"]), 24, 32)
    assert frames.shape == (2, 24, 32, 3) and torch.isfinite(frames).all()
    # The frame's orientation is the tracking camera's, as the export wrote it.
    trackcam = load_compiled().render["cameras"][0]
    assert trackcam["name"] == "trackcam" and tuple(trackcam["quat"]) == FRAME_QUAT
