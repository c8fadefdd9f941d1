"""Examples 05, 06, 09 and 13 in torch (``flygym_tpu_torch/demo/``) against
the JAX package's examples, on the CPU.

- 05 (``demo/vision_olfaction.py``): the retina and the odor of the
  composed world against JAX's jitted render and sample on JAX's compile of
  the same world, within ``tests/test_torch_vision.py``'s bars;
- 06 (``demo/rl_environment.py``): ``FlyEnv()``'s spaces and observation
  keys against JAX's; the batched half at 4 worlds;
- 09 (``demo/multimodal_navigation.py``): the observation shapes at 4 worlds;
- 13 (``demo/rl_training_es.py``): the policy against JAX's ``make_policy``
  for the same θ and t, the ES update against JAX's formula, a short run,
  and (marked slow, as JAX's) the learning criterion at ``--small``.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu_torch.demo import multimodal_navigation as nav
from flygym_tpu_torch.demo import rl_environment, rl_training_es, vision_olfaction

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
N_ENVS = 4
# Vision against JAX's jitted render: the JAX package's bar for its kernel
# against its jnp oracle (tests/engine/test_retina_kernel.py:97-98), as
# tests/test_torch_vision.py holds K3's plain version; odor as
# tests/test_torch_env.py holds it.
VISION_ATOL, VISION_SHARE = 1e-3, 0.995
ODOR_RTOL = 1e-5
# The policy's joint targets against JAX's: glibc's sin on both sides, the
# frequency's exp rounded by torch's and XLA's own exp.
POLICY_ATOL = 1e-6


def _example(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_env():
    from flygym_tpu.env import VectorFlyEnv as JaxVectorFlyEnv

    return JaxVectorFlyEnv()


@pytest.fixture(scope="module")
def port_env():
    from flygym_tpu_torch.env import VectorFlyEnv

    return VectorFlyEnv(device="cpu")


def test_example_05_matches_jax():
    """The retina and the odor of example 05's world, composed and rendered
    by the port, against JAX's example 05 on JAX's compile of it."""
    import jax

    from flygym_tpu.anatomy import AxisOrder, JointPreset, Skeleton
    from flygym_tpu.compose import FlatGroundWorld, Fly, KinematicPosePreset
    from flygym_tpu.olfaction import OdorField
    from flygym_tpu.utils.math import Rotation3D
    from flygym_tpu.vision import Retina

    got = vision_olfaction.main(device="cpu", verbose=False)
    fly = Fly(name="fly0")
    fly.add_joints(Skeleton(axis_order=AxisOrder.YPR, joint_preset=JointPreset.LEGS_ONLY),
                   neutral_pose=KinematicPosePreset.NEUTRAL)
    fly.colorize()
    world = FlatGroundWorld()
    world.add_fly(fly, (0, 0, 2.0), Rotation3D("quat", (1, 0, 0, 0)))
    model, state = world.compile()
    want = np.asarray(jax.jit(Retina.for_fly(world, "fly0").render)(model, state))
    field = OdorField.for_fly(world, "fly0", **vision_olfaction.ODOR_SOURCE)
    want_odor = np.asarray(jax.jit(field.sample)(model, state))
    assert got["intensities"].shape == want.shape == (2, 721, 2)
    assert (np.abs(got["intensities"] - want) <= VISION_ATOL).mean() >= VISION_SHARE
    assert abs(got["intensities"].mean() - want.mean()) <= 1e-4
    np.testing.assert_allclose(got["odor"], want_odor, rtol=ODOR_RTOL)
    assert got["odor"][0, 0] > got["odor"][0, 1]


def test_example_06_flyenv_spaces_and_keys_match_jax():
    """``FlyEnv()``'s action and observation spaces and the keys of its
    observation against JAX's ``FlyEnv()``."""
    pytest.importorskip("gymnasium")
    from flygym_tpu.env import FlyEnv as JaxFlyEnv

    got = rl_environment.gym_half(device="cpu", verbose=False)
    want = JaxFlyEnv()
    want_obs, _ = want.reset(seed=0)
    assert sorted(got["obs"]) == sorted(want_obs)
    for name in ("action_space", "observation_space"):
        g, w = got[name], getattr(want, name)
        assert sorted(g.spaces) == sorted(w.spaces), name
        for key, space in w.spaces.items():
            assert g[key].shape == space.shape and g[key].dtype == space.dtype, (name, key)
            np.testing.assert_array_equal(g[key].low, space.low)
            np.testing.assert_array_equal(g[key].high, space.high)
    for key, value in want_obs.items():
        assert got["obs"][key].shape == value.shape, key
    assert np.isfinite(got["reward"]) and got["terminated"] in (False, True)


def test_example_06_batched_half():
    out = rl_environment.vector_half(N_ENVS, device="cpu", verbose=False)
    assert out["rewards"].shape == out["dones"].shape == (N_ENVS,)
    assert torch.isfinite(out["rewards"]).all() and not out["dones"].any()
    assert out["states"].qpos.shape == (N_ENVS, 73)  # a free joint and 66 hinges


def test_example_09_observation_shapes():
    """Example 09 at 4 worlds: the shapes JAX's example prints."""
    out = nav.main(N_ENVS, device="cpu", verbose=False)
    shapes = {k: tuple(v.shape) for k, v in out["obs"].items()}
    assert shapes == {
        "joints": (N_ENVS, 3, 42), "fly": (N_ENVS, 4, 3), "contact_forces": (N_ENVS, 6, 3),
        "end_effectors": (N_ENVS, 6, 3), "fly_orientation": (N_ENVS, 3),
        "odor_intensity": (N_ENVS, 1, 4), "vision": (N_ENVS, 2, 721, 2),
    }
    assert all(torch.isfinite(v).all() for v in out["obs"].values())
    assert out["env"].megastep is False and out["env"].retina is not None


def _theta(seed: int, n_act: int, lead=()) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "amp": rng.normal(0.0, 0.5, lead + (n_act,)).astype(np.float32),
        "phase": rng.normal(0.0, 1.0, lead + (n_act,)).astype(np.float32),
        "leg_phase": rng.uniform(0.0, 6.3, lead + (6,)).astype(np.float32),
        "log_freq": rng.uniform(-2.0, 2.0, lead).astype(np.float32),
    }


def test_example_13_policy_matches_jax(jax_env, port_env):
    """The gait policy for the same θ and t, one θ and a population of 16,
    against JAX's ``make_policy`` (vmapped over the population)."""
    import jax
    import jax.numpy as jnp

    _init, jax_policy = _example("13_rl_training_es").make_policy(jax_env)
    _init, policy = rl_training_es.make_policy(port_env)
    for lead in ((), (16,)):
        theta = _theta(len(lead), port_env.n_actuated, lead)
        for t in (0.0, 0.013, 0.0999):
            t32 = np.float32(t)
            got = policy({k: torch.from_numpy(v) for k, v in theta.items()}, float(t32))
            jt = {k: jnp.asarray(v) for k, v in theta.items()}
            fn = (lambda th: jax_policy(th, t32)) if not lead else jax.vmap(
                lambda th: jax_policy(th, t32))
            want = fn(jt)
            np.testing.assert_allclose(got["joints"].numpy(), np.asarray(want["joints"]),
                                       rtol=0.0, atol=POLICY_ATOL)
            np.testing.assert_array_equal(got["adhesion"].numpy(), np.asarray(want["adhesion"]))


def test_example_13_flattening_is_ravel_pytree(port_env):
    """θ flattens in ``ravel_pytree``'s order and back."""
    from jax.flatten_util import ravel_pytree

    theta = _theta(5, port_env.n_actuated)
    flat, _unravel = ravel_pytree({k: np.asarray(v) for k, v in theta.items()})
    got = rl_training_es.flatten({k: torch.from_numpy(v) for k, v in theta.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(flat))
    back = rl_training_es.unflatten(got, port_env.n_actuated)
    for k, v in theta.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_example_13_es_update_matches_jax_formula():
    """The rank-normalised antithetic update against example 13's formula
    in jnp, for fixed returns (with ties) and eps made with numpy."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    half, n_param, sigma, lr = 32, 91, 0.05, 0.25
    flat = rng.normal(0.0, 0.1, n_param).astype(np.float32)
    eps = rng.standard_normal((half, n_param)).astype(np.float32)
    returns = np.round(rng.normal(0.02, 0.01, 2 * half), 3).astype(np.float32)
    adv = jnp.asarray(returns[:half]) - jnp.asarray(returns[half:])
    ranks = jnp.argsort(jnp.argsort(adv)).astype(jnp.float32)
    w = ranks / jnp.maximum(half - 1, 1) - 0.5
    want = jnp.asarray(flat) + lr * ((w[:, None] * jnp.asarray(eps)).mean(axis=0) / sigma)
    got = rl_training_es.es_update(torch.from_numpy(flat), torch.from_numpy(returns),
                                   torch.from_numpy(eps), sigma, lr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0.0, atol=1e-7)


def test_example_13_main_runs(tmp_path):
    """As ``tests/examples/test_examples_smoke.py:85-90`` asks of JAX's."""
    curve = rl_training_es.main(n_envs=8, n_updates=2, episode_len=5, device="cpu",
                                out=tmp_path / "curve.csv")
    assert np.isfinite(curve).all() and len(curve) == 2
    np.testing.assert_allclose(np.loadtxt(tmp_path / "curve.csv"), curve, rtol=1e-6)


@pytest.mark.slow
def test_es_training_improves_reward():
    """``tests/examples/test_rl_training.py``'s criterion at ``--small``:
    the last two updates' mean reward above twice the first two's."""
    curve, _theta = rl_training_es.train(n_envs=64, n_updates=10, episode_len=25, seed=0,
                                         device="cpu", verbose=False)
    first, last = curve[:2].mean(), curve[-2:].mean()
    assert np.isfinite(curve).all()
    assert last > 2.0 * first, (first, last, np.round(curve, 5))


@pytest.mark.parametrize("entry", ["05", "06 gym", "06 vector", "09", "13"])
def test_examples_refuse_a_missing_card(entry):
    """The examples run on the card unless the caller passes
    ``device="cpu"``: without CUDA they raise, and nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fn = {"05": vision_olfaction.main, "06 gym": rl_environment.gym_half,
          "06 vector": rl_environment.vector_half, "09": nav.main,
          "13": rl_training_es.train}[entry]
    with pytest.raises(RuntimeError, match="CUDA|cuda"):
        fn()
