"""The env builds its own world: ``VectorFlyEnv()`` and
``VectorFlyEnv(world, fly_name, ...)`` against the exported config-5 world
``env_fly.npz`` and against the JAX package's env, on the CPU.

The composed config-5 world (``_build_default_world``, the attractor and the
odor field, as ``scripts/export_env_golden.py:70-83`` builds it) compiles to
the file's arrays bit for bit but ``model.can_invweight`` (torch's
Cholesky and the neutral pose's mass matrix round otherwise than the JAX
compile's jitted ones, ``tests/test_torch_compile.py``) and two ulps of
``state.xquat``; so the composed env's engine step parts from the file's in
the last bits, and is held to :data:`STEP_RTOL` of each field's largest
value.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu_torch.compose.bridge import ENV_FLY, _read_npz, load_compiled, load_env_golden
from flygym_tpu_torch.demo import multimodal_navigation as nav
from flygym_tpu_torch.env import FlyEnv, VectorFlyEnv
from flygym_tpu_torch.env.gym import _build_default_world, world_tables
from flygym_tpu_torch.olfaction import OdorField

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
B = 2
TABLES = ("act_ids", "adh_ids", "qpos_adrs", "qvel_adrs", "sensor_slots", "root_body",
          "tip_bodies")
# can_invweight of the composed world against the file, relative (measured
# 1.24e-6).
INVWEIGHT_BAR = 2.5e-6
# ``state.xquat``: two ulps in two entries (tests/test_torch_compile.py).
XQUAT_ULPS = 2
# One engine-path env step (10 physics steps) of the composed env against
# the file's, relative to each field's largest value (measured: qvel 7.2e-6,
# vision 3.2e-5).
STEP_RTOL = 1e-4


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def composed_env():
    return nav.build_env(device="cpu", megastep=False)


@pytest.fixture(scope="module")
def file_env():
    compiled = load_compiled(ENV_FLY)
    return VectorFlyEnv(compiled, device="cpu", megastep=False, enable_vision=True,
                        odor_field=OdorField.for_compiled(compiled))


@pytest.fixture(scope="module")
def jax_default_env():
    from flygym_tpu.env import VectorFlyEnv as JaxVectorFlyEnv

    return JaxVectorFlyEnv()


def test_composed_world_compiles_to_the_file():
    """Every array of the composed config-5 world's compile against
    ``env_fly.npz``: bit-equal but ``can_invweight`` and ``state.xquat``."""
    _fly, world = nav.build_world()
    arrays, meta, _names = world.compile_arrays()
    ref, ref_meta = _read_npz(ENV_FLY)
    assert sorted(arrays) == sorted(ref)
    assert meta["model"] == ref_meta["model"]
    off = []
    for key, want in ref.items():
        got = arrays[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        if np.array_equal(got, want):
            continue
        if key == "model.can_invweight":
            assert (np.abs(got.astype(np.float64) - want) / np.abs(want)).max() <= INVWEIGHT_BAR
        elif key == "state.xquat":
            np.testing.assert_array_max_ulp(got, want, maxulp=XQUAT_ULPS)
        else:
            off.append(key)
    assert off == []


def test_composed_env_tables_equal_the_files(composed_env):
    """The env's index maps, eye bodies, odor tables and decision interval
    from the composed world equal ``meta["env"]`` of ``env_fly.npz``."""
    env = load_compiled(ENV_FLY).env
    assert composed_env.fly_name == env["fly"] == composed_env.fly.name
    assert composed_env.decision_interval == env["decision_interval"]
    for key in TABLES:
        got = getattr(composed_env, f"_{key}")
        got = got.tolist() if isinstance(got, torch.Tensor) else got
        assert got == env[key], key
    ret = composed_env.retina
    assert [ret.left_eye_body, ret.right_eye_body] == env["eye_bodies"]
    odor = composed_env.odor_field
    for key in ("source_pos", "peak_intensity", "sensor_bodies", "sensor_offsets"):
        np.testing.assert_array_equal(np.asarray(getattr(odor, key)),
                                      np.asarray(env["odor"][key], getattr(odor, key).dtype))
    assert odor.diffusion == env["odor"]["diffusion"]
    assert odor.gaussian_scale == env["odor"]["gaussian_scale"]


def test_default_env_tables_equal_jax(jax_default_env):
    """``VectorFlyEnv()``'s world and tables against JAX's ``VectorFlyEnv()``."""
    env = VectorFlyEnv(device="cpu")
    jenv = jax_default_env
    assert env.fly_name == jenv.fly_name == "fly0"
    assert env.world.fly_lookup.keys() == jenv.world.fly_lookup.keys()
    assert env.n_actuated == jenv.n_actuated == 42
    assert env.decision_interval == jenv.decision_interval
    for key in TABLES:
        got = getattr(env, f"_{key}")
        got = got.tolist() if isinstance(got, torch.Tensor) else got
        want = np.asarray(getattr(jenv, f"_{key}")).tolist()
        assert got == want, key
    np.testing.assert_array_equal(env._state0.qpos[0].numpy(), np.asarray(jenv._state0.qpos))
    np.testing.assert_array_equal(env._state0.ctrl[0].numpy(), np.asarray(jenv._state0.ctrl))
    assert env.retina is None and env.odor_field is None


def test_world_tables_of_a_named_fly():
    """``world_tables`` reads any fly's tables; the env takes the world's
    first fly without a name, and refuses a CUDA default without a card."""
    fly, world = _build_default_world("walker")
    world.compile()
    tables = world_tables(world, "walker")
    env = VectorFlyEnv(world, device="cpu")
    assert env.fly_name == "walker" and env.fly is fly
    assert env._act_ids.tolist() == tables["act_ids"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            VectorFlyEnv()


def test_one_env_step_equals_the_files(composed_env, file_env):
    """One engine-path env step of the composed env and of the ``.npz`` env
    from the golden's settled state and first action: the observation's
    index maps read the same entries, and every field agrees to
    :data:`STEP_RTOL` (the compile's ``can_invweight`` parts in the last
    bits)."""
    golden = load_env_golden()
    state = golden["state"].map(lambda x: x[:B].clone())
    action = {"joints": torch.as_tensor(golden["joints"][0, :B]),
              "adhesion": torch.as_tensor(golden["adhesion"][0, :B])}
    got = composed_env.step(state, action)
    want = file_env.step(state, action)
    for name in ("qpos", "qvel", "xpos", "contact_sensordata"):
        g, w = getattr(got[0], name), getattr(want[0], name)
        assert (g - w).abs().max() <= STEP_RTOL * w.abs().max(), name
    assert sorted(got[1]) == sorted(want[1])
    for key, w in want[1].items():
        g = got[1][key]
        assert g.shape == w.shape, key
        assert (g - w).abs().max() <= STEP_RTOL * max(w.abs().max(), 1.0), key
    torch.testing.assert_close(got[2], want[2], rtol=0.0, atol=STEP_RTOL)
    assert torch.equal(got[3], want[3])


def test_flyenv_passes_its_arguments_on():
    """``FlyEnv(world, fly_name, decision_interval=5, ...)`` builds its core
    from them, as JAX's ``FlyEnv`` does."""
    pytest.importorskip("gymnasium")
    fly, world = nav.build_world()
    env = FlyEnv(world, fly.name, decision_interval=5, device="cpu", render_camera="cam")
    core = env._core
    assert core.world is world and core.fly is fly and core.fly_name == "fly0"
    assert core.decision_interval == 5 and core.timestep == pytest.approx(5e-4)
    assert env._render_camera == "cam"
    assert env.action_space["joints"].shape == (42,)
    obs, _ = env.reset(seed=0)
    assert sorted(obs) == ["contact_forces", "end_effectors", "fly", "fly_orientation", "joints"]
