"""The port's main path as a whole: the exported model, the batched runtime,
the replay targets, and a 50-step replay against the JAX golden."""

import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import flygym_tpu
from flygym_tpu.compose.fly import ActuatorType
from flygym_tpu.demo.benchmark import ReplayTargetData as JaxReplayTargetData

from flygym_tpu_torch import BatchSimulation, Simulation, load_compiled, model_from_numpy
from flygym_tpu_torch.compose.bridge import BENCHMARK_FLY, TWOFLY, _read_npz, load_golden
from flygym_tpu_torch.demo.benchmark import (
    GOLDEN_TOLERANCE,
    ReplayTargetData,
    track_golden,
)
from flygym_tpu_torch.ops.megastep import megastep_supported

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _load_exporter():
    spec = importlib.util.spec_from_file_location(
        "export_torch_model", REPO / "scripts" / "export_torch_model.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def fresh_export():
    exporter = _load_exporter()
    fly, world = exporter.build_benchmark()
    sim = flygym_tpu.Simulation(world)
    arrays, meta = exporter.export(world, sim, render=True)
    return fly, sim, arrays, meta


@pytest.fixture(scope="module")
def compiled():
    return load_compiled()


def test_committed_asset_equals_a_fresh_export(fresh_export):
    _fly, _sim, arrays, meta = fresh_export
    committed, committed_meta = _read_npz(BENCHMARK_FLY)
    assert sorted(committed) == sorted(arrays)
    for key, value in arrays.items():
        np.testing.assert_array_equal(committed[key], value, err_msg=key)
        assert committed[key].dtype == value.dtype, key
    assert committed_meta == json.loads(json.dumps(meta))


def test_fresh_export_loads_like_the_committed_one(fresh_export, compiled):
    _fly, _sim, arrays, meta = fresh_export
    fresh = model_from_numpy(arrays, meta)
    for f in dataclasses.fields(fresh.model):
        a, b = getattr(fresh.model, f.name), getattr(compiled.model, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
    assert fresh.flies == compiled.flies


@pytest.mark.parametrize("key, value, what", [("differentiable", True, "differentiable mode")])
def test_unported_features_are_refused(key, value, what):
    """On example 11's two-fly world, whose 49 uncompressed pair rows load."""
    arrays, meta = _read_npz(TWOFLY)
    meta["model"][key] = value
    with pytest.raises(NotImplementedError, match=what):
        model_from_numpy(arrays, meta)


@pytest.mark.parametrize(
    "key, value, on_k2",
    [
        # JAX's gate refuses PGS too (flygym_tpu/ops/megastep.py:976).
        ("solver_type", "pgs", False),
        # K2 takes condim 1, 4 and 6 on ground rows; pair rows at a condim
        # other than 3 run on the engine step.
        ("condim", 4, False),
        ("condim", 1, False),
    ],
)
def test_ported_features_load(key, value, on_k2):
    """The same edits of example 11's two-fly export load, and K2's gate
    takes or refuses them."""
    arrays, meta = _read_npz(TWOFLY)
    meta["model"][key] = value
    model = model_from_numpy(arrays, meta).model
    assert getattr(model, key) == value
    assert megastep_supported(model) is on_k2


def test_replay_targets_equal_jax(fresh_export, compiled):
    fly, sim, _arrays, _meta = fresh_export
    dt = compiled.model.timestep
    want = JaxReplayTargetData(
        dt, fly.get_actuated_jointdofs_order(ActuatorType.POSITION)
    ).make_target_angles_all_worlds(12, 1000)
    order = Simulation(compiled, device="cpu").actuated_dofs(fly.name, "position")
    got = ReplayTargetData(dt, order).make_target_angles_all_worlds(12, 1000)
    np.testing.assert_array_equal(got, want)
    golden = load_golden()
    np.testing.assert_array_equal(
        ReplayTargetData(dt, order).make_target_angles_all_worlds(*golden["targets"].shape[:2]),
        golden["targets"],
    )


def test_batch_tracks_the_jax_golden(compiled):
    """Two worlds for the golden's 50 replay steps; the tolerances and their
    reason are ``GOLDEN_TOLERANCE`` (measured here: qpos 8e-6, qvel 5e-2)."""
    worst = track_golden(compiled, load_golden(), device="cpu", n_worlds=2)
    for key, tol in GOLDEN_TOLERANCE.items():
        assert worst[key] <= tol, (key, worst[key])


def test_runtime_getters_setters_and_reset(compiled):
    sim = BatchSimulation(compiled, 3, device="cpu")
    fly = compiled.fly_names[0]
    n_pos = len(sim.actuated_dofs(fly, "position"))
    assert sim.get_joint_angles(fly).shape == (3, len(compiled.flies[fly]["qpos_adrs"]))
    with pytest.raises(ValueError, match="Expected"):
        sim.set_actuator_inputs(fly, "position", np.zeros(n_pos + 1))
    sim.set_leg_adhesion_states(fly, np.ones(6))
    sim.set_actuator_inputs(fly, "position", np.zeros((3, n_pos)))
    traj = sim.rollout(None, 3)
    assert traj.shape == (3, 3, compiled.model.nq)
    assert abs(sim.time - 3 * compiled.model.timestep) < 1e-9
    active, forces, *_ = sim.get_ground_contact_info(fly)
    assert active.shape == (3, 6) and forces.shape == (3, 6, 3)
    adhesion = sim.get_actuator_forces(fly, "adhesion")
    assert torch.all(adhesion > 0)
    sim.reset()
    assert sim.time == 0.0
    torch.testing.assert_close(sim.state.qpos[0], compiled.initial_state.qpos[0])

    # NaN controls hold the previous ones, like no control sequence at all.
    held, one = Simulation(compiled, device="cpu"), Simulation(compiled, device="cpu")
    for s in (held, one):
        s.set_leg_adhesion_states(fly, np.ones(6))
    traj = one.rollout(np.full((2, compiled.model.nu), np.nan), 2)
    assert traj.shape == (2, compiled.model.nq)
    assert torch.equal(traj, held.rollout(None, 2))


def test_simulation_defaults_to_the_card(compiled):
    """No device means CUDA: without a card the constructor raises instead
    of running on the CPU."""
    if torch.cuda.is_available():
        assert Simulation(compiled).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Simulation(compiled)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BatchSimulation(compiled, 2)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, numpy as np, flygym_tpu_torch as ft\n"
        "import flygym_tpu_torch.ops._build\n"
        "sim = ft.BatchSimulation(ft.load_compiled(), 2, device='cpu')\n"
        "sim.rollout(None, 3, record_trajectory=False)\n"
        "assert np.isfinite(sim.state.qpos.numpy()).all()\n"
        "mega = ft.BatchSimulation(ft.load_compiled(), 2, device='cpu', megastep=True, megastep_k=2)\n"
        "mega.rollout(None, 2, record_trajectory=False)\n"
        "assert np.isfinite(mega.state.qpos.numpy()).all()\n"
        "ft.ops.megastep.model_header(mega.model)\n"
        "import flygym_tpu_torch.vision, flygym_tpu_torch.render.raycast\n"
        "import flygym_tpu_torch.ops.retina, flygym_tpu_torch.olfaction, flygym_tpu_torch.env.gym\n"
        "from flygym_tpu_torch.compose.bridge import ENV_FLY\n"
        "c = ft.load_compiled(ENV_FLY)\n"
        "env = flygym_tpu_torch.env.gym.VectorFlyEnv(c, device='cpu', megastep=False,\n"
        "    enable_vision=True, odor_field=flygym_tpu_torch.olfaction.OdorField.for_compiled(c))\n"
        "s = env.reset_batched(None, 2)\n"
        "a = {'joints': s.ctrl[:, env._act_ids], 'adhesion': np.ones((2, 6))}\n"
        "s, obs, r, d, _ = env.make_batched_step()(s, a)\n"
        "assert np.isfinite(obs['vision'].numpy()).all()\n"
        "import flygym_tpu_torch.demo.hybrid_terrain as ht\n"
        "from flygym_tpu_torch.compose.bridge import TERRAIN_FLY\n"
        "tsim = ft.BatchSimulation(ft.load_compiled(TERRAIN_FLY), 2, device='cpu')\n"
        "loop = ht.HybridLoop(tsim)\n"
        "loop.run(loop.init_state(None), 2)\n"
        "assert np.isfinite(tsim.state.qpos.numpy()).all()\n"
        "from flygym_tpu_torch.compose.bridge import TWOFLY\n"
        "two = ft.BatchSimulation(ft.load_compiled(TWOFLY), 2, device='cpu')\n"
        "two.rollout(None, 1, record_trajectory=False)\n"
        "assert np.isfinite(two.state.qpos.numpy()).all()\n"
        "from flygym_tpu_torch.compose.bridge import TWOFLY_FULL\n"
        "full = ft.BatchSimulation(ft.load_compiled(TWOFLY_FULL), 2, device='cpu')\n"
        "full.rollout(None, 1, record_trajectory=False)\n"
        "assert np.isfinite(full.state.qpos.numpy()).all()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flygym_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
