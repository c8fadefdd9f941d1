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
from flygym_tpu_torch.compose.bridge import BENCHMARK_FLY, _read_npz, load_golden
from flygym_tpu_torch.demo.benchmark import (
    GOLDEN_TOLERANCE,
    ReplayTargetData,
    track_golden,
)

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
    arrays, meta = exporter.export(world, sim)
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


@pytest.mark.parametrize(
    "key, value, what",
    [
        ("condim", 4, "condim 4"),
        ("solver_type", "pgs", "PGS"),
        ("has_hfield", True, "heightfield"),
        ("ncand_pair", 3, "pair rows"),
    ],
)
def test_unported_features_are_refused(key, value, what):
    arrays, meta = _read_npz(BENCHMARK_FLY)
    meta["model"][key] = value
    with pytest.raises(NotImplementedError, match=what):
        model_from_numpy(arrays, meta)


def test_replay_targets_equal_jax(fresh_export, compiled):
    fly, sim, _arrays, _meta = fresh_export
    dt = compiled.model.timestep
    want = JaxReplayTargetData(
        dt, fly.get_actuated_jointdofs_order(ActuatorType.POSITION)
    ).make_target_angles_all_worlds(12, 1000)
    order = Simulation(compiled).actuated_dofs(fly.name, "position")
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
    sim = BatchSimulation(compiled, 3)
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
    held, one = Simulation(compiled), Simulation(compiled)
    for s in (held, one):
        s.set_leg_adhesion_states(fly, np.ones(6))
    traj = one.rollout(np.full((2, compiled.model.nu), np.nan), 2)
    assert traj.shape == (2, compiled.model.nq)
    assert torch.equal(traj, held.rollout(None, 2))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, numpy as np, flygym_tpu_torch as ft\n"
        "sim = ft.BatchSimulation(ft.load_compiled(), 2)\n"
        "sim.rollout(None, 3, record_trajectory=False)\n"
        "assert np.isfinite(sim.state.qpos.numpy()).all()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flygym_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
