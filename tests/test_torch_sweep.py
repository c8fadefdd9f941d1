"""The benchmark's world sweep and entry point on the CPU
(``flygym_tpu_torch/demo/benchmark.py``: ``make_model``, ``run_benchmark``,
``main``), at a tiny depth: the columns, the printed lines, bench.py's JSON
line, and which errors end the sweep."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from flygym_tpu_torch.demo import benchmark

torch.set_num_threads(1)

TINY = dict(sim_steps=16, warmup_steps=8, device="cpu")


def test_make_model_is_the_exported_benchmark_fly():
    """The JAX defaults, given as the JAX package's own enums and rotation
    or as plain values, are the exported fly; anything else raises."""
    from flygym_tpu.anatomy import ActuatedDOFPreset, JointPreset
    from flygym_tpu.compose import ActuatorType, KinematicPosePreset
    from flygym_tpu.utils.math import Rotation3D

    compiled = benchmark.make_model()
    assert compiled.model.nv == 72 and compiled.model.ncand == 110
    assert benchmark.make_model(position_gain=50, spawn_position=[0, 0, 0.8]).model.nv == 72
    assert benchmark.make_model(
        JointPreset.LEGS_ONLY, ActuatedDOFPreset.LEGS_ACTIVE_ONLY, ActuatorType.POSITION, 50.0,
        KinematicPosePreset.NEUTRAL, (0, 0, 0.8), Rotation3D("quat", (1, 0, 0, 0))).model.nv == 72
    for kwargs in ({"simplify_geom": True}, {"trim_contacts": True},
                   {"joints_preset": "all"}, {"position_gain": 20.0}):
        with pytest.raises(NotImplementedError, match="queue 1 item 9"):
            benchmark.make_model(**kwargs)
    with pytest.raises(TypeError):
        benchmark.make_model(gain=1.0)


def test_run_benchmark_returns_its_columns():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cols = benchmark.run_benchmark(1, 2, 2, **TINY)
    assert sorted(cols) == ["n_worlds", "realtime_factor", "steps_per_second", "walltime_s"]
    np.testing.assert_array_equal(cols["n_worlds"], [1, 2])
    assert (cols["walltime_s"] > 0).all()
    np.testing.assert_allclose(cols["steps_per_second"], 16 * cols["n_worlds"] / cols["walltime_s"])
    np.testing.assert_allclose(cols["realtime_factor"], cols["steps_per_second"] * 1e-4)
    lines = out.getvalue().splitlines()
    assert [line.split(" in ")[0] for line in lines] == [
        "Simulated 16 steps * 1 worlds", "Simulated 16 steps * 2 worlds"]
    assert all(line.endswith("world-steps/s)") for line in lines)
    with pytest.raises(NotImplementedError, match="renderer"):
        benchmark.run_benchmark(1, 2, 2, enable_rendering=True, **TINY)


def test_run_simulation_times_a_second_replay(monkeypatch):
    """bench.py's protocol: settle, one untimed replay, a timed replay from
    its end state, so the simulation has stepped settle + 2 x n steps."""
    compiled = benchmark.make_model()
    targets = benchmark.ReplayTargetData(1e-4, benchmark._position_dofs(compiled)) \
        .make_target_angles_all_worlds(2, 8)
    replays = []
    real = benchmark.replay_episode
    monkeypatch.setattr(benchmark, "replay_episode",
                        lambda *a, **k: replays.append(a[2].clone()) or real(*a, **k))
    walltime, sim = benchmark.run_simulation(compiled, targets, device="cpu", warmup_steps=4)
    assert walltime > 0 and len(replays) == 2
    assert abs(sim.time - (4 + 2 * 8) * 1e-4) < 1e-7


def test_only_running_out_of_memory_ends_the_sweep(monkeypatch):
    calls = []

    def oom_at_two(compiled, targets, **kwargs):
        calls.append(targets.shape[0])
        if targets.shape[0] == 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return 0.5, None

    monkeypatch.setattr(benchmark, "run_simulation", oom_at_two)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cols = benchmark.run_benchmark(1, 8, 2, **TINY)
    assert calls == [1, 2] and cols["n_worlds"].tolist() == [1]
    assert "Simulation failed for n_worlds=2" in out.getvalue()

    def broken(compiled, targets, **kwargs):
        raise RuntimeError("a kernel failed")

    monkeypatch.setattr(benchmark, "run_simulation", broken)
    with pytest.raises(RuntimeError, match="a kernel failed"):
        benchmark.run_benchmark(1, 8, 2, **TINY)


@pytest.fixture
def tiny_main(monkeypatch):
    """``main`` on the CPU at a tiny depth: its replay length and the
    simulation's device and settle patched in."""
    real = benchmark.run_simulation
    monkeypatch.setattr(benchmark, "SIM_STEPS", TINY["sim_steps"])
    monkeypatch.setattr(benchmark, "run_simulation", lambda compiled, targets: real(
        compiled, targets, device="cpu", warmup_steps=TINY["warmup_steps"]))
    return benchmark.main


def test_main_prints_bench_json_last(tiny_main, capsys):
    assert tiny_main(["2"]) == 0
    captured = capsys.readouterr()
    last = json.loads(captured.out.strip().splitlines()[-1])
    assert last["metric"] == "aggregate fly world-steps/s (kinematic replay, dt=1e-4)"
    assert last["unit"] == "world-steps/s" and last["value"] > 0
    assert last["vs_baseline"] == round(last["value"] / 600_000.0, 3)
    assert "n_worlds=2:" in captured.err


def test_main_fails_when_no_count_ran(monkeypatch, capsys):
    def oom(compiled, targets, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(benchmark, "run_simulation", oom)
    assert benchmark.main(["2", "4"]) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and "no world count ran" in captured.err
