"""The benchmark's world sweep and entry point on the CPU
(``flygym_tpu_torch/demo/benchmark.py``: ``make_model``, ``run_benchmark``,
``main``), at a tiny depth: the world make_model composes, the columns, the
printed lines, bench.py's JSON line, and which errors end the sweep."""

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
    """make_model composes the benchmark fly and world in the port: at the
    JAX defaults, given as the port's enums, the JAX package's enums and
    rotation, or plain values, it compiles to the exported fly (bit-equal
    but the inverse weights, ``tests/test_torch_compile.py``); every other
    argument of the JAX package's make_model compiles too."""
    from flygym_tpu.anatomy import ActuatedDOFPreset, JointPreset
    from flygym_tpu.compose import ActuatorType, KinematicPosePreset
    from flygym_tpu.utils.math import Rotation3D

    from flygym_tpu_torch.compose.bridge import load_compiled

    exported = load_compiled().model
    for args, kwargs in [
            ((), {}), ((), {"position_gain": 50, "spawn_position": [0, 0, 0.8]}),
            ((JointPreset.LEGS_ONLY, ActuatedDOFPreset.LEGS_ACTIVE_ONLY, ActuatorType.POSITION,
              50.0, KinematicPosePreset.NEUTRAL, (0, 0, 0.8), Rotation3D("quat", (1, 0, 0, 0))),
             {}),
            (("legs_only", "legs_active_only", "position", 50.0, "neutral", (0, 0, 0.8),
              (1, 0, 0, 0)), {})]:
        fly, world, cam = benchmark.make_model(*args, **kwargs)
        model, _state = world.compile()
        assert fly.name == "nmf" and cam.full_identifier == "nmf/trackcam"
        assert torch.equal(model.qpos0, exported.qpos0)
        assert torch.equal(model.body_inertia, exported.body_inertia)
        assert torch.allclose(model.can_invweight, exported.can_invweight, rtol=5e-5)
    for kwargs, check in [
            ({"simplify_geom": True}, lambda m: not torch.equal(m.body_inertia,
                                                                exported.body_inertia)),
            ({"trim_contacts": True}, lambda m: m.ncand == 36 and m.nsensor_contact == 0),
            ({"joints_preset": "all_biological"}, lambda m: m.nv == 132),
            ({"position_gain": 20.0}, lambda m: float(m.act_gain[0]) == 20.0)]:
        _fly, world, _cam = benchmark.make_model(**kwargs)
        assert check(world.compile()[0]), kwargs
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
    # With rendering, each run renders one frame of world 0 after its timed
    # replay (the JAX package's run_simulation), returned beside the columns.
    with contextlib.redirect_stdout(io.StringIO()):
        cols = benchmark.run_benchmark(1, 2, 2, enable_rendering=True, **TINY)
    assert sorted(cols) == ["frames", "n_worlds", "realtime_factor", "steps_per_second",
                            "walltime_s"]
    assert [len(f) for f in cols["frames"]] == [1, 1]
    assert all(f[0].shape == (1, 240, 320, 3) and f[0].dtype == torch.uint8
               for f in cols["frames"])


def test_run_simulation_times_a_second_replay(monkeypatch):
    """bench.py's protocol: settle, one untimed replay, a timed replay from
    its end state, so the simulation has stepped settle + 2 x n steps."""
    fly, world, _cam = benchmark.make_model()
    world.compile()
    compiled = world.compiled
    targets = benchmark.ReplayTargetData(1e-4, benchmark._position_dofs(compiled)) \
        .make_target_angles_all_worlds(2, 8)
    by_dofs = benchmark.ReplayTargetData(1e-4, fly.get_actuated_jointdofs_order("position"))
    np.testing.assert_array_equal(by_dofs.make_target_angles_all_worlds(2, 8), targets)
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
