"""The single-world API of the port against the JAX package: ``step()``,
``warmup()``, the profiling counters and reports, checkpoints, and the
engine's one-world ``make_step_fn`` / ``rollout``.

The benchmark fly is the exported one (``flygym_tpu_torch/assets``); the
JAX side compiles the same world once (``flygym_tpu/demo/benchmark.py:
make_model``). Inputs are seeded with numpy and handed to both packages.
"""

import contextlib
import dataclasses
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flygym_tpu
from flygym_tpu.demo.benchmark import make_model as jax_make_model
from flygym_tpu.engine.model import State as JaxState
from flygym_tpu.engine.step import rollout as jax_rollout
from flygym_tpu.utils import checkpoint as jax_checkpoint
from flygym_tpu.utils import profiling as jax_profiling

from flygym_tpu_torch import BatchSimulation, Simulation, load_compiled
from flygym_tpu_torch.compose.bridge import load_golden
from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE
from flygym_tpu_torch.engine.step import make_step_fn, rollout
from flygym_tpu_torch.utils import checkpoint, profiling

torch.set_num_threads(1)

FIELDS = ("qpos", "qvel", "ctrl", "act", "time", "qacc", "xpos", "xquat", "site_xpos",
          "actuator_force", "contact_sensordata")
NUMBER = re.compile(r"-?\d+(?:\.\d+)?|nan|inf")


@pytest.fixture(scope="module")
def compiled():
    return load_compiled()


@pytest.fixture(scope="module")
def golden():
    return load_golden()


@pytest.fixture(scope="module")
def jax_sim():
    _fly, world, _cam = jax_make_model()
    return flygym_tpu.Simulation(world)


def _same(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


def _numbers(fn, **kwargs) -> list:
    """The numbers a report prints, in order (layout and whitespace aside)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(**kwargs)
    return NUMBER.findall(out.getvalue())


def test_step_tracks_the_jax_engine_golden(compiled, golden):
    """``Simulation.step()`` on the CPU (the engine step, as JAX's
    ``Simulation.step``) from world 0 of the golden's settled state, with
    the golden's per-step targets, against the JAX engine trajectory."""
    sim = Simulation(compiled, device="cpu")
    assert not sim.megastep
    sim.state = golden["state"].map(lambda x: x[:1].clone())
    fly = compiled.fly_names[0]
    targets = golden["targets"][0]
    for i in range(targets.shape[0]):
        sim.set_actuator_inputs(fly, "position", targets[i])
        sim.step()
        assert np.abs(sim.state.qpos[0].numpy() - golden["qpos"][i, 0]).max() <= \
            GOLDEN_TOLERANCE["qpos"], i
        assert np.abs(sim.state.qvel[0].numpy() - golden["qvel"][i, 0]).max() <= \
            GOLDEN_TOLERANCE["qvel"], i
    # float32 time, 50 roundings of t + dt
    assert abs(sim.time - (float(golden["state"].time[0]) + targets.shape[0] * 1e-4)) < 1e-5


@pytest.mark.parametrize("megastep", [False, True], ids=["engine", "plain_megastep"])
def test_steps_equal_a_rollout(compiled, golden, megastep):
    """n ``step()`` calls and ``rollout(None, n)`` give the same state to the
    last bit, through either step."""
    n = 2 if megastep else 5
    a = Simulation(compiled, device="cpu", megastep=megastep, megastep_k=1)
    b = Simulation(compiled, device="cpu", megastep=megastep, megastep_k=1)
    a.state = b.state = golden["state"].map(lambda x: x[:1].clone())
    for _ in range(n):
        a.step()
    b.rollout(None, n, record_trajectory=False)
    assert _same(a.state, b.state)


def test_engine_rollout_matches_jax(compiled, jax_sim):
    """``make_step_fn`` and the one-world ``rollout`` against JAX's
    ``engine/step.py:rollout`` from the exported initial state, 3 steps with
    seeded targets and NaN (keep) slots, within the bars of one engine step
    against the jitted JAX step (``tests/test_torch_engine.py:282-283``:
    qpos 1e-6 + 2e-4 dt, qvel 1e-3; the jitted step fuses multiply-adds, the
    port rounds each product) summed over the steps."""
    rng = np.random.default_rng(0)
    n_steps, nu = 3, compiled.model.nu
    ctrl = (np.asarray(compiled.initial_state.ctrl[0])
            + rng.uniform(-0.2, 0.2, (n_steps, nu))).astype(np.float32)
    ctrl[1, rng.choice(nu, 10, replace=False)] = np.nan
    want_final, want_traj = jax_rollout(jax_sim.model, jax_sim._initial_state,
                                        jnp.asarray(ctrl), n_steps)
    final, traj = rollout(compiled.model, compiled.initial_state, torch.from_numpy(ctrl), n_steps)
    assert traj.shape == (n_steps, compiled.model.nq)
    dt = compiled.model.timestep
    np.testing.assert_allclose(traj.numpy(), np.asarray(want_traj), rtol=0,
                               atol=n_steps * (1e-6 + 2e-4 * dt))
    np.testing.assert_allclose(final.qvel[0].numpy(), np.asarray(want_final.qvel), rtol=0,
                               atol=n_steps * 1e-3)
    np.testing.assert_array_equal(final.ctrl[0].numpy(), np.asarray(want_final.ctrl))
    # The step closure is the engine step; the rollout is its loop.
    step_fn = make_step_fn(compiled.model)
    state = compiled.initial_state
    for t in range(n_steps):
        keep = np.isnan(ctrl[t])
        c = torch.where(torch.from_numpy(keep), state.ctrl[0], torch.from_numpy(ctrl[t]))
        state = step_fn(dataclasses.replace(state, ctrl=c[None]))
        assert torch.equal(state.qpos[0], traj[t])
    assert _same(state, final)
    held, none = rollout(compiled.model, compiled.initial_state, None, 2, record=False)
    assert none is None and torch.equal(held.ctrl, compiled.initial_state.ctrl)
    with pytest.raises(ValueError, match="one world"):
        rollout(compiled.model, compiled.initial_state.map(lambda x: x.expand(2, *x.shape[1:])),
                None, 1)


@pytest.mark.parametrize("duration", [0.05, 0.03, 0.15])
def test_warmup_steps_as_jax(compiled, jax_sim, duration, monkeypatch):
    """``warmup`` runs ``int(duration / timestep)`` steps in one rollout
    without trajectory, as JAX's does (500, 300 and 1499 steps), and leaves
    them out of the report's count."""
    calls = {"jax": [], "port": []}

    def recorder(key, sim):
        def fake(ctrl, n_steps, *, record_trajectory=True):
            calls[key].append((ctrl, n_steps, record_trajectory))
            sim._curr_step += n_steps
        return fake

    sim = Simulation(compiled, device="cpu")
    monkeypatch.setattr(jax_sim, "rollout", recorder("jax", jax_sim))
    monkeypatch.setattr(sim, "rollout", recorder("port", sim))
    jax_sim.warmup(duration)
    sim.warmup(duration)
    assert calls["port"] == calls["jax"]
    assert calls["port"][0][1] == {0.05: 500, 0.03: 300, 0.15: 1499}[duration]
    assert sim._curr_step == jax_sim._curr_step == 0
    assert sim.timestep == jax_sim.timestep


def test_counters_and_report_match_jax(compiled):
    """``step_with_profile`` counts steps and time, ``warmup`` does not, the
    report's rows hold the numbers of JAX's ``print_perf_report`` for the
    same counters, and ``reset`` clears them."""
    sim = Simulation(compiled, device="cpu")
    sim.warmup(0.0003)
    for _ in range(2):
        sim.step_with_profile()
    sim.rollout(None, 1, record_trajectory=False)
    assert sim._curr_step == 3 and sim._total_physics_time_ns > 0
    assert sim._frames_rendered == 0 and sim._total_render_time_ns == 0
    counters = dict(n_steps=sim._curr_step, n_frames_rendered=0,
                    total_physics_time_ns=sim._total_physics_time_ns, total_render_time_ns=0,
                    timestep=sim.timestep, show_in_notebook=False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        sim.print_performance_report(show_in_notebook=False)
    assert NUMBER.findall(out.getvalue()) == _numbers(jax_profiling.print_perf_report,
                                                      **counters)
    sim.reset()
    assert (sim._curr_step, sim._total_physics_time_ns) == (0, 0)
    with pytest.raises(ValueError, match="n_steps"):
        sim.print_performance_report(show_in_notebook=False)


@pytest.mark.parametrize("frames", [0, 7])
def test_reports_match_jax_for_the_same_inputs(frames):
    """Both reports, with and without rendered frames, print JAX's numbers."""
    args = dict(total_physics_time_ns=123_456_789, total_render_time_ns=23_456_789 if frames
                else 0, n_steps=1000, n_frames_rendered=frames, timestep=1e-4,
                show_in_notebook=False)
    assert _numbers(profiling.print_perf_report, **args) == \
        _numbers(jax_profiling.print_perf_report, **args)
    par = dict(args, n_worlds=4096, n_worlds_rendered=2 if frames else 0)
    assert _numbers(profiling.print_perf_report_parallel, **par) == \
        _numbers(jax_profiling.print_perf_report_parallel, **par)


def test_batch_report_is_the_parallel_one(compiled):
    sim = BatchSimulation(compiled, 2, device="cpu")
    sim.step_with_profile()
    counters = dict(n_steps=1, n_frames_rendered=0, total_physics_time_ns=sim._total_physics_time_ns,
                    total_render_time_ns=0, timestep=sim.timestep, n_worlds=2,
                    n_worlds_rendered=0, show_in_notebook=False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        sim.print_performance_report(show_in_notebook=False)
    assert NUMBER.findall(out.getvalue()) == _numbers(
        jax_profiling.print_perf_report_parallel, **counters)


def test_trace_digests_a_profile(tmp_path):
    """``trace`` writes a chrome trace under its logdir and ``summarize_trace``
    reads it back (host events only on the CPU: the card's busy share is 0)."""
    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path), summarize=False) as logdir:
        for _ in range(3):
            x = x @ x / 64.0
    digest = profiling.summarize_trace(logdir)
    assert (tmp_path / "trace.json").exists()
    assert digest["span_ms"] > 0 and digest["host_event_ms"] > 0
    assert digest["device_busy_ms"] == 0.0 and digest["top_device_ops"] == []
    assert profiling.summarize_trace(str(tmp_path / "empty")) is None


def _jax_state(golden, worlds):
    """The golden's settled worlds ``worlds`` (a slice, or one index for one
    world without a world axis) as a JAX State."""
    st = golden["state"]
    return JaxState(**{f: jnp.asarray(getattr(st, f)[worlds].numpy()) for f in FIELDS})


def test_checkpoints_load_across_packages(golden, tmp_path):
    """A file from JAX's ``save_state`` loads in the port and one from the
    port's loads in JAX's ``load_state``, every field equal; a port round
    trip is exact."""
    jax_checkpoint.save_state(_jax_state(golden, slice(0, 3)), tmp_path / "jax.npz")
    got = checkpoint.load_state(tmp_path / "jax.npz", device="cpu")
    state = golden["state"].map(lambda x: x[:3])
    for f in FIELDS:
        assert getattr(got, f).dtype == getattr(state, f).dtype, f
        assert torch.equal(getattr(got, f), getattr(state, f)), f
    checkpoint.save_state(state, tmp_path / "sub" / "port.npz")
    back = jax_checkpoint.load_state(tmp_path / "sub" / "port.npz")
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), getattr(state, f).numpy(),
                                      err_msg=f)
    assert _same(checkpoint.load_state(tmp_path / "sub" / "port.npz", device="cpu"), state)


def test_simulation_checkpoint_round_trip(compiled, golden, tmp_path):
    """``Simulation.save_state`` writes one world without a world axis, as
    the JAX ``Simulation`` does, and ``load_state`` restores it exactly (also
    JAX's file); a batch keeps its world axis; a file of another width
    raises."""
    sim = Simulation(compiled, device="cpu")
    sim.state = golden["state"].map(lambda x: x[1:2].clone())
    sim.save_state(tmp_path / "one.npz")
    assert jax_checkpoint.load_state(tmp_path / "one.npz").qpos.shape == (compiled.model.nq,)
    other = Simulation(compiled, device="cpu")
    other.load_state(tmp_path / "one.npz")
    assert _same(other.state, sim.state)
    sim.step()
    other.step()
    assert _same(other.state, sim.state)
    jax_checkpoint.save_state(_jax_state(golden, 1), tmp_path / "jax_one.npz")
    other.load_state(tmp_path / "jax_one.npz")
    assert _same(other.state, golden["state"].map(lambda x: x[1:2]))
    batch = BatchSimulation(compiled, 3, device="cpu")
    batch.state = golden["state"].map(lambda x: x[:3].clone())
    batch.save_state(tmp_path / "three.npz")
    again = BatchSimulation(compiled, 3, device="cpu")
    again.load_state(tmp_path / "three.npz")
    assert _same(again.state, batch.state)
    with pytest.raises(ValueError, match="does not fit"):
        BatchSimulation(compiled, 2, device="cpu").load_state(tmp_path / "three.npz")
