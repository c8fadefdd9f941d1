"""The port's spans and counters (``flygym_tpu_torch/utils/profiling.py``):
totals and self time, what a span keeps with and without a profiler
recording, its place in the chrome trace, the counted synchronisations,
the counters, the trace's digest, and the benchmark's five readers of the
recorder on small CPU runs of their cells. One card test holds the counted
synchronisations against the trace's ``cudaStreamSynchronize`` calls."""

import json
import time
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flygym_tpu_torch.compose.bridge import BENCHMARK_FLY, ENV_FLY, load_compiled
from flygym_tpu_torch.ops import ldl, megastep, retina
from flygym_tpu_torch.utils import profiling
from flygym_tpu_torch.utils.profiling import count, counters, report, reset_spans, span, spans
from portbench.harness import Reading
from portbench.registry import Benchmark

SYNC = "called a synchronizing CUDA operation"
READERS = ("host_syncs_per_env_step.env", "post_physics_ms.env", "chunk_host_ms.replay",
           "setup_kernels_s", "setup_load_s")


@pytest.fixture(autouse=True)
def fresh():
    reset_spans()
    yield
    reset_spans()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


class FakeEvent:
    """A CUDA event on the host's clock: ``record``, ``query``,
    ``elapsed_time`` (ms)."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def query(self):
        return self.t is not None

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.fixture
def fake_card(monkeypatch):
    """CUDA initialised as far as the recorder asks: host-clock events and
    a sync debug mode that records what it was set to. Applied on call, so
    that the profiler starts without it."""
    modes = [0]

    def apply():
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
        monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
        monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                            lambda m: modes.append({"warn": 1}.get(m, m)))
        return modes

    yield apply
    monkeypatch.undo()


def test_nesting_self_time_and_totals():
    @span("flygym.test.leaf")
    def leaf():
        time.sleep(0.002)

    for _ in range(3):
        with span("flygym.test.outer"):
            time.sleep(0.001)
            leaf()
            leaf()
    with pytest.raises(ValueError):
        with span("flygym.test.outer"):
            raise ValueError("propagates")
    s = spans()
    outer, inner = s["flygym.test.outer"], s["flygym.test.leaf"]
    assert outer["calls"] == 4 and inner["calls"] == 6
    assert inner["self_ns"] == inner["host_ns"] >= 6 * 2e6
    assert outer["host_ns"] > inner["host_ns"]
    assert outer["self_ns"] == pytest.approx(outer["host_ns"] - inner["host_ns"], abs=1e5)
    assert outer["recorded"] == [] and inner["recorded"] == []
    assert profiling._local.stack == []
    table = report()
    assert "flygym.test.outer" in table and "flygym.test.leaf" in table
    reset_spans()
    assert spans() == {}


def test_off_enters_no_record_function_and_keeps_no_occurrence(monkeypatch):
    def refuse(_name):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with span("flygym.test.a"):
        with span("flygym.test.b"):
            pass
    assert profiling._recorded == []
    assert all(v["recorded"] == [] for v in spans().values())


def test_recorded_spans_are_user_annotations_with_their_parents(tmp_path):
    with _cpu_profile() as prof:
        for i in range(2):
            with span("flygym.test.step"):
                with span("flygym.test.physics"):
                    torch.ones(8) @ torch.ones(8)
                with span("flygym.test.observe"):
                    with span("flygym.test.odor", 7):
                        torch.ones(4) + 1
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith("flygym.test.")]
    assert all(e["cat"] == "user_annotation" for e in events)
    assert len(events) == 8

    def parent(e):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        around = [a for a in events if a is not e and a["ts"] <= lo and hi <= a["ts"] + a["dur"]]
        return max(around, key=lambda a: a["ts"])["name"] if around else None

    want = {"flygym.test.step": None, "flygym.test.physics": "flygym.test.step",
            "flygym.test.observe": "flygym.test.step", "flygym.test.odor": "flygym.test.observe"}
    assert all(parent(e) == want[e["name"]] for e in events)
    s = spans()
    for name, p in want.items():
        occ = s[name]["recorded"]
        assert len(occ) == 2
        assert all((o.parent.name if o.parent else None) == p for o in occ)
        assert all(o.host_ms >= 0 and o.start_event is None and o.device_ms() is None
                   for o in occ)
    assert [o.id for o in s["flygym.test.step"]["recorded"]] == [0, 1]
    assert [o.id for o in s["flygym.test.physics"]["recorded"]] == [0, 1]
    assert [o.id for o in s["flygym.test.odor"]["recorded"]] == [7, 7]


def test_every_sync_warning_is_counted_in_the_innermost_span(fake_card):
    def sync():
        warnings.warn(SYNC)  # one call site, warned each time

    with _cpu_profile():
        modes = fake_card()
        with warnings.catch_warnings(record=True) as shown:
            warnings.simplefilter("default")
            with span("flygym.test.step"):
                sync()
                with span("flygym.test.observe"):
                    for _ in range(3):
                        sync()
                    warnings.warn("another warning")
                assert modes[-1] == 1
            sync()  # outside every span: not counted
        assert modes[-1] == 0
    s = spans()
    assert s["flygym.test.step"]["recorded"][0].syncs == 1
    assert s["flygym.test.observe"]["recorded"][0].syncs == 3
    assert s["flygym.test.step"]["syncs"] == 1 and s["flygym.test.observe"]["syncs"] == 3
    assert [str(w.message) for w in shown] == ["another warning", SYNC]


def test_the_launch_counters_and_counts_are_in_counters():
    megastep.reset_launches()
    retina.reset_launches()
    ldl.reset_launches()
    megastep.launches["megastep"] += 3
    retina.launches["retina"] += 2
    ldl.launches["tree_ldl_solve"] += 1
    count("kernel_builds.test")
    count("kernel_builds.test", 2)
    c = counters()
    assert c["launches.megastep"] == 3 and c["launches.retina"] == 2
    assert c["launches.tree_ldl_solve"] == 1 and c["launches.tree_ldl_factor"] == 0
    assert c["kernel_builds.test"] >= 3
    megastep.reset_launches()
    retina.reset_launches()
    ldl.reset_launches()
    assert counters()["launches.megastep"] == 0


def test_summarize_trace_clips_to_the_block_and_counts_overlaps_once(tmp_path, capsys):
    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    events = [
        x("flygym.trace", "user_annotation", 100, 1000),
        x("flygym.env.step", "user_annotation", 120, 480),
        x("flygym.env.advance", "user_annotation", 130, 320),
        x("flygym.env.step", "user_annotation", 600, 450),
        x("flygym.odor.sample", "user_annotation", 700, 100),
        x("aten::add", "cpu_op", 710, 20),
        x("cudaStreamSynchronize", "cuda_runtime", 720, 60),
        x("k_before", "kernel", 0, 50),  # before the block
        x("k2", "kernel", 150, 250),
        x("k2", "kernel", 300, 200),  # overlaps the one before
        x("blur", "kernel", 1000, 200),  # runs past the block's end
        x("flygym.env.step", "gpu_user_annotation", 150, 350),
    ]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events}))
    d = profiling.summarize_trace(str(tmp_path))
    assert set(d) == {"span_ms", "device_busy_ms", "device_busy_frac", "device_events",
                      "host_event_ms", "top_device_ops", "idle_gaps", "report"}
    assert d["span_ms"] == pytest.approx(1.0)
    assert d["device_busy_ms"] == pytest.approx(0.45)  # 150-500 and 1000-1100
    assert d["device_busy_frac"] == pytest.approx(0.45)
    assert d["device_events"] == 3
    assert d["host_event_ms"] == pytest.approx(0.93)  # 120-600 and 600-1050
    assert d["top_device_ops"][0][0] == "k2"
    assert d["top_device_ops"][0][1:] == pytest.approx((0.35, 100 * 0.35 / 0.45))
    assert [n for n, _ms in d["idle_gaps"]] == ["flygym.odor.sample", "flygym.env.step"]
    assert [ms for _n, ms in d["idle_gaps"]] == pytest.approx([0.5, 0.05])
    assert "idle gap in" in capsys.readouterr().out


def _reading(work):
    return Reading(None, work, None, None, None)


def _read(work) -> dict:
    bench = Benchmark()
    return {name: bench.reader(name).read(_reading(work)) for name in READERS}


@pytest.fixture(scope="module")
def env():
    from flygym_tpu_torch.env.gym import VectorFlyEnv
    from flygym_tpu_torch.olfaction import OdorField

    compiled = load_compiled(ENV_FLY)
    env = VectorFlyEnv(compiled, device="cpu", megastep=False, decision_interval=2,
                       enable_vision=True, odor_field=OdorField.for_compiled(compiled))
    env.action = {"joints": env._state0.ctrl[:, env._act_ids].expand(2, -1),
                  "adhesion": torch.ones(2, 6)}
    return env


def _episode(env, steps: int) -> None:
    states = env.reset_batched(torch.Generator().manual_seed(0), 2)
    for _ in range(steps):
        states = env.make_batched_step()(states, env.action)[0]


def test_env_readers_on_a_small_traced_run(env):
    load_compiled(ENV_FLY)  # set-up: a span of its own
    with _cpu_profile():
        _episode(env, 2)
    got = _read({"env_steps": 2})
    assert got["host_syncs_per_env_step.env"] == 0.0
    assert got["post_physics_ms.env"] is None  # no card: no events
    assert got["chunk_host_ms.replay"] is None
    assert got["setup_kernels_s"] == 0.0 and got["setup_load_s"] > 0.0
    s = spans()
    assert [o.id for o in s["flygym.env.step"]["recorded"]] == [0, 1]
    for name in ("flygym.env.advance", "flygym.env.reward_done", "flygym.env.observe_body",
                 "flygym.vision.render"):
        assert [(o.parent.name, o.id) for o in s[name]["recorded"]] == \
            [("flygym.env.step", 0), ("flygym.env.step", 1)]
    for name, parent in (("flygym.odor.sample", "flygym.env.observe_body"),
                         ("flygym.retina.pack_rows", "flygym.vision.render"),
                         ("flygym.retina.launch", "flygym.vision.render"),
                         ("flygym.vision.blur", "flygym.vision.render")):
        assert {o.parent.name for o in s[name]["recorded"]} == {parent}
    assert s["flygym.env.reset"]["recorded"][0].parent is None


def test_post_physics_reads_the_stream_after_the_physics(env, fake_card):
    with _cpu_profile():
        fake_card()
        _episode(env, 2)
    s = spans()
    after = []
    for step, adv in zip(s["flygym.env.step"]["recorded"], s["flygym.env.advance"]["recorded"]):
        assert adv.parent is step
        after.append(adv.end_event.elapsed_time(step.end_event))
    ms = _read({"env_steps": 2})["post_physics_ms.env"]
    assert len(after) == 2 and ms == pytest.approx(sum(after) / 2) and ms > 0.0


def test_replay_reader_on_a_small_traced_run():
    from flygym_tpu_torch import BatchSimulation
    from flygym_tpu_torch.demo.benchmark import replay_episode

    sim = BatchSimulation(load_compiled(BENCHMARK_FLY), 2, device="cpu", megastep=False)
    act_ids = sim.actuator_ids(sim.compiled.fly_names[0], "position")
    targets = sim.state.ctrl[:, act_ids][:, None].expand(2, 2, -1)
    with _cpu_profile():
        replay_episode(sim, sim.shards, targets, act_ids, 2)
    got = _read({"chunks": 2})
    assert got["chunk_host_ms.replay"] > 0.0 and got["host_syncs_per_env_step.env"] is None
    assert [o.id for o in spans()["flygym.replay.chunk"]["recorded"]] == [0, 1]
    assert got["setup_kernels_s"] == 0.0 and got["setup_load_s"] > 0.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_counted_syncs_are_the_traces_stream_synchronisations(card, tmp_path):
    """At 64 envs on the card, the syncs the recorder counts in the env
    steps are the ``cudaStreamSynchronize`` calls the trace holds under
    ``flygym.env.step``."""
    from flygym_tpu_torch.env.gym import VectorFlyEnv
    from flygym_tpu_torch.olfaction import OdorField

    compiled = load_compiled(ENV_FLY)
    env = VectorFlyEnv(compiled, decision_interval=20, enable_vision=True,
                       odor_field=OdorField.for_compiled(compiled))
    n, steps = 64, 4
    action = {"joints": env._state0.ctrl[:, env._act_ids].expand(n, -1).clone(),
              "adhesion": torch.ones(n, 6, device="cuda")}
    states = env.reset_batched(None, n)
    states = env.step(states, action)[0]  # builds and loads the kernels
    torch.cuda.synchronize()
    reset_spans()
    with profiling.trace(str(tmp_path), summarize=False):
        for _ in range(steps):
            states = env.step(states, action)[0]
        torch.cuda.synchronize()
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
              if e.get("ph") == "X"]
    windows = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "user_annotation" and e["name"] == "flygym.env.step"]
    traced = sum(1 for e in events if e.get("name") == "cudaStreamSynchronize"
                 and any(lo <= e["ts"] <= hi for lo, hi in windows))
    s = spans()
    counted = sum(o.syncs for v in s.values() for o in v["recorded"]
                  if o.name != "flygym.trace")
    assert len(windows) == steps and counted > 0
    assert counted == traced, report()
    ms = Benchmark().reader("post_physics_ms.env").read(_reading({"env_steps": steps}))
    assert ms is not None and ms > 0.0
