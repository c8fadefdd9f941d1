"""The metric arithmetic on synthetic traces and event lists: the union of
busy intervals, idle inside the window, the idle gaps' labels, the p95 over
every step, rates over the whole window, and the roofline shares."""

import json
import math
import statistics
from types import SimpleNamespace

import pytest

from portbench.digest import WINDOW, digest_events, digest_file, union
from portbench.readings import k2_launch, kernel, roofline
from portbench.traffic.env import EnvRun, p95
from portbench.traffic.replay import ReplayRun


def ev(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def trace():
    """A window of 100 us (10 to 110) with kernels overlapping on two
    streams, one straddling each edge, and host events under the gaps."""
    return [
        ev(WINDOW, 10.0, 100.0, "user_annotation"),
        ev("portbench.env.step", 12.0, 60.0, "user_annotation"),
        ev("aten::copy_", 25.0, 15.0, "cpu_op"),
        ev("cudaMemcpyAsync", 28.0, 8.0, "cuda_runtime"),
        ev("(anonymous namespace)::megastep_kernel(float const*, int)", 0.0, 20.0, "kernel"),
        ev("(anonymous namespace)::megastep_kernel(float const*, int)", 40.0, 30.0, "kernel"),
        ev("void (anonymous namespace)::retina_kernel<true>(float const*)", 50.0, 30.0,
           "kernel"),
        ev("Memcpy HtoD (Pageable -> Device)", 100.0, 20.0, "gpu_memcpy"),
        ev("aten::mul", 82.0, 2.0, "cpu_op"),
        ev("outside", 200.0, 5.0, "kernel"),
    ]


def test_union_merges_overlaps():
    assert union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]
    assert union([]) == []


def test_busy_is_the_union_inside_the_window():
    d = digest_events(trace())
    # Busy: [10, 20] + [40, 80] + [100, 110] = 60 us of a 100 us window.
    assert d["window_s"] == pytest.approx(100e-6)
    assert d["busy_s"] == pytest.approx(60e-6)
    assert d["device_ops"] == 4  # the event past the window is not counted
    assert d["op_seconds"]["Memcpy HtoD (Pageable -> Device)"] == pytest.approx(10e-6)
    assert d["op_counts"]["(anonymous namespace)::megastep_kernel(float const*, int)"] == 2


def test_idle_gaps_are_labelled_by_the_host():
    gaps = digest_events(trace())["breakdown"]["idle_gaps"]
    # [20, 40]: under the copy (innermost: its runtime call) in the step
    # span; [80, 100]: under no host event, the last one before it aten::mul.
    assert gaps[0] == ["cudaMemcpyAsync in portbench.env.step", pytest.approx(20e-6)]
    assert gaps[1][0] == "after aten::mul"
    assert len(gaps) == 2


def test_top_device_ops_by_time():
    top = digest_events(trace())["breakdown"]["device_ops"]
    assert top[0][0].startswith("(anonymous namespace)::megastep_kernel")
    assert top[0][1] == pytest.approx(40e-6)


def test_file_round_trip(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": trace()}))
    assert digest_file(str(path))["busy_s"] == pytest.approx(60e-6)


def test_no_window_span_raises():
    with pytest.raises(ValueError):
        digest_events(trace()[1:])


def test_p95_is_over_every_step():
    steps = [20.0] * 95 + [30.0] * 5
    assert p95(steps) == statistics.quantiles(steps, n=20)[18]
    assert 20.0 < p95(steps + [40.0] * 5) <= 40.0


def test_rates_are_over_the_whole_window():
    replay = SimpleNamespace(n=4096)
    w = {"world_steps": 3 * 1000 * 4096, "seconds": 5.25}
    assert ReplayRun.end_to_end(replay, w)["world_steps_per_s"] == pytest.approx(
        3 * 1000 * 4096 / 5.25)
    env = SimpleNamespace(n=4096, _ms=EnvRun._ms)
    marks = [(0.0, 0.02), (0.02, 0.041), (0.041, 0.06)]
    out = EnvRun.end_to_end(env, {"env_steps": 3, "seconds": 0.08, "marks": marks})
    assert out["env_steps_per_s"] == pytest.approx(3 * 4096 / 0.08)
    assert out["env_step_ms_p95"] == pytest.approx(p95([20.0, 21.0, 19.0]))


def test_roofline_share_of_a_kernel():
    d = digest_events(trace())
    r = SimpleNamespace(digest=d, config={"counts": {
        "k2_ops_per_world_step": 1000,
        "dims": {"nq": 7, "nv": 6, "nu": 2, "na": 0, "nbody": 2, "nsite": 0, "nsensor": 1}}})
    seconds, launches = kernel(r, "megastep_kernel")
    assert (seconds, launches) == (pytest.approx(40e-6), 2)
    assert kernel(r, "retina_kernel")[1] == 1 and kernel(r, "megastep")[1] == 0
    bound, which = k2_launch(r, worlds=10, k_steps=2)
    n_bytes = 4 * 10 * ((7 + 6 + 2 * 2 + 0 + 6) + (2 * 7 + 2 * 6 + 0 + 14 + 0 + 2 + 16))
    assert bound == pytest.approx(max(1000 * 2 * 10 / 67e12, n_bytes / 3.35e12))
    assert which == "bytes"
    assert roofline(bound, launches, seconds) == pytest.approx(100 * bound * 2 / 40e-6)
    assert roofline(bound, 0, 0.0) is None
    assert math.isfinite(roofline(bound, launches, seconds))
