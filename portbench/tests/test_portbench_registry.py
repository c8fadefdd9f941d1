"""Every entry of BENCHMARK.json resolves to its files, keeps the contract's
shape, and a new configuration, traffic driver and metric are found by name as new
files, with no edit."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench.registry import Benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = Benchmark()
SPEC = BENCH.spec


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"][:3] == ["python3", "-m", "portbench.run"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_resolves(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and entry["file"].startswith("portbench/")
    cfg = BENCH.config(entry["name"])
    assert cfg["name"] == entry["name"]
    for key in ("world", "clip"):
        if key in cfg:
            assert (Path(cfg["dir"]) / cfg[key]).is_file()
    assert cfg["counts"]["k2_ops_per_world_step"] > 0
    assert entry["reduced"] == cfg["reduced"]


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and 0 < len(cell["why"]) <= 200
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert any(c["name"] == cell["config"] for c in SPEC["configs"])
    mix = BENCH.traffic(cell["traffic"])
    assert callable(BENCH.driver(mix["driver"]).setup)
    names = [m["name"] for m in BENCH.end_to_end(cell["name"])]
    assert "setup_s" in names and len(names) >= 2
    assert BENCH.per_layer(cell["name"])


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_shape(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves",
                               "workloads"}
        assert any(e["name"] == metric["moves"] for e in SPEC["end_to_end"])
        assert callable(BENCH.reader(metric["name"]).read)
        if metric["unit"] == "%" and ("roofline" in metric["name"] or "mfu" in metric["name"]):
            assert metric["better"] == "higher"


DUMMY_DRIVER = '''
import contextlib
from portbench.digest import WINDOW


class Run:
    def __init__(self, mix):
        self.mix = mix

    def window(self, seconds, span):
        with span(WINDOW):
            pass
        return {"seconds": 2.0, "attempted": 4, "items": 8}

    def end_to_end(self, w):
        return {"items_per_s": w["items"] / w["seconds"]}

    def free(self):
        pass

    def check(self, control=None):
        return [("answer", 0.0 if control is None else 1.0, self.mix["limit"])]


def setup(config, mix, seed, device):
    return Run(mix)
'''


def test_new_files_are_found_with_no_edit(tmp_path):
    """A configuration, a mix with its traffic driver, a cell and two metrics added
    as files and entries only: a run finds them all."""
    from portbench.harness import execute

    pkg = tmp_path / "portbench"
    shutil.copytree(BENCH.package, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "configs" / "dummy.json").write_text(json.dumps(
        {"name": "dummy", "reduced": [], "counts": {"k2_ops_per_world_step": 1}}))
    (pkg / "traffic" / "dummy-mix.json").write_text(json.dumps(
        {"driver": "dummy", "limit": 0.0}))
    (pkg / "traffic" / "dummy.py").write_text(DUMMY_DRIVER)
    (pkg / "metrics" / "items_per_attempt.py").write_text(
        "def read(r):\n    return r.work['items'] / r.work['attempted']\n")
    (pkg / "metrics" / "nothing_to_read.py").write_text("def read(r):\n    return None\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "dummy", "source": "test", "reduced": [], "why": "test",
                            "file": "portbench/configs/dummy.json"})
    spec["workloads"].append({"name": "dummy-cell", "config": "dummy", "traffic": "dummy-mix",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].insert(0, {"name": "items_per_s", "unit": "items/s", "better": "higher",
                                  "bound": 0.05, "source": "host_clock",
                                  "workloads": ["dummy-cell"]})
    for name in ("items_per_attempt", "nothing_to_read"):
        spec["per_layer"].append({"name": name, "unit": "1", "better": "higher",
                                  "source": "program_counter", "layer": "test",
                                  "moves": "items_per_s", "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Benchmark(tmp_path, pkg)
    cell = bench.cell("dummy-cell")
    plain = execute(bench, cell, 1, 0.0, False, "cpu", since_start=lambda: 3.0,
                    log=lambda _m: None)
    assert plain["correct"] and plain["metrics"] == {
        "items_per_s": {"value": 4.0, "unit": "items/s"}, "setup_s": {"value": 3.0, "unit": "s"}}
    assert list(plain)[-1] == "checks" and plain["checks"]["answer"] == {"value": 0.0,
                                                                        "limit": 0.0}
    traced = execute(bench, cell, 1, 0.0, True, "cpu", log=lambda _m: None)
    assert traced["metrics"] == {"items_per_attempt": {"value": 2.0, "unit": "1"}}
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    from portbench.control import readings

    ctl = readings(bench, cell, 1, 0.0, "cpu", ["bfloat16"])
    assert ctl["sound"]["correct"] and not ctl["bfloat16"]["correct"]
