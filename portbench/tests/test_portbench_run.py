"""The command: without the cards a cell asks for it prints no result and
exits with another code than 0, here and in a directory that holds only
BENCHMARK.json and the benchmark's files; on a card (``-m cuda``) one
short run of each cell is correct."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.registry import PACKAGE, ROOT, Benchmark


def _command(cwd, *args):
    return subprocess.run([sys.executable, "-m", "portbench.run", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=600)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _command(ROOT, "--workload", "replay-4096", "--seed", "1", "--seconds", "1")
    assert out.returncode == 3 and out.stdout == ""


def test_only_the_benchmarks_files_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PACKAGE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path, "--workload", "replay-4096", "--seed", "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in Benchmark().spec["workloads"]])
def test_a_short_run_on_the_card_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _command(ROOT, "--workload", cell, "--seed", "2000000001", "--seconds", "2")
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
