"""Examples 01, 02 and 03 in torch against what the JAX examples print.

The JAX examples (``examples/01_build_a_fly.py``,
``02_replay_recorded_walking.py``, ``03_batched_simulation.py``) ran on the
CPU once, 02 and 03 at the reduced sizes of
``tests/examples/test_examples_smoke.py``, and
``scripts/export_examples_golden.py`` kept what they print and the state
behind it in ``flygym_tpu_torch/assets/examples_basic_golden.npz``. The
port's examples (``flygym_tpu_torch/demo/build_a_fly.py``,
``replay_recorded_walking.py``, ``batched_simulation.py``) run here on the
CPU, the engine step, at the same sizes. The state after contacts is held
within the engine golden's bar (``GOLDEN_TOLERANCE``: the jitted JAX engine
fuses multiply-adds the eager port does not); the rest is equal.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from flygym_tpu_torch import assets_dir
from flygym_tpu_torch.demo import batched_simulation, build_a_fly, replay_recorded_walking
from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE

torch.set_num_threads(1)

GOLDEN = assets_dir / "examples_basic_golden.npz"


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN, allow_pickle=False) as g:
        return {k: g[k] for k in g.files}


def _run(fn, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        r = fn(**kwargs)
    return r, out.getvalue().splitlines()


def _line(lines, start: str) -> str:
    (line,) = [x for x in lines if x.startswith(start)]
    return line


def test_build_a_fly_prints_the_jax_example(golden, tmp_path):
    """Example 01 at its own size: the sizes, the mass and the first DoFs
    printed as the JAX example prints them, its MJCF equal to the JAX
    example's as a string, and the same legs in contact after the settle."""
    r, lines = _run(build_a_fly.main, device="cpu", out=tmp_path / "fly.xml")
    want = str(golden["ex01.stdout"]).splitlines()
    for start in ("bodies:", "total mass:", "first joint DoFs:",
                  "legs in ground contact after settling:"):
        assert _line(lines, start) == _line(want, start)
    assert (tmp_path / "fly.xml").read_text() == str(golden["ex01.mjcf"])
    assert abs(r["mass"] - float(golden["ex01.mass"])) <= 1e-6 * float(golden["ex01.mass"])
    assert np.array_equal(r["found"], golden["ex01.found"])
    assert not r["sim"].megastep


def test_replay_recorded_walking_tracks_the_jax_example(golden):
    """Example 02 reduced (100 settle and 100 replay steps, no render): the
    lines it prints equal the JAX example's, and the root's unrounded start
    and end within the engine golden's qpos bar."""
    r, lines = _run(replay_recorded_walking.main, n_steps=100, settle_steps=100, render=False,
                    device="cpu")
    want = str(golden["ex02.stdout"]).splitlines()
    assert lines == want
    assert r["n_steps"] == 100 and tuple(r["traj"].shape) == (100, 73)
    for key in ("start", "end"):
        gap = np.abs(r[key] - golden[f"ex02.{key}"]).max()
        assert gap <= GOLDEN_TOLERANCE["qpos"], (key, gap)


def test_batched_simulation_tracks_the_jax_example(golden, tmp_path):
    """Example 03 reduced (8 worlds, the 500-step settle, two 50-step
    replays): the same worlds and steps printed, every world's final qpos
    within the engine golden's qpos bar of the JAX example's, and the
    montage written. The JAX example names 16 worlds in its montage line
    at any width (its gather clips the ids past the batch); the port's
    montage holds the batch's worlds up to 16."""
    r, lines = _run(batched_simulation.main, n_worlds=8, n_steps=50, device="cpu",
                    out=tmp_path / "montage.png")
    want = str(golden["ex03.stdout"]).splitlines()
    head = re.compile(r"^(\d+) worlds x (\d+) steps in")
    assert head.match(lines[0]).groups() == head.match(want[0]).groups() == ("8", "50")
    assert lines[1] == f"8-world montage -> {tmp_path / 'montage.png'}"
    gap = np.abs(r["qpos"] - golden["ex03.qpos"]).max()
    assert gap <= GOLDEN_TOLERANCE["qpos"], gap
    assert r["montage"].shape == (3 * 120, 3 * 160, 3)  # 8 tiles in a 3 x 3 grid
    assert r["montage"].std() > 0 and (tmp_path / "montage.png").stat().st_size > 0
