"""Every step of a run but the look for a card, at the CPU size, with the
timed path broken underneath: ``correct`` comes out false for each fault a
cell can have, true for the sound program, and false for the controls (the
reference in bfloat16 in the program's place). The exchange between chips
is no fault these one-chip cells can have.

On the CPU the program's K2 and K3 run their plain versions
(``megastep_plain``, ``retina_plain``), which the faults replace."""

from dataclasses import fields, replace

import pytest
import torch

from portbench.registry import Benchmark
from portbench.tests.small import small_readings, small_run

BENCH = Benchmark()
CELLS = [c["name"] for c in BENCH.spec["workloads"]]


def _unchanged(real):
    """A step that returns its state unchanged."""
    def step(st, state, ctrl_seq=None, terrain_planes=None):
        if ctrl_seq is None:
            return state
        return replace(state, ctrl=ctrl_seq[-1]), state.qpos.expand(
            (len(ctrl_seq),) + state.qpos.shape).clone()
    return step


def _half(real):
    """Half of the batch left out: the second half's worlds not stepped."""
    def step(st, state, ctrl_seq=None, terrain_planes=None):
        out = real(st, state, ctrl_seq, terrain_planes)
        new = out if ctrl_seq is None else out[0]
        h = state.qpos.shape[0] // 2
        kept = type(new)(**{f.name: torch.cat([getattr(new, f.name)[:h],
                                               getattr(state, f.name)[h:]])
                            if f.name != "ctrl" else new.ctrl for f in fields(new)})
        return kept if ctrl_seq is None else (kept, out[1])
    return step


def _altered(real):
    """An answer altered where it is produced: one world's velocity, by one
    float32 step."""
    def step(st, state, ctrl_seq=None, terrain_planes=None):
        out = real(st, state, ctrl_seq, terrain_planes)
        new = out if ctrl_seq is None else out[0]
        qvel = new.qvel.clone()
        qvel[0, 0] = torch.nextafter(qvel[0, 0], qvel[0, 0] + 1.0)
        new = replace(new, qvel=qvel)
        return new if ctrl_seq is None else (new, out[1])
    return step


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = small_run(BENCH, cell)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch):
    from flygym_tpu_torch.ops import megastep

    monkeypatch.setattr(megastep, "megastep_plain", fault(megastep.megastep_plain))
    result = small_run(BENCH, cell)
    assert not result["correct"], result["checks"]


def test_an_altered_ray_is_not_correct(monkeypatch):
    from flygym_tpu_torch.ops import retina

    real = retina.retina_plain

    def altered(tables, packed):
        out = real(tables, packed).clone()
        out[0, 0, 0, :] += 1e-3  # both channels: the blur reads one of them
        return out

    monkeypatch.setattr(retina, "retina_plain", altered)
    result = small_run(BENCH, "env-vision-4096")
    assert not result["correct"] and result["checks"]["vision"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_bfloat16_control_is_not_correct(cell):
    out = small_readings(BENCH, cell, ["bfloat16"])
    assert out["sound"]["correct"], out["sound"]
    assert not out["bfloat16"]["correct"], out["bfloat16"]
