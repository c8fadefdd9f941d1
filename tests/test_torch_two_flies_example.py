"""Example 11 in torch (``flygym_tpu_torch/demo/two_flies.py``) against the
JAX example (``examples/11_two_flies_interacting.py``) on the CPU.

Both compose example 11's world, put adhesion on the bottom fly's legs and
drop the top fly; the port's ``main`` runs the engine step on the CPU, the
JAX example its scanned ``Simulation.rollout``. The stack is
ill-conditioned once the flies touch, so the port's root heights are held
to the JAX example's within the bar of a conditioning probe, as the goldens
hold the engine step (``scripts/export_twofly_golden.py``): 3 times the
spread of the JAX rollout from the start perturbed by 1e-5 (relative in
qpos, absolute in qvel), or ``PROBE_FLOOR``.

``main`` runs reduced (the top fly still falling, the bottom one landing)
on the JAX package's compile of the world (``twofly.npz``), and at the
example's 800 steps on the world it composes, where it makes the example's
check (the top root more than 0.4 mm above the bottom one); both write the
frame from ``bottom/trackcam`` as a PNG. The reduced run takes the file's
world because the port's compile parts from JAX's in the last bits of
``can_invweight`` (ROADMAP queue 3 item 7), which the bottom fly's landing
amplifies past the probe's bar at 100 steps (3.6e-4 mm against 9.3e-5 in
the bottom root's height; the file's world 4e-7).
"""

import dataclasses
import importlib.util
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu_torch.demo import two_flies

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
REDUCED_STEPS = 100
PROBE_EPS = 1e-5
PROBE_FLOOR = 3e-5  # qpos, tests/test_torch_pairs.py


@pytest.fixture(scope="module")
def jax_heights():
    """steps -> (JAX (z_bottom, z_top), probe bar) after REDUCED_STEPS and
    800 steps of the JAX example's rollout."""
    import jax.numpy as jnp

    import flygym_tpu

    spec = importlib.util.spec_from_file_location(
        "example_11", REPO / "examples" / "11_two_flies_interacting.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    sim = flygym_tpu.Simulation(example.make_two_fly_world())
    sim.set_leg_adhesion_states("bottom", np.ones(6, np.float32))
    start = sim.state
    rng = np.random.default_rng(1)
    noise_q = rng.standard_normal(start.qpos.shape).astype(np.float32)
    noise_v = rng.standard_normal(start.qvel.shape).astype(np.float32)
    probe = dataclasses.replace(start, qpos=start.qpos * (1.0 + PROBE_EPS * jnp.asarray(noise_q)),
                                qvel=start.qvel + PROBE_EPS * jnp.asarray(noise_v))
    adr = (2, sim.model.free_joints[1][1] + 2)
    out = {}
    for steps in (REDUCED_STEPS, two_flies.N_STEPS):
        z = {}
        for name, state in (("run", start), ("probe", probe)):
            sim.state = state
            sim.rollout(None, steps)
            z[name] = np.asarray(sim.state.qpos)[list(adr)]
        bar = max(3.0 * float(np.abs(z["probe"] - z["run"]).max()), PROBE_FLOOR)
        out[steps] = (z["run"], bar)
    return out


def _read_png(path: Path) -> np.ndarray:
    """An 8-bit RGB PNG of filter-0 rows (as ``write_png`` writes it)."""
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body)
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, color) == (8, 2)
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("steps", [REDUCED_STEPS, two_flies.N_STEPS])
def test_main_tracks_the_jax_example(jax_heights, steps, tmp_path, monkeypatch):
    """The port's ``main`` on the CPU: its printed root heights within the
    probe's bar of the JAX example's; at 800 steps (the world ``main``
    composes) the example's check holds (``main`` asserts it); the PNG
    decodes to the returned frame."""
    from flygym_tpu_torch import load_compiled
    from flygym_tpu_torch.compose.bridge import TWOFLY

    if steps == REDUCED_STEPS:  # the JAX package's compile of the same world
        monkeypatch.setattr(two_flies, "make_two_fly_world", lambda **_: load_compiled(TWOFLY))
    r = two_flies.main(0, device="cpu", n_steps=steps, out=tmp_path / "frame.png")
    assert not r["sim"].megastep
    want, bar = jax_heights[steps]
    got = np.array([r["z_bottom"], r["z_top"]])
    assert np.abs(got - want).max() <= bar, (got, want, bar)
    print(f"{steps} steps: |port - JAX| {np.abs(got - want).max():.3e} mm, the probe's bar "
          f"{bar:.3e} mm")
    if steps == two_flies.N_STEPS:
        assert r["z_top"] > r["z_bottom"] + two_flies.REST_GAP_MM
    frame = _read_png(r["path"])
    assert frame.shape == (240, 320, 3) and np.array_equal(frame, r["frame"])
    assert frame.std() > 0  # not a blank image


def test_write_png_round_trips(tmp_path):
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (7, 5, 3), dtype=np.uint8)
    assert np.array_equal(_read_png(two_flies.write_png(tmp_path / "x.png", frame)), frame)
    with pytest.raises(ValueError):
        two_flies.write_png(tmp_path / "y.png", frame[..., :2])
