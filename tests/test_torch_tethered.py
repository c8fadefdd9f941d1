"""The tethered motor fly, a world without contact candidates, against the
JAX package: the exported world, the engine step, the mega-step's plain
version (K2 slice g.1: qacc from the tree solve of Mh alone) and K2's host
build.

The world is ``tests/engine/test_actuators_golden.py:25-38``'s tethered
fly with 42 MOTOR actuators (forcerange (-5, 5)); ``scripts/
export_actuator_golden.py tethered_fly`` writes it and its golden (8 worlds
settled under seeded torques, then 50 steps under others, through the JAX
engine and the JAX emitter). The ``cuda`` test runs on the card::

    python -m pytest --noconftest tests/test_torch_tethered.py -m cuda
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu_torch import BatchSimulation, Simulation, load_compiled
from flygym_tpu_torch.compose.bridge import (
    TETHERED_FLY, TETHERED_GOLDEN, _read_npz, load_actuator_golden)
from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE, track_controls
from flygym_tpu_torch.ops import _build
from flygym_tpu_torch.ops import megastep as ms

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("qpos", "qvel", "qacc", "act", "xpos", "xquat", "site_xpos", "actuator_force",
          "contact_sensordata")


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_actuator_golden", REPO / "scripts" / "export_actuator_golden.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def compiled():
    return load_compiled(TETHERED_FLY)


@pytest.fixture(scope="module")
def golden():
    return load_actuator_golden(TETHERED_GOLDEN)


def _first_state(golden):
    return dataclasses.replace(golden["state"], ctrl=torch.as_tensor(golden["ctrl"][0]))


def test_the_world_has_no_contact_candidate(compiled, golden):
    m = compiled.model
    assert (m.nq, m.nv, m.nu, m.na, m.ncand, m.nsensor_contact) == (42, 42, 42, 0, 0, 0)
    assert not m.free_joints and not m.welds
    ctrl = golden["ctrl"]
    assert ctrl.shape == (50, 8, 42) and np.abs(ctrl).max() < 5.0 and np.ptp(ctrl[0]) > 5.0


def test_committed_world_equals_a_fresh_export():
    import flygym_tpu

    exporter = _exporter()
    _fly, world = exporter.build_world("tethered_fly")
    sim = flygym_tpu.Simulation(world)
    arrays, meta = exporter._load(
        "export_torch_model", REPO / "scripts" / "export_torch_model.py").export(world, sim)
    committed, committed_meta = _read_npz(TETHERED_FLY)
    assert sorted(committed) == sorted(arrays)
    for key, value in arrays.items():
        np.testing.assert_array_equal(committed[key], value, err_msg=key)
    assert committed_meta == json.loads(json.dumps(meta))


def test_engine_step_tracks_the_jax_engine_golden(compiled, golden):
    """The port's engine step (K1/K1b's plain versions on the CPU) against
    the JAX engine over the golden's 50 steps, within GOLDEN_TOLERANCE."""
    gaps = track_controls(compiled, golden, "engine", device="cpu", megastep=False)
    assert gaps["found_share"] == 0.0
    for key in ("qpos", "qvel"):
        assert gaps[key].max() <= GOLDEN_TOLERANCE[key], key
    assert gaps["qvel"].max() > 0.0  # the engine's sums are not the emitter's


def test_megastep_plain_matches_the_jax_emitter_golden(compiled, golden):
    """K2's plain version, two chained steps, against the JAX emitter's
    golden, to the last bit."""
    st = ms._Static(compiled.model)
    seq = torch.as_tensor(golden["ctrl"][:2])
    new, traj = ms.megastep_plain(st, _first_state(golden), seq)
    rec = golden["emitter"]
    for i in range(2):
        np.testing.assert_array_equal(traj[i].numpy(), rec["qpos"][i])
    np.testing.assert_array_equal(new.qvel.numpy(), rec["qvel"][1])
    assert new.contact_sensordata.shape == (8, 0, 16) and new.act.shape == (8, 0)


def test_committed_golden_equals_a_fresh_jax_emitter(compiled, golden):
    """The golden's first emitter step is what JAX's ``emit_step`` computes
    now, and the plain version's first step equals it in every output."""
    import flygym_tpu
    import jax.numpy as jnp

    from flygym_tpu.ops import megastep as jms

    _fly, world = _exporter().build_world("tethered_fly")
    st = _first_state(golden)
    cols = lambda x: [jnp.asarray(x.numpy()[:, i]) for i in range(x.shape[1])]
    r = jms.emit_step(jms._Static(flygym_tpu.Simulation(world).model),
                      *(cols(getattr(st, k)) for k in ("qpos", "qvel", "ctrl", "act", "qacc")))
    pack = lambda lst: np.stack([np.asarray(x) for x in lst], axis=1)
    np.testing.assert_array_equal(golden["emitter"]["qpos"][0], pack(r["qpos"]))
    plain = ms.megastep_plain(ms._Static(compiled.model), st)
    for key in ("qpos", "qvel", "qacc", "actuator_force"):
        np.testing.assert_array_equal(getattr(plain, key).numpy(), pack(r[key]), err_msg=key)
    np.testing.assert_array_equal(plain.xpos.numpy(),
                                  np.stack([pack(p) for p in r["xpos"]], axis=1))
    assert r["sensordata"] == []


@pytest.mark.parametrize("order", [0, 1], ids=["in_order", "reversed"])
def test_host_build_of_the_kernel_matches_plain(compiled, golden, order):
    """K2's source with the tethered header (NCAND 0: the contact section
    compiled out) as host C++ (g++) against the plain version, bit for bit,
    at K = 1 and K = 3, the block's loops in order and reversed."""
    model = compiled.model
    static = ms._Static(model)
    header, n_scratch = ms.model_header(model)
    assert "constexpr int NCAND = 0;" in header
    lib = _build.build_megastep_host(header)
    state = _first_state(golden)
    seq = torch.as_tensor(golden["ctrl"][:3])
    B = state.qpos.shape[0]
    for K in (1, 3):
        n_in, n_out = ms._io_rows(static, K)
        packed = ms._pack(static, state, seq[:K] if K > 1 else None, None, K).contiguous()
        assert packed.shape == (n_in, B)
        out, scratch = torch.zeros((n_out, B)), torch.zeros((n_scratch, B))
        assert lib.megastep_host_f32(packed.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                                     B, K, order) == 0
        got, traj = ms._unpack(static, out, state, seq[K - 1], K)
        if K == 1:
            want = ms.megastep_plain(static, state)
        else:
            want, wtraj = ms.megastep_plain(static, state, seq[:K])
            assert torch.equal(traj, wtraj)
        for field in FIELDS:
            assert torch.equal(getattr(got, field), getattr(want, field)), (K, field)


def test_megastep_takes_the_tethered_fly(compiled, golden):
    """K2 supports the world, its scratch layout keeps no candidate row, and
    the runtime steps it through the plain version on the CPU when asked."""
    model = compiled.model
    assert ms.megastep_supported(model)
    layout = ms.scratch_layout(model)
    sizes = {name: n for _o, _s, sides in layout["slots"] for side in sides
             for name, _off, n in side}
    assert sizes["S_JAR"] == sizes["S_COMP"] == sizes["S_CACT"] == 0
    sim = Simulation(compiled, device="cpu", megastep=True)
    assert sim.megastep
    sim.set_actuator_inputs(compiled.fly_names[0], "motor",
                            np.random.default_rng(3).uniform(-5, 5, 42).astype(np.float32))
    sim.step()
    traj = sim.rollout(None, 2)
    assert traj.shape == (2, 42) and torch.isfinite(traj).all()
    batch = BatchSimulation(compiled, 2, device="cpu")
    assert not batch.megastep  # the engine step on the CPU by default


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card(compiled, golden):
    """The tethered K2 on the card against its plain version: one K = 8
    launch at 1000 worlds, to the last bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    idx = torch.arange(1000) % 8
    state = _first_state(golden).map(lambda x: x[idx].clone()).to("cuda")
    seq = torch.as_tensor(golden["ctrl"][:8])[:, idx].cuda()
    fn = ms.make_megastep(compiled.model.to("cuda"), 8)
    (got, traj), (want, wtraj) = fn(state, seq), ms.megastep_plain(fn.static, state, seq)
    assert torch.equal(traj, wtraj)
    for field in FIELDS:
        assert torch.equal(getattr(got, field), getattr(want, field)), field
