"""Every actuator kind with its activation states (K2 slice c) against the
JAX package: the engine's forces and activation dynamics, the mega-step's
plain version and K2's host build, the batched runtime.

Two exported worlds carry the kinds (``scripts/export_actuator_golden.py``):
the muscle-driven fly (42 MUSCLE actuators, na 42) and the mixed-kind fly
(one kind per leg: position, motor, velocity, intvelocity, damper and
cylinder, with adhesion; na 14). Inputs are seeded with numpy; the JAX
worlds are compiled from the same builders, and the JAX emitter runs
eagerly on (B,) arrays, as ``tests/engine/test_megastep.py`` runs it. JAX
is imported inside the fixtures and tests that need it, so the ``cuda``
tests run on a machine with the card and PyTorch only::

    python -m pytest --noconftest tests/test_torch_actuators.py -m cuda
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu_torch import BatchSimulation, load_compiled
from flygym_tpu_torch.compose.bridge import (
    ASSETS, MIXED_FLY, MIXED_GOLDEN, MUSCLE_FLY, MUSCLE_GOLDEN, TETHERED_FLY, TWOFLY_FULL,
    _read_npz,
    load_actuator_golden)
from flygym_tpu_torch.engine import actuation
from flygym_tpu_torch.engine.model import ActKind
from flygym_tpu_torch.ops import _build, ldl
from flygym_tpu_torch.ops import megastep as ms

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORLDS = {"muscle_fly": (MUSCLE_FLY, MUSCLE_GOLDEN), "mixed_fly": (MIXED_FLY, MIXED_GOLDEN)}
B = 2
N_SEEDED = 64
KINDS = {"motor": ActKind.MOTOR, "position": ActKind.POSITION, "velocity": ActKind.VELOCITY,
         "intvelocity": ActKind.INTVELOCITY, "damper": ActKind.DAMPER,
         "adhesion": ActKind.ADHESION, "cylinder": ActKind.CYLINDER, "muscle": ActKind.MUSCLE}
STATE_FIELDS = ("qpos", "qvel", "qacc", "act", "xpos", "xquat", "actuator_force",
                "contact_sensordata")


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_actuator_golden", REPO / "scripts" / "export_actuator_golden.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def compiled():
    return {name: load_compiled(path) for name, (path, _g) in WORLDS.items()}


@pytest.fixture(scope="module")
def goldens():
    return {name: load_actuator_golden(g) for name, (_p, g) in WORLDS.items()}


@pytest.fixture(scope="module")
def jax_worlds():
    """name -> (fly, world, JAX simulation, JAX model) of a fresh compile."""
    import flygym_tpu

    exporter = _exporter()
    out = {}
    for name in WORLDS:
        fly, world = exporter.build_world(name)
        sim = flygym_tpu.Simulation(world)
        out[name] = (fly, world, sim, sim.model)
    return out


def _first_state(compiled, golden, name):
    """B settled worlds of the golden with the first step's controls."""
    state = golden[name]["state"].map(lambda x: x[:B].clone())
    return dataclasses.replace(state, ctrl=torch.as_tensor(golden[name]["ctrl"][0, :B]))


@pytest.fixture(scope="module")
def jax_first(jax_worlds, goldens):
    """name -> every output of one eager JAX emitter step from the golden."""
    import jax.numpy as jnp

    from flygym_tpu.ops import megastep as jms

    out = {}
    for name in WORLDS:
        st = _first_state(None, goldens, name)
        cols = lambda x: [jnp.asarray(np.asarray(x)[:, i]) for i in range(np.asarray(x).shape[1])]
        pack = lambda lst: np.stack([np.asarray(x) for x in lst], axis=1)
        r = jms.emit_step(jms._Static(jax_worlds[name][3]),
                          *(cols(getattr(st, k)) for k in ("qpos", "qvel", "ctrl", "act", "qacc")))
        out[name] = dict(
            qpos=pack(r["qpos"]), qvel=pack(r["qvel"]), qacc=pack(r["qacc"]), act=pack(r["act"]),
            xpos=np.stack([pack(p) for p in r["xpos"]], axis=1),
            xquat=np.stack([pack(p) for p in r["xquat"]], axis=1),
            actuator_force=pack(r["actuator_force"]),
            contact_sensordata=np.stack([pack(s) for s in r["sensordata"]], axis=1),
        )
    return out


@pytest.fixture(scope="module")
def plain_first(compiled, goldens):
    return {name: ms.megastep_plain(ms._Static(compiled[name].model),
                                    _first_state(compiled, goldens, name))
            for name in WORLDS}


def _seeded_inputs(model, seed: int):
    """Seeded q, v, ctrl and act of N_SEEDED worlds: joints over ±2.5 rad (the
    muscles' length curve over all its pieces), velocities to ±15 rad/s,
    controls beyond their ranges (the clamps), activations in [-0.2, 1.2]."""
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    qpos = np.tile(model.qpos0.numpy(), (N_SEEDED, 1))
    qpos[:, model.hinge_qadr.numpy()] = rng.uniform(-2.5, 2.5, (N_SEEDED, model.nhinge))
    qvel = rng.uniform(-15.0, 15.0, (N_SEEDED, model.nv))
    ctrl = rng.uniform(-1.5, 1.5, (N_SEEDED, model.nu))
    act = rng.uniform(-0.2, 1.2, (N_SEEDED, model.na))
    return f(qpos), f(qvel), f(ctrl), f(act)


@pytest.mark.parametrize("kind", list(KINDS))
def test_actuator_forces_match_jax(compiled, jax_worlds, kind):
    """The engine's forces of one kind against JAX's ``actuator_forces`` on
    seeded inputs (rtol 1e-5, atol 1e-5; one rounding differs where JAX
    folds a constant), and the generalised force of all kinds."""
    import jax

    from flygym_tpu.engine.actuation import actuator_forces

    name = "muscle_fly" if kind == "muscle" else "mixed_fly"
    model = compiled[name].model
    ids = np.flatnonzero(model.act_kind.numpy() == KINDS[kind])
    assert len(ids), kind
    q, v, c, a = _seeded_inputs(model, seed=int(KINDS[kind]))
    want_qfrc, want = jax.vmap(actuator_forces, in_axes=(None, 0, 0, 0, 0))(
        jax_worlds[name][3], q, v, c, a)
    got_qfrc, got = actuation.actuator_forces(model, *map(torch.from_numpy, (q, v, c, a)))
    np.testing.assert_allclose(got.numpy()[:, ids], np.asarray(want)[:, ids], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_qfrc.numpy(), np.asarray(want_qfrc), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(WORLDS))
def test_integrate_act_matches_jax(compiled, jax_worlds, name):
    """Activation dynamics (intvelocity's integral, cylinder's filter,
    muscle activation with its clamp) against JAX's ``integrate_act``."""
    import jax

    from flygym_tpu.engine.actuation import integrate_act

    model = compiled[name].model
    _q, _v, c, a = _seeded_inputs(model, seed=11)
    dt = model.timestep
    want = np.array(jax.vmap(integrate_act, in_axes=(None, 0, 0, None))(
        jax_worlds[name][3], a, c, dt))
    got = actuation.integrate_act(model, torch.from_numpy(a), torch.from_numpy(c), dt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert not np.array_equal(got.numpy(), a)


@pytest.mark.parametrize("name", list(WORLDS))
def test_committed_world_equals_a_fresh_export(jax_worlds, name):
    _fly, world, sim, _model = jax_worlds[name]
    arrays, meta = _exporter()._load(
        "export_torch_model", REPO / "scripts" / "export_torch_model.py").export(world, sim)
    committed, committed_meta = _read_npz(WORLDS[name][0])
    assert sorted(committed) == sorted(arrays)
    for key, value in arrays.items():
        np.testing.assert_array_equal(committed[key], value, err_msg=key)
    assert committed_meta == json.loads(json.dumps(meta))


@pytest.mark.parametrize("name", list(WORLDS))
def test_committed_golden_equals_a_fresh_jax_emitter(goldens, jax_first, name):
    """The golden's first emitter step is what the JAX emitter computes."""
    rec = goldens[name]["emitter"]
    for key, field in (("qpos", "qpos"), ("qvel", "qvel"), ("act", "act"),
                       ("sensordata", "contact_sensordata")):
        np.testing.assert_array_equal(rec[key][0, :B], jax_first[name][field], err_msg=key)


@pytest.mark.parametrize("name", list(WORLDS))
@pytest.mark.parametrize("field", STATE_FIELDS)
def test_plain_emitter_matches_jax_emit_step(jax_first, plain_first, name, field):
    """The plain K2 against JAX's ``emit_step``, bit for bit: the same ops in
    the same order, the muscles' constants folded as JAX folds them."""
    got = getattr(plain_first[name], field).numpy()
    np.testing.assert_array_equal(got, jax_first[name][field])


@pytest.mark.parametrize("order", [0, 1], ids=["in_order", "reversed"])
@pytest.mark.parametrize("name", list(WORLDS))
def test_host_build_of_the_kernel_matches_plain(compiled, goldens, name, order):
    """K2's source compiled as host C++ (g++) against the plain version, bit
    for bit, at K = 1 and at K = 3 (the activations carried through the
    launch's steps), with the block's parallel loops run in order and
    reversed."""
    model = compiled[name].model
    static = ms._Static(model)
    header, n_scratch = ms.model_header(model)
    lib = _build.build_megastep_host(header)
    state = _first_state(compiled, goldens, name)
    seq = torch.as_tensor(goldens[name]["ctrl"][:3, :B])
    for K in (1, 3):
        n_in, n_out = ms._io_rows(static, K)
        ctrl_rows = seq[:K].permute(0, 2, 1).reshape(K * model.nu, B)
        packed = torch.cat([state.qpos.t(), state.qvel.t(), ctrl_rows, state.act.t(),
                            state.qacc.t()]).contiguous()
        assert packed.shape == (n_in, B)
        out, scratch = torch.zeros((n_out, B)), torch.zeros((n_scratch, B))
        assert lib.megastep_host_f32(packed.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                                     B, K, order) == 0
        got, traj = ms._unpack(static, out, state, seq[K - 1], K)
        if K == 1:
            want, wtraj = ms.megastep_plain(static, state), None
        else:
            want, wtraj = ms.megastep_plain(static, state, seq[:K])
            assert torch.equal(traj, wtraj)
        for field in STATE_FIELDS:
            assert torch.equal(getattr(got, field), getattr(want, field)), (K, field)
        assert not torch.equal(got.act, state.act)


@pytest.mark.parametrize("name", list(WORLDS))
@pytest.mark.parametrize("megastep", [True, False], ids=["megastep", "engine"])
def test_paths_track_the_jax_goldens(compiled, goldens, name, megastep):
    """Three golden steps through ``BatchSimulation`` on the CPU: the
    mega-step path (plain K2) equals the JAX emitter to the last bit; the
    engine path stays within the golden tolerance of the JAX engine, its
    activations within 1e-6."""
    from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE, track_controls

    record = "emitter" if megastep else "engine"
    gaps = track_controls(compiled[name], goldens[name], record, device="cpu", n_worlds=B,
                          n_steps=3, megastep=megastep)
    worst = {key: float(np.max(gap)) for key, gap in gaps.items()}
    if megastep:
        assert worst == {"qpos": 0.0, "qvel": 0.0, "act": 0.0, "found_share": 0.0}, worst
    for key, tol in GOLDEN_TOLERANCE.items():
        assert worst[key] <= tol, (key, worst)
    assert worst["act"] <= 1e-6, worst


@pytest.mark.parametrize("name", list(WORLDS))
def test_runtime_sets_and_reads_every_kind(compiled, name):
    """``set_actuator_inputs`` and ``get_actuator_forces`` by kind name; the
    activations are carried through ``rollout`` on the engine path and on
    the K-chunk path (plain K2 on the CPU)."""
    c = compiled[name]
    fly = c.fly_names[0]
    kinds = [k for k in c.flies[fly]["act_ids"] if k != "adhesion"]
    assert set(kinds) == ({"muscle"} if name == "muscle_fly" else
                          {"motor", "position", "velocity", "intvelocity", "damper", "cylinder"})
    rng = np.random.default_rng(3)
    for megastep in (False, True):
        n_steps = 2  # the mega-step path: one K = 2 launch
        sim = BatchSimulation(c, B, device="cpu", megastep=megastep, megastep_k=2)
        sim.set_leg_adhesion_states(fly, np.ones(6, np.float32))
        inputs = {}
        for kind in kinds:
            n = len(sim.actuated_dofs(fly, kind))
            inputs[kind] = rng.uniform(0.3, 1.0, (B, n)).astype(np.float32)
            sim.set_actuator_inputs(fly, kind, inputs[kind])
        with pytest.raises(ValueError, match="inputs"):
            sim.set_actuator_inputs(fly, kinds[0], np.zeros(3))
        traj = sim.rollout(None, n_steps)
        assert traj.shape == (n_steps, B, c.model.nq) and torch.isfinite(traj).all()
        assert abs(sim.time - n_steps * c.model.timestep) < 1e-7
        for kind in kinds:
            ids = sim.actuator_ids(fly, kind)
            assert torch.equal(sim.state.ctrl[:, ids], torch.from_numpy(inputs[kind]))
            forces = sim.get_actuator_forces(fly, kind)
            assert forces.shape == (B, len(ids)) and torch.isfinite(forces).all()
        act = sim.state.act
        assert act.shape == (B, c.model.na) and bool((act != 0).all())
        if name == "muscle_fly":
            assert bool(((act >= 0) & (act <= 1)).all())


def test_megastep_takes_every_kind_and_refuses_slice_g(compiled):
    """K2 takes every actuator kind and activation states, worlds without
    contact candidates (slice g.1: the tethered fly with a hard weld has
    none, and drives its 42 DoFs with motors) and compressed pair rows on a
    heightfield (slice g.2). It refuses what JAX's gate refuses on
    features: the PGS solver and welds (the soft-welded tether)."""
    for c in compiled.values():
        assert c.model.na > 0 and ms.megastep_supported(c.model)
    kinds = set(compiled["mixed_fly"].model.act_kind.tolist())
    assert kinds == set(range(7))
    tethered = load_compiled(TETHERED_FLY).model
    assert tethered.ncand == 0 and set(tethered.act_kind.tolist()) == {ActKind.MOTOR}
    assert ms.megastep_supported(tethered)
    assert ms.make_megastep(tethered).static.ncand == 0
    full = load_compiled(TWOFLY_FULL).model
    assert ms.megastep_supported(full)
    on_terrain = dataclasses.replace(full, has_hfield=True)
    assert ms.megastep_supported(on_terrain)
    for name in ("pgs_fly", "softweld_fly"):
        refused = load_compiled(ASSETS / f"{name}.npz").model
        assert not ms.megastep_supported(refused), name
        with pytest.raises(NotImplementedError, match="mega-step"):
            ms.make_megastep(refused)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WORLDS))
def test_kernel_with_activations_equals_plain(name):
    """K2 against its plain version on the card at 1000 worlds, one K = 8
    launch from the golden's settled worlds with its first 8 controls: to
    1e-6 of the largest value of each output, the activations included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c, golden = load_compiled(WORLDS[name][0]), load_actuator_golden(WORLDS[name][1])
    idx = torch.arange(1000) % golden["state"].qpos.shape[0]
    state = golden["state"].map(lambda x: x[idx].clone()).to("cuda")
    seq = torch.as_tensor(golden["ctrl"][:8])[:, idx].cuda()
    state = dataclasses.replace(state, ctrl=seq[0])
    fn = ms.make_megastep(c.model.to("cuda"), 8)
    before = ms.launches["megastep"]
    (got, traj), (want, wtraj) = fn(state, seq), ms.megastep_plain(fn.static, state, seq)
    torch.cuda.synchronize()
    assert ms.launches["megastep"] == before + 1
    assert (traj - wtraj).abs().max() <= 1e-6 * wtraj.abs().max()
    for f in STATE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a - b).abs().max() <= 1e-6 * b.abs().max(), f


@pytest.mark.cuda
def test_muscle_rollout_launch_counts():
    """16 steps of the muscle fly at 64 worlds through the default step are
    2 K = 8 launches of K2 and no K1/K1b launch; the activations stay in
    [0, 1]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim = BatchSimulation(load_compiled(MUSCLE_FLY), 64)
    assert sim.megastep
    fly = sim.compiled.fly_names[0]
    sim.set_leg_adhesion_states(fly, torch.ones(6, device="cuda"))
    sim.set_actuator_inputs(fly, "muscle", torch.full((42,), 0.7, device="cuda"))
    ms.reset_launches()
    ldl.reset_launches()
    sim.rollout(None, 16, record_trajectory=False)
    torch.cuda.synchronize()
    assert ms.launches["megastep"] == 2 and ldl.launches["tree_ldl_factor"] == 0
    act = sim.state.act
    assert bool(((act > 0) & (act <= 1)).all())
