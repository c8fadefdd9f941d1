"""The exact Newton solver (``solver_exact``, K2 slice f) against the JAX
package: the engine's re-factored Newton, the mega-step's plain version and
K2's host build, on the strict replay's fly (``strict_fly.npz``: the
benchmark fly with ``solver_exact`` and 10 Newton iterations,
``scripts/export_actuator_golden.py``).

The JAX emitter runs eagerly on (B,) arrays from the golden's settled state
with the first replay step's controls, as ``tests/engine/test_megastep.py``
runs it. JAX is imported inside the fixtures that need it, so the ``cuda``
tests run on a machine with the card and PyTorch only::

    python -m pytest --noconftest tests/test_torch_strict.py -m cuda
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu_torch import BatchSimulation, load_compiled
from flygym_tpu_torch.compose.bridge import STRICT_FLY, STRICT_GOLDEN, _read_npz, load_actuator_golden
from flygym_tpu_torch.engine import step as engine_step
from flygym_tpu_torch.ops import _build, ldl
from flygym_tpu_torch.ops import megastep as ms

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
B = 2
ITERATIONS = 10
STATE_FIELDS = ("qpos", "qvel", "qacc", "xpos", "xquat", "actuator_force", "contact_sensordata")


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_actuator_golden", REPO / "scripts" / "export_actuator_golden.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def compiled():
    return load_compiled(STRICT_FLY)


@pytest.fixture(scope="module")
def golden():
    return load_actuator_golden(STRICT_GOLDEN)


@pytest.fixture(scope="module")
def first_state(golden):
    """B settled worlds with the first replay step's controls."""
    state = golden["state"].map(lambda x: x[:B].clone())
    return dataclasses.replace(state, ctrl=torch.as_tensor(golden["ctrl"][0, :B]))


@pytest.fixture(scope="module")
def jax_world():
    import flygym_tpu

    _fly, world = _exporter().build_world("strict_fly")
    sim = flygym_tpu.Simulation(world)
    return world, sim


@pytest.fixture(scope="module")
def jax_first(jax_world, first_state):
    """Every output of one eager JAX emitter step."""
    import jax.numpy as jnp

    from flygym_tpu.ops import megastep as jms

    cols = lambda x: [jnp.asarray(np.asarray(x)[:, i]) for i in range(np.asarray(x).shape[1])]
    pack = lambda lst: np.stack([np.asarray(x) for x in lst], axis=1)
    st = first_state
    r = jms.emit_step(jms._Static(jax_world[1].model),
                      *(cols(getattr(st, k)) for k in ("qpos", "qvel", "ctrl", "act", "qacc")))
    return dict(
        qpos=pack(r["qpos"]), qvel=pack(r["qvel"]), qacc=pack(r["qacc"]),
        xpos=np.stack([pack(p) for p in r["xpos"]], axis=1),
        xquat=np.stack([pack(p) for p in r["xquat"]], axis=1),
        actuator_force=pack(r["actuator_force"]),
        contact_sensordata=np.stack([pack(s) for s in r["sensordata"]], axis=1),
    )


@pytest.fixture(scope="module")
def plain_first(compiled, first_state):
    return ms.megastep_plain(ms._Static(compiled.model), first_state)


def test_the_strict_fly_loads_with_the_exact_newton(compiled):
    model = compiled.model
    assert model.solver_exact and model.solver_iterations == ITERATIONS
    assert ms.megastep_supported(model)
    assert ms._Static(model).solver_exact
    header, _n = ms.model_header(model)
    assert "constexpr int SOLVER_EXACT = 1;" in header
    assert f"constexpr int NEWTON_ITERS = {ITERATIONS};" in header


def test_committed_world_equals_a_fresh_export(jax_world):
    world, sim = jax_world
    arrays, meta = _exporter()._load(
        "export_torch_model", REPO / "scripts" / "export_torch_model.py").export(world, sim)
    committed, committed_meta = _read_npz(STRICT_FLY)
    assert sorted(committed) == sorted(arrays)
    for key, value in arrays.items():
        np.testing.assert_array_equal(committed[key], value, err_msg=key)
    assert committed_meta == json.loads(json.dumps(meta))


def test_committed_golden_equals_a_fresh_jax_emitter(golden, jax_first):
    rec = golden["emitter"]
    for key, field in (("qpos", "qpos"), ("qvel", "qvel"), ("sensordata", "contact_sensordata")):
        np.testing.assert_array_equal(rec[key][0, :B], jax_first[field], err_msg=key)


@pytest.mark.parametrize("field", STATE_FIELDS)
def test_plain_emitter_matches_jax_emit_step(jax_first, plain_first, field):
    """The plain K2 with the Hessian re-filled and re-factored at each of
    the 10 iterations against JAX's ``emit_step``, bit for bit."""
    np.testing.assert_array_equal(getattr(plain_first, field).numpy(), jax_first[field])


@pytest.mark.parametrize("order", [0, 1], ids=["in_order", "reversed"])
def test_host_build_of_the_kernel_matches_plain(compiled, first_state, plain_first, order):
    """K2's source compiled as host C++ (g++), the exact Newton's branch
    (``SOLVER_EXACT``) included, against the plain version, bit for bit,
    with the block's parallel loops run in order and reversed."""
    static = ms._Static(compiled.model)
    header, n_scratch = ms.model_header(compiled.model)
    lib = _build.build_megastep_host(header)
    n_in, n_out = ms._io_rows(static, 1)
    s = first_state
    packed = torch.cat([s.qpos.t(), s.qvel.t(), s.ctrl.t(), s.act.t(), s.qacc.t()]).contiguous()
    assert packed.shape == (n_in, B)
    out, scratch = torch.zeros((n_out, B)), torch.zeros((n_scratch, B))
    assert lib.megastep_host_f32(packed.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, 1,
                                 order) == 0
    got, _traj = ms._unpack(static, out, s, s.ctrl, 1)
    for field in STATE_FIELDS:
        assert torch.equal(getattr(got, field), getattr(plain_first, field)), field


def test_engine_exact_newton_matches_the_jax_engine(compiled, golden, first_state):
    """One engine step from the settled state against the JAX engine's
    (the golden's first step), within the reference's emitter-vs-engine bars
    (``tests/engine/test_megastep.py:121-144``)."""
    got = engine_step.step(compiled.model, first_state)
    rec = golden["engine"]
    dt = compiled.model.timestep
    np.testing.assert_allclose(got.qpos.numpy(), rec["qpos"][0, :B], rtol=0, atol=1e-6 + 2e-4 * dt)
    np.testing.assert_allclose(got.qvel.numpy(), rec["qvel"][0, :B], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.contact_sensordata[..., :4].numpy(),
                               rec["sensordata"][0, :B, :, :4], rtol=0, atol=2e-3)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "frozen"])
def test_engine_factor_and_solve_calls_per_step(compiled, first_state, monkeypatch, exact):
    """The exact Newton factors once per iteration (10 factor and 10 solve
    calls a step: on the card 10 K1 and 10 K1b launches); the frozen Newton
    of the same model once per step."""
    calls = {"factor": 0, "solve": 0}
    factor, solve = ldl.tree_ldl_factor, ldl.tree_ldl_solve

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    monkeypatch.setattr(ldl, "tree_ldl_factor", counted("factor", factor))
    monkeypatch.setattr(ldl, "tree_ldl_solve", counted("solve", solve))
    model = dataclasses.replace(compiled.model, solver_exact=exact)
    engine_step.step(model, first_state)
    assert calls == {"factor": ITERATIONS if exact else 1, "solve": ITERATIONS}


def test_exact_and_frozen_newton_differ(compiled, golden, first_state, plain_first):
    """On this state the active set changes within the step, so re-factoring
    moves the result: the exact branch is the one that ran."""
    frozen = dataclasses.replace(compiled.model, solver_exact=False)
    other = ms.megastep_plain(ms._Static(frozen), first_state)
    assert not torch.equal(other.qacc, plain_first.qacc)


@pytest.mark.parametrize("megastep", [True, False], ids=["megastep", "engine"])
def test_paths_track_the_jax_goldens(compiled, golden, megastep):
    """Two golden steps through ``BatchSimulation`` on the CPU: the
    mega-step path equals the JAX emitter to the last bit, the engine path
    stays within the golden tolerance of the JAX engine."""
    from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE, track_controls

    gaps = track_controls(compiled, golden, "emitter" if megastep else "engine", device="cpu",
                          n_worlds=B, n_steps=2, megastep=megastep)
    worst = {key: float(np.max(gap)) for key, gap in gaps.items()}
    if megastep:
        assert worst["qpos"] == 0.0 and worst["qvel"] == 0.0, worst
    for key, tol in GOLDEN_TOLERANCE.items():
        assert worst[key] <= tol, (key, worst)


def test_replay_protocol_takes_the_strict_model(compiled):
    """``run_simulation`` runs the replay's protocol unchanged on the strict
    model (CPU, engine path, a short settle and replay)."""
    from flygym_tpu_torch.demo.benchmark import ReplayTargetData, run_simulation

    fly = compiled.fly_names[0]
    order = [tuple(d) for d in compiled.flies[fly]["actuated_dofs"]["position"]]
    targets = ReplayTargetData(compiled.model.timestep, order).make_target_angles_all_worlds(B, 3)
    walltime, sim = run_simulation(compiled, targets, device="cpu", warmup_steps=2,
                                   megastep=False)
    assert walltime > 0 and isinstance(sim, BatchSimulation)
    # bench.py's protocol: the settle, an untimed replay and the timed one.
    assert abs(sim.time - (2 + 2 * 3) * compiled.model.timestep) < 1e-7
    assert torch.isfinite(sim.state.qvel).all()


@pytest.mark.cuda
def test_kernel_with_the_exact_newton_equals_plain():
    """K2 with ``SOLVER_EXACT`` against its plain version on the card at
    1000 worlds, one K = 1 launch from the golden's settled worlds, to 1e-6
    of the largest value of each output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c, golden = load_compiled(STRICT_FLY), load_actuator_golden(STRICT_GOLDEN)
    idx = torch.arange(1000) % golden["state"].qpos.shape[0]
    state = golden["state"].map(lambda x: x[idx].clone()).to("cuda")
    state = dataclasses.replace(state, ctrl=torch.as_tensor(golden["ctrl"][0])[idx].cuda())
    fn = ms.make_megastep(c.model.to("cuda"), 1)
    before = ms.launches["megastep"]
    got, want = fn(state), ms.megastep_plain(fn.static, state)
    torch.cuda.synchronize()
    assert ms.launches["megastep"] == before + 1
    for f in STATE_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a - b).abs().max() <= 1e-6 * b.abs().max(), f


@pytest.mark.cuda
def test_engine_launches_per_step_on_the_card():
    """Two engine steps of the strict fly at 64 worlds: 10 K1 and 10 K1b
    launches per step, no K2 launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sim = BatchSimulation(load_compiled(STRICT_FLY), 64, megastep=False)
    ldl.reset_launches()
    ms.reset_launches()
    sim.rollout(None, 2, record_trajectory=False)
    torch.cuda.synchronize()
    assert ldl.launches == {"tree_ldl_factor": 2 * ITERATIONS, "tree_ldl_solve": 2 * ITERATIONS,
                            "tree_ldl_solve_backward": 0}
    assert ms.launches["megastep"] == 0 and torch.isfinite(sim.state.qpos).all()
