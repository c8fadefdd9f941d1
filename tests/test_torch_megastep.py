"""The mega-step (K2) of the port against the JAX package's emitter.

Inputs are the JAX settled benchmark state (the first two worlds of
``flygym_tpu_torch/assets/benchmark_fly_golden.npz``) with the first replay
targets applied: the first replay step moves |qacc| to ~6e5, far from the
quiescent settled state where the line search amplifies 1e-6 relative
differences (PERF.md, PR 1), as ``tests/test_torch_engine.py`` does.

The JAX emitter runs eagerly on (B,) arrays, as ``tests/engine/
test_megastep.py:70-100`` runs it. JAX is imported inside the fixtures that
need it, so the ``cuda`` test below runs on a machine with the card and
PyTorch only::

    python -m pytest --noconftest tests/test_torch_megastep.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from flygym_tpu_torch import BatchSimulation, load_compiled
from flygym_tpu_torch.compose.bridge import ASSETS, TETHERED_FLY, TWOFLY, TWOFLY_FULL, load_golden
from flygym_tpu_torch.engine import maths
from flygym_tpu_torch.ops import _build
from flygym_tpu_torch.ops import megastep as ms

torch.set_num_threads(1)

B = 2
MEGASTEP_GOLDEN = ASSETS / "benchmark_fly_megastep_golden.npz"

# Plain emitter (and K2's host build) vs JAX emit_step, as a share of the
# largest JAX value. The two run the same ops in the same order, with sin and
# cos rounded as glibc rounds them (XLA's CPU backend calls glibc): measured
# bit-identical. One ulp of torch's own sin gave 1.9e-6 here (qacc, qvel,
# sensors) and 3.6e-7 in xpos, so the bars sit above one such ulp.
RTOL_OF_MAX = 1e-5
ATOL_FK = 1e-6


def _with_targets(state, compiled, targets):
    ids = torch.tensor(compiled.flies[compiled.fly_names[0]]["act_ids"]["position"])
    ctrl = state.ctrl.clone()
    ctrl[:, ids] = torch.as_tensor(targets)
    return dataclasses.replace(state, ctrl=ctrl)


@pytest.fixture(scope="module")
def compiled():
    return load_compiled()


@pytest.fixture(scope="module")
def golden():
    return load_golden()


@pytest.fixture(scope="module")
def first_state(compiled, golden):
    """B settled worlds with the first replay step's targets."""
    state = golden["state"].map(lambda x: x[:B].clone())
    return _with_targets(state, compiled, golden["targets"][:B, 0])


@pytest.fixture(scope="module")
def static(compiled):
    return ms._Static(compiled.model)


@pytest.fixture(scope="module")
def jax_model():
    from flygym_tpu.demo.benchmark import make_model

    _fly, world, _cam = make_model()
    model, _state = world.compile()
    return model


@pytest.fixture(scope="module")
def jax_steps(jax_model, compiled, golden):
    """Two chained JAX emitter steps of the replay from the settled state:
    every output of the first, qpos/qvel/sensordata of both."""
    import jax.numpy as jnp

    from flygym_tpu.ops import megastep as jms

    st = jms._Static(jax_model)
    state = golden["state"].map(lambda x: x[:B].clone())
    cols = lambda x: [jnp.asarray(np.asarray(x)[:, i]) for i in range(np.asarray(x).shape[1])]
    pack = lambda lst: np.stack([np.asarray(x) for x in lst], axis=1)
    q, v, act, warm = (cols(getattr(state, k)) for k in ("qpos", "qvel", "act", "qacc"))
    out = []
    for i in range(2):
        ctrl = _with_targets(state, compiled, golden["targets"][:B, i]).ctrl
        r = jms.emit_step(st, q, v, cols(ctrl), act, warm)
        q, v, act, warm = r["qpos"], r["qvel"], r["act"], r["qacc"]
        out.append(dict(
            qpos=pack(r["qpos"]),
            qvel=pack(r["qvel"]),
            qacc=pack(r["qacc"]),
            xpos=np.stack([pack(p) for p in r["xpos"]], axis=1),
            xquat=np.stack([pack(p) for p in r["xquat"]], axis=1),
            actuator_force=pack(r["actuator_force"]),
            contact_sensordata=np.stack([pack(s) for s in r["sensordata"]], axis=1),
        ))
    return out


@pytest.fixture(scope="module")
def plain_first(static, first_state):
    return ms.megastep_plain(static, first_state)


@pytest.mark.parametrize(
    "name",
    ["topo", "pair_keys", "elim_order", "dof_path", "adh_groups", "sensor_groups",
     "free_dof_axis"],
)
def test_static_tables_equal_jax(jax_model, static, name):
    from flygym_tpu.ops import megastep as jms

    assert getattr(static, name) == getattr(jms._Static(jax_model), name)


@pytest.mark.parametrize(
    "name", ["qpos", "qvel", "qacc", "xpos", "xquat", "actuator_force", "contact_sensordata"]
)
def test_plain_emitter_matches_jax_emit_step(jax_steps, plain_first, name):
    want = jax_steps[0][name]
    got = getattr(plain_first, name).numpy()
    assert got.shape == want.shape
    gap = np.abs(got - want).max()
    if name in ("qpos", "xpos", "xquat"):
        assert gap <= ATOL_FK, gap
    else:
        assert gap <= RTOL_OF_MAX * np.abs(want).max(), gap


def test_k_steps_plain_equals_chained_single_steps(static, compiled, golden, first_state):
    """K = 3 in one call is three K = 1 steps, bit for bit."""
    seq = torch.stack([
        _with_targets(first_state, compiled, golden["targets"][:B, i]).ctrl for i in range(3)
    ])
    fused, traj = ms.megastep_plain(static, first_state, seq)
    state, rows = first_state, []
    for i in range(3):
        state = ms.megastep_plain(static, dataclasses.replace(state, ctrl=seq[i]))
        rows.append(state.qpos)
    assert torch.equal(traj, torch.stack(rows))
    for f in dataclasses.fields(state):
        if f.name != "time":
            assert torch.equal(getattr(fused, f.name), getattr(state, f.name)), f.name
    torch.testing.assert_close(fused.time, state.time)


@pytest.mark.parametrize("step", [0, 1])
def test_committed_golden_equals_a_fresh_jax_emitter(jax_steps, step):
    """The committed mega-step golden is what the JAX emitter computes (its
    first two steps, for the first B of its worlds)."""
    data = np.load(MEGASTEP_GOLDEN)
    for key, name in (("qpos", "qpos"), ("qvel", "qvel"), ("sensordata", "contact_sensordata")):
        want = jax_steps[step][name]
        np.testing.assert_allclose(data[key][step, :B], want, rtol=1e-6, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("order", [0, 1], ids=["in_order", "reversed"])
def test_host_build_of_the_kernel_matches_plain(compiled, static, first_state, plain_first, order):
    """K2's source compiled as host C++ (g++) against the plain version: the
    kernel's arithmetic on the CPU (measured bit-identical; bars as for JAX),
    with the block's parallel loops run in order and reversed."""
    header, n_scratch = ms.model_header(compiled.model)
    lib = _build.build_megastep_host(header)
    n_in, n_out = ms._io_rows(static, 1)
    s = first_state
    packed = torch.cat([s.qpos.t(), s.qvel.t(), s.ctrl.t(), s.act.t(), s.qacc.t()]).contiguous()
    assert packed.shape == (n_in, B)
    out = torch.zeros((n_out, B))
    scratch = torch.zeros((n_scratch, B))
    assert lib.megastep_host_f32(packed.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, 1,
                                 order) == 0
    got, _traj = ms._unpack(static, out, s, s.ctrl, 1)
    for name in ("qpos", "xpos", "xquat"):
        assert (getattr(got, name) - getattr(plain_first, name)).abs().max() <= ATOL_FK, name
    for name in ("qvel", "qacc", "actuator_force", "contact_sensordata"):
        want = getattr(plain_first, name)
        gap = (getattr(got, name) - want).abs().max()
        assert gap <= RTOL_OF_MAX * want.abs().max(), (name, gap)


def test_host_build_powf_equals_jax(compiled):
    """K2's ``ms_powf`` (the impedance's pow), compiled as host C++ with
    g++, equals ``jnp.power`` on the CPU to the last bit: normal, tiny,
    subnormal and zero x at exponents below and above 1 (a subnormal x reads
    as 2^-150, so x^y is not 0 where y < ~0.84)."""
    import jax.numpy as jnp

    lib = _build.build_megastep_host(ms.model_header(compiled.model)[0])
    rng = np.random.default_rng(3)
    x = rng.uniform(0.0, 1.0, 20000).astype(np.float32)
    x[::5] *= np.float32(2.0**-40)
    x[:8] = [0.0, 2.0**-130, 2.0**-149, 1e-45, 3e-39, 1.1754942e-38, 2.0**-126, 1.0]
    for power in (0.25, 0.5, 0.8, 0.84, 1.0, 1.5, 3.0):
        y = np.full_like(x, power)
        out = np.empty_like(x)
        assert lib.megastep_powf_host_f32(x.ctypes.data, y.ctypes.data, out.ctypes.data,
                                          x.size) == 0
        want = np.asarray(jnp.power(jnp.asarray(x), jnp.asarray(y)))
        np.testing.assert_array_equal(out, want, err_msg=str(power))
        np.testing.assert_array_equal(
            out, maths.powf(torch.from_numpy(x), torch.from_numpy(y)).numpy())


@pytest.mark.parametrize("name", ["sinf", "cosf"])
def test_sin_cos_round_as_libm(name):
    """The emitter's sin/cos equal glibc's sinf/cosf (which XLA's CPU backend
    calls) on joint-angle arguments, and stay within an ulp beyond them."""
    import ctypes

    libm = ctypes.CDLL("libm.so.6")
    fn = getattr(libm, name)
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-4.0, 4.0, 20000), rng.uniform(-1e-3, 1e-3, 2000),
        [0.0, -0.0, 2.0**-12, np.pi / 4, -np.pi / 4, np.pi / 2, np.pi],
    ]).astype(np.float32)
    want = np.array([fn(float(v)) for v in x], np.float32)
    got = (ms._sinf if name == "sinf" else ms._cosf)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    far = np.float32([50.0, -57.3, 119.0, 150.0, -300.0])
    got_far = (ms._sinf if name == "sinf" else ms._cosf)(torch.from_numpy(far)).numpy()
    np.testing.assert_allclose(got_far, [fn(float(v)) for v in far], atol=2e-7)


def test_plain_emitter_inside_the_impedance_width_equals_jax(jax_model, compiled, static):
    """32 worlds whose lowest capsule end sinks 0.5-9.5e-6 mm into the ground,
    inside the impedance's width (1e-5 mm), where the impedance takes x^3 on
    both sides of its midpoint: the plain emitter against JAX's emit_step to
    the last bit. Its pow is glibc's powf, as JAX's; x*x*x, which differs
    from powf in a quarter of arguments (``test_powf_rounds_as_jax``),
    passes here too: dmin + y (dmax - dmin) rounds y's last bit away (no
    impedance changed at 2048 depths of the benchmark fly)."""
    import jax.numpy as jnp

    from flygym_tpu.ops import megastep as jms

    from flygym_tpu_torch.engine.contact import contact_candidates
    from flygym_tpu_torch.engine.kinematics import forward_kinematics, geom_poses

    model = compiled.model
    sink = torch.linspace(5e-7, 9.5e-6, 32)
    state = compiled.initial_state.map(lambda x: x.expand((len(sink),) + x.shape[1:]).clone())
    dist = contact_candidates(model, *geom_poses(model, state.xpos, state.xquat))[0]
    qpos = state.qpos.clone()
    qpos[:, 2] -= dist.min(dim=1).values + sink
    xpos, xquat = forward_kinematics(model, qpos)
    state = dataclasses.replace(state, qpos=qpos, xpos=xpos, xquat=xquat)
    dist = contact_candidates(model, *geom_poses(model, xpos, xquat))[0]
    lowest = dist.min(dim=1).values
    width = float(static.can_solimp[0, 2])
    assert bool(((lowest < 0) & (lowest > -width)).all()), lowest
    plain = ms.megastep_plain(static, state)
    cols = lambda x: [jnp.asarray(x[:, i].numpy()) for i in range(x.shape[1])]
    r = jms.emit_step(jms._Static(jax_model), *(cols(getattr(state, k))
                      for k in ("qpos", "qvel", "ctrl", "act", "qacc")))
    for name in ("qpos", "qvel", "qacc"):
        want = np.stack([np.asarray(v) for v in r[name]], axis=1)
        np.testing.assert_array_equal(getattr(plain, name).numpy(), want, err_msg=name)
    want = np.stack([np.stack([np.asarray(v) for v in s_], axis=1) for s_ in r["sensordata"]],
                    axis=1)
    np.testing.assert_array_equal(plain.contact_sensordata.numpy(), want)


def test_mega_golden_first_steps_on_cpu(compiled, golden):
    """The mega-step path through BatchSimulation on the CPU tracks the JAX
    mega-step golden over its first 4 steps (2 worlds), within the golden
    tolerance (measured: bit-identical)."""
    from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE, track_golden

    mega = load_golden(MEGASTEP_GOLDEN)
    short = dict(mega, targets=mega["targets"][:, :4])
    for key in ("qpos", "qvel", "sensordata"):
        short[key] = mega[key][:4]
    worst = track_golden(compiled, short, device="cpu", n_worlds=B, megastep=True)
    for key, tol in GOLDEN_TOLERANCE.items():
        assert worst[key] <= tol, (key, worst[key])
    assert worst["qpos"] <= 1e-6 and worst["qvel"] <= 1e-3, worst


def test_batch_replays_k_chunks_through_the_plain_emitter(compiled):
    """16 steps with megastep=True on the CPU: 2 launches of the K = 8 step,
    NaN controls forward-filled within each chunk, time advanced 16 dt."""
    sim = BatchSimulation(compiled, 1, device="cpu", megastep=True)
    fly = compiled.fly_names[0]
    sim.set_leg_adhesion_states(fly, np.ones(6))
    _none, kfn = sim.step_fns(16)
    assert _none is None and kfn.k_steps == 8
    seen = []

    def spy(states, ctrl_seq):
        seen.append(ctrl_seq[0].clone())
        return kfn(states, ctrl_seq)

    spy.k_steps = 8
    sim._megastep_fns[8] = spy
    nu = compiled.model.nu
    seq = np.full((16, nu), np.nan, np.float32)
    seq[3, :5] = 0.25
    seq[9, 2] = -0.5
    ctrl0 = sim.state.ctrl.clone()
    traj = sim.rollout(seq, 16)
    assert len(seen) == 2 and traj.shape == (16, 1, compiled.model.nq)
    want = ctrl0.expand(16, 1, nu).clone()
    want[3:, :, :5] = 0.25
    want[9:, :, 2] = -0.5
    assert torch.equal(torch.cat(seen), want)
    assert torch.equal(sim.state.ctrl, want[-1])
    assert abs(sim.time - 16 * compiled.model.timestep) < 1e-7
    assert torch.isfinite(traj).all()


def test_megastep_takes_solver_exact():
    """``solver_exact`` (K2 slice f) on example 11's world, whose pair rows
    K2 takes, with 4 Newton iterations (3 re-factored), from the two-fly golden's settled
    state with seeded velocity noise, so that the active set changes within
    the step: K2's host build (g++) equals the plain version to the last
    bit, and the exact Newton moves the result away from the frozen one."""
    from flygym_tpu_torch.compose.bridge import load_twofly_golden

    twofly = load_compiled(TWOFLY)
    model = dataclasses.replace(twofly.model, solver_exact=True, solver_iterations=4)
    assert ms.megastep_supported(model)
    static = ms._Static(model)
    header, n_scratch = ms.model_header(model)
    assert "constexpr int SOLVER_EXACT = 1;" in header
    lib = _build.build_megastep_host(header)
    s = load_twofly_golden()["state"].map(lambda x: x[:B].clone())
    rng = np.random.default_rng(5)
    s = dataclasses.replace(s, qvel=s.qvel + torch.as_tensor(
        rng.normal(0.0, 2.0, s.qvel.shape), dtype=torch.float32))
    want = ms.megastep_plain(static, s)
    n_in, n_out = ms._io_rows(static, 1)
    packed = torch.cat([s.qpos.t(), s.qvel.t(), s.ctrl.t(), s.act.t(), s.qacc.t()]).contiguous()
    assert packed.shape == (n_in, B)
    out, scratch = torch.zeros((n_out, B)), torch.zeros((n_scratch, B))
    assert lib.megastep_host_f32(packed.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, 1,
                                 1) == 0
    got, _traj = ms._unpack(static, out, s, s.ctrl, 1)
    for name in ("qpos", "qvel", "qacc", "xpos", "xquat", "actuator_force",
                 "contact_sensordata"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    frozen = ms.megastep_plain(ms._Static(dataclasses.replace(model, solver_exact=False)), s)
    assert not torch.equal(frozen.qacc, want.qacc)


def test_megastep_refuses_worlds_without_candidates():
    """K2 takes a world without contact candidates (slice g.1: the tethered
    motor fly, whose hard weld compiles to none; qacc is the tree solve of
    Mh alone) and compressed pair rows on a heightfield (slice g.2), when
    asked for on the CPU; the engine step by default there. What it refuses,
    when asked for and by default, is what JAX's gate refuses on features:
    the PGS solver and welds."""
    tethered = load_compiled(TETHERED_FLY)
    assert tethered.model.ncand == 0 and ms.megastep_supported(tethered.model)
    assert BatchSimulation(tethered, 2, device="cpu", megastep=True).megastep
    assert ms.make_megastep(tethered.model).static.ncand == 0
    full = load_compiled(TWOFLY_FULL)
    assert ms.megastep_supported(full.model)
    grid = dataclasses.replace(full, model=dataclasses.replace(full.model, has_hfield=True))
    assert ms.megastep_supported(grid.model)
    assert not BatchSimulation(grid, 2, device="cpu").megastep
    for name in ("pgs_fly", "softweld_fly"):
        bad = load_compiled(ASSETS / f"{name}.npz")
        assert not ms.megastep_supported(bad.model), name
        with pytest.raises(NotImplementedError, match="mega-step"):
            BatchSimulation(bad, 2, device="cpu", megastep=True)
        with pytest.raises(NotImplementedError, match="mega-step"):
            ms.make_megastep(bad.model)
    # Without asking for it, an unsupported model takes the engine step.
    assert not BatchSimulation(bad, 2, device="cpu").megastep


@pytest.fixture
def cuda_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return load_compiled().model.to("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_worlds, k_steps", [(1000, 1), (4096, 1), (1000, 8)])
def test_kernel_matches_plain(cuda_model, golden, n_worlds, k_steps):
    """K2 against its plain version on the card, at the first replay steps;
    the bars of ``tests/engine/test_megastep.py:120-145``."""
    compiled = load_compiled()
    idx = torch.arange(n_worlds) % golden["targets"].shape[0]
    state = golden["state"].map(lambda x: x[idx].clone())
    seq = torch.stack([
        _with_targets(state, compiled, golden["targets"][idx.numpy(), i]).ctrl
        for i in range(k_steps)
    ]).cuda()
    state = dataclasses.replace(state.to("cuda"), ctrl=seq[0])
    fn = ms.make_megastep(cuda_model, k_steps)
    before = ms.launches["megastep"]
    if k_steps == 1:
        got, want = fn(state), ms.megastep_plain(fn.static, state)
    else:
        (got, traj), (want, wtraj) = fn(state, seq), ms.megastep_plain(fn.static, state, seq)
        assert (traj - wtraj).abs().max() <= 1e-6 + 2e-4 * cuda_model.timestep
    torch.cuda.synchronize()
    assert ms.launches["megastep"] == before + 1
    gap = lambda f: (getattr(got, f) - getattr(want, f)).abs()
    assert gap("xpos").max() <= 1e-5
    assert gap("qpos").max() <= 1e-6 + 2e-4 * cuda_model.timestep
    assert gap("qvel").max() <= 1e-3
    assert (gap("qacc") <= 0.2 + 6e-3 * want.qacc.abs()).all()
    assert gap("actuator_force").max() <= 1e-4
    assert (got.contact_sensordata - want.contact_sensordata)[..., :4].abs().max() <= 2e-3

