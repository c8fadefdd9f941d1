"""Contact dimensionality (condim 1, 4 and 6) in the port against the JAX
package: the pyramid rows and the rotational Jacobian, the engine step and
its contact sensors, MuJoCo's condim-6 rolling sphere, the plain emitter
against JAX's ``emit_step``, K2's source built with g++ against the plain
emitter, and the benchmark fly's goldens at condim 1, 4 and 6.

The small world is built here: a free sphere on two sprung, hinged capsule
legs whose tips stand on the ground plane, one contact pair per leg at the
condim under test, and a contact sensor on the first leg. Its hinge axes
are tilted, so that each rotational row (torsion, rolling) has nonzero
entries. The same world stands on a tilted heightfield too, where each
candidate's rows lie in the sampled plane's frame rather than the world's.
It settles 300 JAX engine steps; the inputs are that state with seeded
joint velocities (numpy) added. The JAX emitter runs eagerly on (B,)
arrays.
JAX is imported inside the fixtures and tests that need it, so the
``cuda`` test runs on a machine with the card and PyTorch only::

    python -m pytest --noconftest tests/test_torch_condim.py -m cuda
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu_torch import load_compiled, model_from_numpy
from flygym_tpu_torch.compose.bridge import ASSETS, _read_npz, load_actuator_golden
from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE
from flygym_tpu_torch.engine import contact
from flygym_tpu_torch.engine.model import State
from flygym_tpu_torch.engine.step import step as engine_step
from flygym_tpu_torch.ops import _build
from flygym_tpu_torch.ops import megastep as ms

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONDIMS = [1, 4, 6]
GROUNDS = ("plane", "hfield")
B = 2
SETTLE_STEPS = 300
ENGINE_STEPS = 5
# The engine step against the jitted JAX engine: XLA fuses multiply-adds
# (ROADMAP queue 3 item 1), so the two part by float32 rounding. Measured on
# this world over 5 steps: qpos <= 4e-9, qvel <= 1e-6 (of up to ~100),
# sensors <= 1.2e-5 (of ~58); the bars sit ~10x above.
ENGINE_TOL = {"qpos": 1e-6, "qvel": 1e-4, "sensordata": 1e-4}


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _legged_spec(condim: int, ground: str = "plane"):
    """A free sphere on two sprung, hinged capsule legs, tips 0.5 µm above
    the ground, one pair per leg at ``condim``; with ``ground="hfield"`` the
    ground is a heightfield tilted by 0.05 along x and -0.03 along y (the
    legs' tips start 0.5 µm above its highest point under them)."""
    from flygym_tpu.compose.spec import (
        BodySpec, ContactSensorSpec, GeomSpec, JointSpec, ModelSpec, PairSpec)

    spec = ModelSpec("legged")
    spec.world_geoms.append(GeomSpec(name="ground", type="plane", size=(100.0, 100.0, 1.0)))
    lift = 0.0
    if ground == "hfield":
        yy, xx = np.mgrid[0:9, 0:9]
        x, y = -2.0 + 0.5 * xx, -2.0 + 0.5 * yy
        spec.hfield = {"data": (0.05 * x - 0.03 * y).astype(np.float32), "xy0": (-2.0, -2.0),
                       "cell": (0.5, 0.5)}
        lift = 0.01
    torso = BodySpec(name="torso", parent=None, pos=(0.0, 0.0, 0.5505 + lift))
    torso.add_joint(JointSpec(name="root", type="free"))
    torso.add_geom(GeomSpec(name="torso_geom", type="sphere", size=(0.2,), mass=1e-2))
    spec.add_body(torso)
    for i, (x, axis) in enumerate(((0.2, (0.3, 1.0, 0.2)), (-0.2, (0.2, 1.0, -0.3)))):
        leg = BodySpec(name=f"leg{i}", parent="torso", pos=(x, 0.0, 0.0))
        n = np.linalg.norm(axis)
        leg.add_joint(JointSpec(name=f"hinge{i}", axis=tuple(a / n for a in axis),
                                stiffness=1.0, damping=1e-2))
        leg.add_geom(GeomSpec(name=f"leg{i}_geom", type="capsule", size=(0.05, 0.25),
                              pos=(0.0, 0.0, -0.25), mass=1e-3))
        spec.add_body(leg)
        spec.pairs.append(PairSpec(geom1=f"leg{i}_geom", geom2="ground", condim=condim,
                                   friction=(1.0, 1.0, 0.05, 0.02, 0.02), margin=1e-3))
    spec.contact_sensors.append(ContactSensorSpec(name="s0", subtree_body="leg0",
                                                  geom2="ground"))
    return spec


@pytest.fixture(scope="module")
def worlds():
    """condim, or (condim, "hfield"), -> (JAX model, the settled batch of B
    worlds as the port's State, the port's compiled model)."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.engine.model import make_initial_state
    from flygym_tpu.engine.step import step as jstep

    flatten = _script("export_taxis_golden").flatten
    out = {}
    for condim, ground in [(c, g) for g in GROUNDS for c in CONDIMS]:
        compiled = _legged_spec(condim, ground).compile()
        state = make_initial_state(compiled.model)
        vstep = jax.jit(jax.vmap(jstep, in_axes=(None, 0)))
        jst = jax.tree.map(lambda x: jnp.stack([x] * B), state)
        for _ in range(SETTLE_STEPS):
            jst = vstep(compiled.model, jst)
        settled = State(**{f.name: torch.tensor(np.asarray(getattr(jst, f.name)))
                           for f in dataclasses.fields(State)})
        out[condim if ground == "plane" else (condim, ground)] = (
            compiled.model, settled, model_from_numpy(*flatten(compiled.model, state)))
    return out


def _seeded_state(worlds, condim, seed: int = 0) -> State:
    """The settled worlds with seeded joint velocities in ±0.5 added, so
    that the friction rows slide."""
    _jmodel, settled, port = worlds[condim]
    rng = np.random.default_rng(seed)
    dv = rng.uniform(-0.5, 0.5, tuple(settled.qvel.shape)).astype(np.float32)
    return dataclasses.replace(settled, qvel=settled.qvel + torch.from_numpy(dv))


def _jax_state(state: State):
    import jax.numpy as jnp

    from flygym_tpu.engine.model import State as JaxState

    return JaxState(**{f.name: jnp.asarray(getattr(state, f.name).numpy())
                       for f in dataclasses.fields(JaxState)})


@pytest.mark.parametrize("condim", CONDIMS)
def test_rows_and_jacobians_match_jax(worlds, condim):
    """The pyramid rows and the rotational Jacobian on seeded inputs: the
    rows bit for bit (the same elementwise products and sums), the
    Jacobian's three-term contraction to 1e-6."""
    import jax.numpy as jnp

    from flygym_tpu.engine import contact as jc

    jmodel, _state, port = worlds[condim]
    model = port.model
    rng = np.random.default_rng(condim)
    K, nv = 3, model.nv
    J = rng.standard_normal((B, K, 3, nv)).astype(np.float32)
    J_ang = rng.standard_normal((B, K, 3, nv)).astype(np.float32)
    fric = rng.uniform(0.01, 1.0, (B, K, 3)).astype(np.float32)
    want = np.stack([np.asarray(jc._pyramid_rows(jnp.asarray(J[b]), jnp.asarray(J_ang[b]),
                                                 jnp.asarray(fric[b]), condim))
                     for b in range(B)])
    got = contact._pyramid_rows(torch.from_numpy(J), torch.from_numpy(J_ang),
                                torch.from_numpy(fric), condim)
    assert got.shape == (B, K, contact.n_pyramid_rows(condim), nv)
    assert contact.n_pyramid_rows(condim) == jc.n_pyramid_rows(condim)
    np.testing.assert_array_equal(got.numpy(), want)

    S = rng.standard_normal((B, nv, 6)).astype(np.float32)
    frame = rng.standard_normal((B, K, 3, 3)).astype(np.float32)
    body = rng.integers(1, model.nbody, (B, K))
    body2 = np.zeros((B, K), np.int64)
    want = np.stack([np.asarray(jc._contact_jacobian_ang(
        jmodel, jnp.asarray(body[b]), jnp.asarray(S[b]), jnp.asarray(frame[b]),
        jnp.asarray(body2[b]))) for b in range(B)])
    got = contact._contact_jacobian_ang(model, torch.from_numpy(body), torch.from_numpy(S),
                                        torch.from_numpy(frame), torch.from_numpy(body2))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert np.abs(want).max() > 0.1


@pytest.mark.parametrize("condim", CONDIMS)
def test_engine_step_matches_jax(worlds, condim):
    """Chained engine steps with their contact sensors against the jitted
    JAX engine (``ENGINE_TOL``); at condim 1 the sensors' tangential force
    is 0 on both sides."""
    _engine_steps_match_jax(worlds, condim, condim)


@pytest.mark.parametrize("condim", CONDIMS)
def test_engine_step_on_a_heightfield_matches_jax(worlds, condim):
    """As :func:`test_engine_step_matches_jax` on the tilted heightfield,
    whose contact frames are the sampled planes'."""
    assert worlds[condim, "hfield"][2].model.has_hfield
    _engine_steps_match_jax(worlds, (condim, "hfield"), condim)


def _engine_steps_match_jax(worlds, key, condim: int) -> None:
    import jax

    from flygym_tpu.engine.step import step as jstep

    jmodel, _state, port = worlds[key]
    assert port.model.condim == condim
    vstep = jax.jit(jax.vmap(jstep, in_axes=(None, 0)))
    state = _seeded_state(worlds, key)
    jst = _jax_state(state)
    for _ in range(ENGINE_STEPS):
        jst = vstep(jmodel, jst)
        state = engine_step(port.model, state)
        for name, field in (("qpos", "qpos"), ("qvel", "qvel"),
                            ("sensordata", "contact_sensordata")):
            gap = np.abs(getattr(state, field).numpy() - np.asarray(getattr(jst, field))).max()
            assert gap <= ENGINE_TOL[name], (name, gap)
    sens = state.contact_sensordata.numpy()
    assert (sens[:, 0, 0] == 1.0).all()  # the first leg touches
    if condim == 1:
        np.testing.assert_array_equal(sens[:, 0, 2:4], 0.0)
        np.testing.assert_array_equal(np.asarray(jst.contact_sensordata)[:, 0, 2:4], 0.0)


def test_condim6_rolling_sphere_matches_jax():
    """``tests/engine/test_golden_mujoco.py:379-428``'s sphere, spun about y
    at condim 6, rolls along +x while rolling friction brings it to rest:
    200 settling steps, then 600 after the spin, through the JAX engine and
    the port's. The displacement and the angular speed agree within 1e-4
    mm and 1e-3 rad/s (measured ~1e-6 and ~1e-5)."""
    import jax

    from flygym_tpu.compose.spec import BodySpec, GeomSpec, JointSpec, ModelSpec, PairSpec
    from flygym_tpu.engine.model import make_initial_state
    from flygym_tpu.engine.step import step as jstep

    spec = ModelSpec("roll_world")
    spec.world_geoms.append(GeomSpec(name="ground", type="plane", size=(100.0, 100.0, 1.0)))
    body = BodySpec(name="ball", parent=None)
    body.add_joint(JointSpec(name="ballfree", type="free"))
    body.add_geom(GeomSpec(name="ballgeom", type="sphere", size=(0.5,), mass=1e-3))
    spec.add_body(body)
    spec.pairs.append(PairSpec(geom1="ballgeom", geom2="ground", condim=6,
                               friction=(1.0, 1.0, 0.05, 0.01, 0.01), solref=(2e-4, 1.0),
                               solimp=(0.9, 0.95, 1e-3, 0.5, 2.0), margin=1e-3))
    spec.neutral_joint_qpos["ballfree"] = [0, 0, 0.6, 1, 0, 0, 0]
    compiled = spec.compile()
    jst = make_initial_state(compiled.model)
    port = model_from_numpy(*_script("export_taxis_golden").flatten(compiled.model, jst))
    st = port.initial_state
    step = jax.jit(jstep)
    for i in range(800):
        if i == 200:
            jst = dataclasses.replace(jst, qvel=jst.qvel.at[4].set(20.0))
            qvel = st.qvel.clone()
            qvel[0, 4] = 20.0
            st = dataclasses.replace(st, qvel=qvel)
        jst = step(compiled.model, jst)
        st = engine_step(port.model, st)
    x_jax, x_port = float(jst.qpos[0]), float(st.qpos[0, 0])
    w_jax = float(np.linalg.norm(np.asarray(jst.qvel)[3:6]))
    w_port = float(st.qvel[0, 3:6].norm())
    assert x_jax > 0.05 and w_jax < 15.0  # it rolled, and the spin decayed
    assert abs(x_port - x_jax) <= 1e-4, (x_port, x_jax)
    assert abs(w_port - w_jax) <= 1e-3, (w_port, w_jax)


def _jax_emitter_step(jmodel, state: State, planes=None) -> dict:
    import jax.numpy as jnp

    from flygym_tpu.ops import megastep as jms

    cols = lambda x: [jnp.asarray(x.numpy()[:, i]) for i in range(x.shape[1])]
    pack = lambda lst: np.stack([np.asarray(x) for x in lst], axis=1)
    ter = None if planes is None else [tuple(jnp.asarray(planes[:, c, k].numpy())
                                             for k in range(4)) for c in range(planes.shape[1])]
    r = jms.emit_step(jms._Static(jmodel), cols(state.qpos), cols(state.qvel), cols(state.ctrl),
                      cols(state.act), cols(state.qacc), ter)
    return {"qpos": pack(r["qpos"]), "qvel": pack(r["qvel"]), "qacc": pack(r["qacc"]),
            "contact_sensordata": np.stack([pack(s) for s in r["sensordata"]], axis=1)}


def _planes(port, state: State):
    """The ground planes under the candidates (the port's sampler, as K2's
    wrapper takes them), or None on flat ground."""
    fn = ms.make_megastep(port.model)
    return None if fn.sample_planes is None else fn.sample_planes(state)


@pytest.mark.parametrize("condim", CONDIMS)
def test_plain_emitter_matches_jax_emit_step(worlds, condim):
    """The plain emitter against JAX's ``emit_step`` on the same state: 0
    gaps in qpos, qvel, qacc and the sensors."""
    _emitters_agree(worlds, condim)


@pytest.mark.parametrize("condim", CONDIMS)
def test_plain_emitter_on_a_heightfield_matches_jax_emit_step(worlds, condim):
    """As :func:`test_plain_emitter_matches_jax_emit_step` on the tilted
    heightfield, both emitters given the same sampled planes: the rows, the
    rotational components and the sensors' forces in each plane's frame.
    The frames are tilted (the normals' x and y are not 0)."""
    planes = _emitters_agree(worlds, (condim, "hfield"))
    assert planes[..., 1:3].abs().min() > 0.01


def _emitters_agree(worlds, key):
    jmodel, _state, port = worlds[key]
    assert ms.megastep_supported(port.model)
    state = _seeded_state(worlds, key)
    planes = _planes(port, state)
    want = _jax_emitter_step(jmodel, state, planes)
    got = ms.megastep_plain(ms._Static(port.model), state, None, planes)
    for name, value in want.items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), value, err_msg=name)
    assert np.abs(want["contact_sensordata"][:, 0, 1]).max() > 0  # a normal force
    return planes


@pytest.mark.parametrize("order", [0, 1], ids=["in_order", "reversed"])
@pytest.mark.parametrize("condim", CONDIMS)
def test_host_build_of_the_kernel_matches_plain(worlds, condim, order):
    """K2's source with this condim's header (NROWS 1, 6 or 10) compiled as
    host C++ with g++, the block's parallel loops in order and reversed,
    against the plain emitter: 0 gaps."""
    _host_build_matches_plain(worlds, condim, condim, order)


@pytest.mark.parametrize("order", [0, 1], ids=["in_order", "reversed"])
@pytest.mark.parametrize("condim", CONDIMS)
def test_host_build_on_a_heightfield_matches_plain(worlds, condim, order):
    """As :func:`test_host_build_of_the_kernel_matches_plain` with the
    terrain header on the tilted heightfield, the sampled planes packed
    after the state: 0 gaps."""
    _host_build_matches_plain(worlds, (condim, "hfield"), condim, order)


def _host_build_matches_plain(worlds, key, condim: int, order: int) -> None:
    _jmodel, _state, port = worlds[key]
    static = ms._Static(port.model)
    header, n_scratch = ms.model_header(port.model)
    assert f"constexpr int NROWS = {contact.n_pyramid_rows(condim)};" in header
    assert ("#define MS_HFIELD 1" in header) == port.model.has_hfield
    lib = _build.build_megastep_host(header)
    s = _seeded_state(worlds, key)
    planes = _planes(port, s)
    want = ms.megastep_plain(static, s, None, planes)
    n_in, n_out = ms._io_rows(static, 1)
    parts = [s.qpos.t(), s.qvel.t(), s.ctrl.t(), s.act.t(), s.qacc.t()]
    if planes is not None:
        parts.append(planes.reshape(B, -1).t())
    packed = torch.cat(parts).contiguous()
    assert packed.shape == (n_in, B)
    out = torch.zeros((n_out, B))
    scratch = torch.zeros((n_scratch, B))
    assert lib.megastep_host_f32(packed.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, 1,
                                 order) == 0
    got, _traj = ms._unpack(static, out, s, s.ctrl, 1)
    for name in ("qpos", "qvel", "qacc", "xpos", "contact_sensordata"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_pair_rows_at_other_condims_stay_on_the_engine_step(worlds):
    """K2 takes ground rows and fly-fly pair rows at every condim: this
    file's worlds, example 11's world compiled at condim 6
    (``twofly_condim6.npz``, 10 rows on every candidate) and the two-fly
    world read at condim 4. What it still refuses at any condim: a pair row
    that carries a contact sensor or an adhesion actuator, which only a
    hand-made model has (every compile fills pair rows with -1 there)."""
    from flygym_tpu_torch.compose.bridge import TWOFLY, TWOFLY_CONDIM6

    arrays, meta = _read_npz(TWOFLY)
    meta["model"]["condim"] = 4
    at4 = model_from_numpy(arrays, meta).model
    condim6 = load_compiled(TWOFLY_CONDIM6).model
    assert condim6.condim == 6 and condim6.ncand_pair == 49
    assert ms.megastep_supported(at4) and ms.megastep_supported(condim6)
    assert ms.model_header(condim6)[0].count("constexpr int NROWS = 10;") == 1
    assert all(ms.megastep_supported(worlds[c][2].model) for c in CONDIMS)
    last = condim6.ncand - 1
    for field in ("can_sensor", "can_adh_act"):
        values = getattr(condim6, field).clone()
        values[last] = 0
        assert not ms.megastep_supported(dataclasses.replace(condim6, **{field: values})), field


# ---------------------------------------------------------------------------
# The benchmark fly at condim 1, 4 and 6 (scripts/export_taxis_golden.py)
# ---------------------------------------------------------------------------


def _fly(condim: int):
    return (load_compiled(ASSETS / f"condim{condim}_fly.npz"),
            load_actuator_golden(ASSETS / f"condim{condim}_fly_golden.npz"))


@pytest.mark.parametrize("condim", CONDIMS)
def test_condim_fly_is_the_benchmark_fly_at_its_condim(condim):
    compiled, golden = _fly(condim)
    bench = load_compiled()
    model = compiled.model
    assert model.condim == condim and model.ncand == bench.model.ncand == 110
    assert model.can_invweight.shape == (110, contact.n_pyramid_rows(condim))
    assert compiled.flies.keys() == bench.flies.keys()
    assert golden["meta"]["settle_steps"] == 2500
    for name in ("qpos0", "body_mass", "can_solref"):
        assert torch.equal(getattr(model, name), getattr(bench.model, name)), name


@pytest.mark.parametrize("condim", CONDIMS)
def test_condim_golden_first_step(condim):
    """The first recorded step from the golden's settled state: the plain
    emitter equals the JAX emitter's record bit for bit, and the engine step
    is within the benchmark golden's ``GOLDEN_TOLERANCE`` of the JAX
    engine's (measured qvel 4.7e-4 at condim 6)."""
    compiled, golden = _fly(condim)
    state = golden["state"].map(lambda x: x[:B].clone())
    state = dataclasses.replace(state, ctrl=torch.from_numpy(golden["ctrl"][0, :B]))
    got = ms.megastep_plain(ms._Static(compiled.model), state)
    for name, field in (("qpos", "qpos"), ("qvel", "qvel"), ("sensordata", "contact_sensordata")):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      golden["emitter"][name][0, :B], err_msg=name)
    eng = engine_step(compiled.model, state)
    for name in ("qpos", "qvel"):
        gap = np.abs(getattr(eng, name).numpy() - golden["engine"][name][0, :B]).max()
        assert gap <= GOLDEN_TOLERANCE[name], (name, gap)
    assert (golden["emitter"]["sensordata"][0, :B, :, 0] == 1.0).sum() >= 6


@pytest.mark.parametrize("condim", CONDIMS)
def test_committed_condim_world_equals_a_fresh_export(condim):
    import flygym_tpu

    name = f"condim{condim}_fly"
    exporter = _script("export_torch_model")
    fly, world = _script("export_taxis_golden").build_world(name)
    arrays, meta = exporter.export(world, flygym_tpu.Simulation(world))
    committed, committed_meta = _read_npz(ASSETS / f"{name}.npz")
    assert sorted(committed) == sorted(arrays)
    for key, value in arrays.items():
        np.testing.assert_array_equal(committed[key], value, err_msg=key)
    assert committed_meta == json.loads(json.dumps(meta))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("condim", CONDIMS)
def test_kernel_matches_plain(cuda_device, condim):
    """K2 with the condim-1, -4 and -6 headers against its plain version on
    the card at the golden's settled worlds and controls, K = 1 and K = 4:
    0 gaps."""
    compiled, golden = _fly(condim)
    model = compiled.model.to(cuda_device)
    state = golden["state"].to(cuda_device)
    seq = torch.as_tensor(golden["ctrl"][:4], device=cuda_device)
    state = dataclasses.replace(state, ctrl=seq[0])
    for k in (1, 4):
        fn = ms.make_megastep(model, k)
        before = ms.launches["megastep"]
        if k == 1:
            got, want = fn(state), ms.megastep_plain(fn.static, state)
        else:
            (got, traj), (want, wtraj) = fn(state, seq), ms.megastep_plain(fn.static, state, seq)
            assert torch.equal(traj, wtraj)
        torch.cuda.synchronize()
        assert ms.launches["megastep"] == before + 1
        for name in ("qpos", "qvel", "qacc", "contact_sensordata"):
            assert torch.equal(getattr(got, name), getattr(want, name)), (k, name)
