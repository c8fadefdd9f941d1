"""Compressed fly-fly pair rows in the port, against the JAX package.

Two presets, written by ``scripts/export_compressed_golden.py``: the default
two-fly contact preset (55 x 55 pair rows compressed to 55 rows,
``flygym_tpu_torch/assets/twofly_full.npz``) and the 3-fly pile (21 groups
of 7, ``threefly.npz``), each with a golden of 8 settled worlds and 16 steps
of the JAX emitter, fed the JAX winner sampler's winners, and of the JAX
engine with its conditioning probe. Example 11's world with its 49 pair rows
compressed to 7 groups of 7 is small enough to run the eager JAX emitter
live. The plain emitter, K2's host build and the winner sampler repeat the
JAX package's operations and are held to the last bit; the engine step to
the golden's probe floors.

The ``cuda`` tests at the end run on a machine with the card and PyTorch
only::

    python -m pytest --noconftest tests/test_torch_compress.py -m cuda
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu_torch import BatchSimulation
from flygym_tpu_torch.compose.bridge import (
    THREEFLY,
    THREEFLY_GOLDEN,
    TWOFLY,
    TWOFLY_FULL,
    TWOFLY_FULL_GOLDEN,
    _read_npz,
    load_compiled,
    load_twofly_golden,
    model_from_numpy,
)
from flygym_tpu_torch.engine import contact
from flygym_tpu_torch.engine.kinematics import forward_kinematics
from flygym_tpu_torch.engine.step import step
from flygym_tpu_torch.ops import _build, ldl
from flygym_tpu_torch.ops import megastep as ms

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
B = 2
FIELDS = ("qpos", "qvel", "qacc", "xpos", "xquat", "actuator_force", "contact_sensordata")
PRESETS = {"twofly_full": (TWOFLY_FULL, TWOFLY_FULL_GOLDEN), "threefly": (THREEFLY, THREEFLY_GOLDEN)}
# The engine step against the JAX engine: the floors of the conditioning
# probe's bar (tests/tpu/test_megastep_tpu.py:436-437).
PROBE_FLOOR = {"qpos": 3e-5, "qvel": 5e-2}


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def exporter():
    return _load_script("export_compressed_golden")


@pytest.fixture(scope="module")
def fresh(exporter):
    """Per preset (world, JAX simulation, arrays, meta) of a fresh export."""
    return {name: exporter.export_model(name) for name in PRESETS}


@pytest.fixture(scope="module")
def compiled():
    return {name: load_compiled(path) for name, (path, _g) in PRESETS.items()}


@pytest.fixture(scope="module")
def goldens():
    return {name: load_twofly_golden(g) for name, (_p, g) in PRESETS.items()}


def _example11_compressed():
    """Example 11's world (49 pair rows) with ``pair_compress`` on: 7 groups
    of 7, in the port and in the JAX package."""
    arrays, meta = _read_npz(TWOFLY)
    meta["model"]["pair_compress"] = True
    world = _load_script("export_twofly_golden").build_world()
    world._spec.options["pair_compress"] = True
    jax_model, _state = world.compile()
    return model_from_numpy(arrays, meta).model, jax_model


@pytest.fixture(scope="module")
def example11():
    return _example11_compressed()


@pytest.mark.parametrize("name", list(PRESETS))
def test_committed_compressed_assets_equal_a_fresh_export(fresh, name):
    _world, _sim, arrays, meta = fresh[name]
    committed, committed_meta = _read_npz(PRESETS[name][0])
    assert sorted(committed) == sorted(arrays)
    for key, value in arrays.items():
        np.testing.assert_array_equal(committed[key], value, err_msg=key)
    assert committed_meta == json.loads(json.dumps(meta))


def test_presets_load_compressed(compiled):
    full, pile = compiled["twofly_full"].model, compiled["threefly"].model
    assert (full.nbody, full.nq, full.nv, full.nu, full.ncand, full.ncand_pair, full.ncon) == (
        139, 146, 144, 12, 3245, 3025, 32)
    assert full.pair_compress and [size for _s, size in full.pair_groups] == [55] * 55
    assert (pile.nv, pile.nu, pile.nsensor_contact, pile.ncand_pair) == (216, 0, 18, 147)
    assert pile.pair_compress and [size for _s, size in pile.pair_groups] == [7] * 21
    for m in (full, pile):
        assert ms.megastep_supported(m)
    header, n_scratch = ms.model_header(full)
    assert "#define MS_PAIRS_COMPRESSED 1" in header and "constexpr int NPAIR = 55;" in header
    assert "constexpr int N_AUX = 55;" in header and n_scratch == 44527
    st = ms._Static(full)
    assert (st.ncand, st.ncand_pair) == (275, 55)


def _spec_key(specs):
    return [(g["row0"], g["members"], g["invw"], g["r2"], g["h2"], g["dof_sign_spec"],
             g["listed"], g["dof_sign_idx"]) for g in specs]


@pytest.mark.parametrize("name", ["twofly_full", "threefly", "example11"])
def test_pair_group_specs_equal_jax(fresh, compiled, example11, name):
    from flygym_tpu.ops import megastep as jms

    if name == "example11":
        model, jax_model = example11
        assert [size for _s, size in model.pair_groups] == [7] * 7
    else:
        model, jax_model = compiled[name].model, fresh[name][1].model
    specs, keep = ms._pair_group_specs(model)
    jspecs, jkeep = jms._pair_group_specs(jax_model)
    assert _spec_key(specs) == _spec_key(jspecs)
    np.testing.assert_array_equal(keep, jkeep)
    # The kernel walks geom1's path and the winner's, in the emitter's order.
    assert ms._winner_paths_ok(ms._Static(model))


def _jax_pair_distances(jax_model, xpos, xquat):
    """The JAX winner sampler's distances (``contact.py:234-249``), eager."""
    import jax.numpy as jnp

    from flygym_tpu.engine.contact import _segseg_closest
    from flygym_tpu.engine.maths import quat_mul, quat_rotate

    m = jax_model
    ng = m.ncand - m.ncand_pair
    g1, g2 = m.can_geom[ng:], m.can_geom2[ng:]
    up = jnp.array([0.0, 0.0, 1.0], jnp.float32)
    xpos, xquat = jnp.asarray(xpos), jnp.asarray(xquat)

    def frame(g):
        b = m.geom_body[g]
        return (xpos[:, b] + quat_rotate(xquat[:, b], m.geom_pos[g]),
                quat_rotate(quat_mul(xquat[:, b], m.geom_quat[g]), up))

    (p1, z1), (p2, z2) = frame(g1), frame(g2)
    h1, h2 = m.geom_size[g1, 1][None, :, None], m.geom_size[g2, 1][None, :, None]
    s1, s2 = _segseg_closest(p1 - h1 * z1, p1 + h1 * z1, p2 - h2 * z2, p2 + h2 * z2)
    return np.asarray(jnp.linalg.norm(s1 - s2, axis=-1) - m.geom_size[g1, 0] - m.geom_size[g2, 0])


def _seeded_poses(c, n=16, seed=0):
    rng = np.random.default_rng(seed)
    qpos = c.initial_state.qpos.expand(n, -1).clone()
    qpos += torch.from_numpy(rng.normal(size=qpos.shape).astype(np.float32)) * 0.05
    return forward_kinematics(c.model, qpos)


@pytest.mark.parametrize("poses", ["golden", "seeded"])
@pytest.mark.parametrize("name", list(PRESETS))
def test_winner_sampler_equals_jax(fresh, compiled, goldens, name, poses):
    """Distances to the last bit, and the same winners."""
    import jax.numpy as jnp

    from flygym_tpu.engine.contact import make_pair_winner_sampler as jax_sampler

    c, jax_model = compiled[name], fresh[name][1].model
    if poses == "golden":
        xpos, xquat = goldens[name]["state"].xpos, goldens[name]["state"].xquat
    else:
        xpos, xquat = _seeded_poses(c)
    sample = contact.make_pair_winner_sampler(c.model)
    np.testing.assert_array_equal(sample.distances(xpos, xquat).numpy(),
                                  _jax_pair_distances(jax_model, xpos.numpy(), xquat.numpy()))
    want = np.asarray(jax_sampler(jax_model)(jnp.asarray(xpos.numpy()), jnp.asarray(xquat.numpy())))
    before = contact.samples["winners"]
    got = sample(xpos, xquat)
    assert contact.samples["winners"] == before + 1 and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if poses == "golden":  # the JAX emitter's first winners
        np.testing.assert_array_equal(got.numpy(), goldens[name]["emitter"]["widx"][0])


def _jax_emit(jax_model, state, widx):
    """One eager JAX emitter step with pinned winners, packed (B, ...)."""
    import jax.numpy as jnp

    from flygym_tpu.ops import megastep as jms

    cols = lambda x: [jnp.asarray(np.asarray(x)[:, i]) for i in range(np.asarray(x).shape[1])]
    pack = lambda lst: np.stack([np.asarray(x) for x in lst], axis=1)
    r = jms.emit_step(jms._Static(jax_model), *(cols(getattr(state, k).numpy())
                      for k in ("qpos", "qvel", "ctrl", "act", "qacc")), None, cols(widx))
    return dict(
        qpos=pack(r["qpos"]), qvel=pack(r["qvel"]), qacc=pack(r["qacc"]),
        xpos=np.stack([pack(v) for v in r["xpos"]], axis=1),
        xquat=np.stack([pack(v) for v in r["xquat"]], axis=1),
        actuator_force=pack(r["actuator_force"]),
        contact_sensordata=np.stack([pack(v) for v in r["sensordata"]], axis=1),
    )


@pytest.fixture(scope="module")
def example11_first(example11):
    """Example 11's settled worlds (``twofly_golden.npz``), winners from the port's
    sampler: one plain step and one eager JAX emitter step."""
    model, jax_model = example11
    state = load_twofly_golden()["state"].map(lambda x: x[:B].clone())
    widx = contact.make_pair_winner_sampler(model)(state.xpos, state.xquat)
    plain = ms.megastep_plain(ms._Static(model), state, None, widx)
    return plain, _jax_emit(jax_model, state, widx.numpy()), state, widx


@pytest.mark.parametrize("name", FIELDS)
def test_plain_emitter_equals_jax_emit_step_on_compressed_rows(example11_first, name):
    """Live, to the last bit, on example 11's world compressed to 7 groups."""
    plain, want, _state, widx = example11_first
    assert (widx.numpy() > 0).any()  # not every group's first member
    got = getattr(plain, name).numpy()
    assert got.shape == want[name].shape
    np.testing.assert_array_equal(got, want[name])


@pytest.fixture(scope="module")
def golden_first(compiled, goldens):
    """Per preset the plain version's first step from the golden's settled
    worlds with the JAX emitter's stored winners."""
    out = {}
    for name, c in compiled.items():
        g = goldens[name]
        state = g["state"].map(lambda x: x[:B].clone())
        widx = torch.from_numpy(g["emitter"]["widx"][0][:B])
        out[name] = (state, widx, ms.megastep_plain(ms._Static(c.model), state, None, widx))
    return out


@pytest.mark.parametrize("name", list(PRESETS))
def test_plain_emitter_equals_the_stored_jax_emitter(goldens, golden_first, name):
    want = goldens[name]["emitter"]
    _state, _widx, plain = golden_first[name]
    for key in ("qpos", "qvel", "sensordata"):
        got = (plain.contact_sensordata if key == "sensordata" else getattr(plain, key)).numpy()
        np.testing.assert_array_equal(got, want[key][0][:B], err_msg=key)


@pytest.mark.parametrize("order", [0, 1], ids=["in_order", "reversed"])
@pytest.mark.parametrize("name", list(PRESETS))
def test_host_build_with_compressed_rows_equals_plain(compiled, golden_first, name, order):
    """K2's source with the compressed header, compiled as host C++ (g++),
    against the plain version, to the last bit, with the block's parallel
    loops run in order and reversed."""
    model = compiled[name].model
    state, widx, plain = golden_first[name]
    st = ms._Static(model)
    header, n_scratch = ms.model_header(model)
    lib = _build.build_megastep_host(header)
    n_in, n_out = ms._io_rows(st, 1)
    s = state
    packed = torch.cat([s.qpos.t(), s.qvel.t(), s.ctrl.t(), s.act.t(), s.qacc.t(),
                        widx.t()]).contiguous()
    assert packed.shape == (n_in, B)
    out, scratch = torch.zeros((n_out, B)), torch.zeros((n_scratch, B))
    assert lib.megastep_host_f32(packed.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, 1,
                                 order) == 0
    got, _traj = ms._unpack(st, out, s, s.ctrl, 1)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(plain, f)), f


def test_winners_out_of_range_are_refused(compiled, goldens):
    model = compiled["threefly"].model
    state = goldens["threefly"]["state"].map(lambda x: x[:B].clone())
    fn = ms.make_megastep(model)
    widx = fn.sample_planes(state)
    for bad in (widx + 7.0, widx - 1.0, widx + 0.5):
        with pytest.raises(ValueError, match="winners"):
            fn(state, bad)
    with pytest.raises(ValueError, match="terrain_planes"):
        fn(state, widx[:, :3])


def test_engine_step_with_pinned_winners_equals_jax(example11):
    """One engine step of example 11's settled worlds compressed to 7
    groups, winners pinned to the sampler's, against the jitted JAX engine
    step with the same winners (``flygym_tpu/engine/step.py:36-41``); with
    its own in-step winners pinned, the port's step repeats its in-step
    choice to the last bit."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.engine.step import step as jax_step

    model, jax_model = example11
    golden = load_twofly_golden()
    state = golden["state"].map(lambda x: x[:B].clone())
    widx = contact.make_pair_winner_sampler(model)(state.xpos, state.xquat)
    from flygym_tpu.engine.model import State as JaxState

    from flygym_tpu_torch.engine.kinematics import geom_poses

    got = step(model, state, widx)
    jstate = JaxState(**{f.name: jnp.asarray(getattr(state, f.name).numpy())
                         for f in dataclasses.fields(state)})
    want = jax.jit(jax.vmap(jax_step, in_axes=(None, 0, 0)))(
        jax_model, jstate, jnp.asarray(widx.numpy()))
    for key in ("qpos", "qvel"):
        gap = np.abs(getattr(got, key).numpy() - np.asarray(getattr(want, key))).max()
        assert gap <= PROBE_FLOOR[key], (key, gap)
    # The step's own choice, from the forward kinematics of its qpos.
    ng = model.ncand - model.ncand_pair
    dist = contact.contact_candidates(model, *geom_poses(model, *forward_kinematics(
        model, state.qpos)))[0]
    own = contact.pair_winners(model, dist[:, ng:])
    free = step(model, state)
    pinned = step(model, state, own)
    for f in FIELDS:
        assert torch.equal(getattr(free, f), getattr(pinned, f)), f


@pytest.mark.parametrize("name", list(PRESETS))
def test_in_step_winners_equal_jax(fresh, compiled, goldens, name):
    """The engine step's own choice (the argmin of each group's distances
    from the step's pose) against the JAX engine's, jitted as its step runs
    it, on the golden's settled worlds: equal but where a group's two
    nearest members lie within 1e-6 mm."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.engine import contact as jcontact
    from flygym_tpu.engine.kinematics import geom_poses as jax_geom_poses

    from flygym_tpu_torch.engine.kinematics import geom_poses

    model, jax_model = compiled[name].model, fresh[name][1].model
    state = goldens[name]["state"]
    ng = model.ncand - model.ncand_pair

    @jax.jit
    def jax_dist(xpos, xquat):
        gp, gq = jax.vmap(jax_geom_poses, in_axes=(None, 0, 0))(jax_model, xpos, xquat)
        return jax.vmap(jcontact.contact_candidates, in_axes=(None, 0, 0))(jax_model, gp, gq)[0]

    jd = np.asarray(jax_dist(jnp.asarray(state.xpos.numpy()), jnp.asarray(state.xquat.numpy())))
    want = contact.pair_winners(model, torch.tensor(jd[:, ng:])).numpy()
    dist = contact.contact_candidates(model, *geom_poses(model, state.xpos, state.xquat))[0]
    got = contact.pair_winners(model, dist[:, ng:]).numpy()
    starts = np.array([s for s, _n in model.pair_groups])
    sizes = {n for _s, n in model.pair_groups}
    assert len(sizes) == 1
    groups = jd[:, ng:][:, starts[:, None] + np.arange(sizes.pop())[None, :]]
    two = np.sort(groups, axis=-1)[..., :2]
    near_tie = (two[..., 1] - two[..., 0]) <= 1e-6
    assert ((got == want) | near_tie).all()
    assert (got == want).mean() > 0.9


def test_each_of_three_flies_has_its_own_getters(compiled):
    c = compiled["threefly"]
    sim = BatchSimulation(c, 3, device="cpu")
    names = ["a", "b", "c"]
    assert c.fly_names == names
    z = []
    for name in names:
        assert sim.get_body_positions(name).shape == (3, 69, 3)
        assert sim.get_joint_angles(name).shape == (3, len(c.flies[name]["qpos_adrs"]))
        z.append(sim.get_body_positions(name)[:, 0, 2])
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            assert not set(c.flies[a]["qpos_adrs"]) & set(c.flies[b]["qpos_adrs"])
    # The flies spawn 1.8 mm apart, bottom to top.
    torch.testing.assert_close(z[1] - z[0], torch.full((3,), 1.8))
    torch.testing.assert_close(z[2] - z[1], torch.full((3,), 1.8))
    sim.rollout(None, 2, record_trajectory=False)
    assert torch.isfinite(sim.state.qpos).all()


def test_megastep_refuses_compressed_rows_on_terrain(compiled):
    """K2 takes compressed pair rows on a heightfield (slice g.2): example
    11's world on the blocks terrain with compressed rows
    (``twofly_terrain.npz``, 7 groups of 7), whose launch reads the kept
    candidates' planes, then the winners, and the default preset read on a
    height grid. It refuses a compressed row that carries a contact sensor,
    which only a hand-made model has."""
    from flygym_tpu_torch.compose.bridge import TWOFLY_TERRAIN

    m = compiled["twofly_full"].model
    grid = dataclasses.replace(m, has_hfield=True)
    assert ms.megastep_supported(m) and ms.megastep_supported(grid)
    terrain = load_compiled(TWOFLY_TERRAIN).model
    assert terrain.has_hfield and terrain.pair_compress and ms.megastep_supported(terrain)
    header = ms.model_header(terrain)[0]
    assert "#define MS_HFIELD 1" in header and "#define MS_PAIRS_COMPRESSED 1" in header
    st = ms.make_megastep(terrain).static
    assert ms._aux_shape(st, 3) == (3, 4 * st.ncand + len(st.pair_comp_groups)) == (3, 915)
    assert header.count("constexpr int N_AUX = 915;") == 1
    sensor = terrain.can_sensor.clone()
    sensor[-1] = 0
    assert not ms.megastep_supported(dataclasses.replace(terrain, can_sensor=sensor))


@pytest.fixture
def cuda_compiled():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return load_compiled(THREEFLY)


@pytest.mark.cuda
def test_kernel_with_compressed_rows_equals_plain(cuda_compiled):
    """K2 on the 3-fly pile against its plain version on the card, at 1000
    worlds, one K = 8 launch with the sampler's winners, to 1e-6 of the
    largest value of each output."""
    golden = load_twofly_golden(THREEFLY_GOLDEN)
    model = cuda_compiled.model.to("cuda")
    idx = torch.arange(1000) % golden["state"].qpos.shape[0]
    state = golden["state"].map(lambda x: x[idx].clone()).to("cuda")
    fn = ms.make_megastep(model, 8)
    widx = fn.sample_planes(state)
    seq = state.ctrl.expand((8,) + tuple(state.ctrl.shape)).contiguous()
    before = ms.launches["megastep"]
    (got, traj), (want, wtraj) = fn(state, seq, widx), ms.megastep_plain(fn.static, state, seq, widx)
    torch.cuda.synchronize()
    assert ms.launches["megastep"] == before + 1
    assert (traj - wtraj).abs().max() <= 1e-6 * wtraj.abs().max()
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if b.numel():
            assert (a - b).abs().max() <= 1e-6 * b.abs().max(), f


@pytest.mark.cuda
def test_compressed_rollout_launch_and_sample_counts():
    """16 steps of the default preset at 64 worlds through the default step
    are 2 K = 8 launches of K2 and 2 winner samples; 4 engine steps are 4
    K1 and 8 K1b launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = load_compiled(TWOFLY_FULL)
    sim = BatchSimulation(c, 64)
    assert sim.megastep
    sim.set_leg_adhesion_states("bottom", torch.ones(6, device="cuda"))
    ms.reset_launches()
    ldl.reset_launches()
    contact.reset_samples()
    sim.rollout(None, 16, record_trajectory=False)
    torch.cuda.synchronize()
    assert ms.launches["megastep"] == 2 and contact.samples["winners"] == 2
    assert ldl.launches["tree_ldl_factor"] == 0
    engine = BatchSimulation(c, 64, megastep=False)
    engine.rollout(None, 4, record_trajectory=False)
    torch.cuda.synchronize()
    assert ms.launches["megastep"] == 2
    assert ldl.launches["tree_ldl_factor"] == 4 and ldl.launches["tree_ldl_solve"] == 8
    assert torch.isfinite(engine.state.qpos).all() and torch.isfinite(sim.state.qpos).all()
