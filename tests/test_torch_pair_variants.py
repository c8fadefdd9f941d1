"""Example 11's two flies at every contact setting JAX's K2 takes, in the
port against the JAX package.

The worlds (``scripts/export_pair_variants_golden.py``): example 11's two
stacked flies and 49 pair rows with the ground contacts and the pair rows
at condim 1, 4 and 6 (``twofly_condim6.npz`` is committed; condim 1 and 4
are compiled here by the JAX package), and the same flies on
``BlocksTerrainWorld()`` with the pair rows compressed to 7 groups of 7
(``twofly_terrain.npz``), where K2 reads each kept candidate's ground plane
and each group's winner, sampled outside the kernel. Inputs are the first
``B`` settled worlds of each world's golden (800 JAX engine steps after the
drop); the condim-1 and -4 worlds start from the condim-6 golden's.

The plain emitter is held to the JAX emitter's records in the goldens
(``emitter`` at step 0, ``c1`` and ``c4``), bit for bit; K2's source built
with g++ to the plain emitter, with the block's loops in order and
reversed; the engine step to the JAX engine within 3 times the golden's
conditioning probe. The last part holds the gate: what it takes (these
worlds and ``JointPreset.ALL_POSSIBLE``) and what it refuses, and that no
compile puts a sensor or an adhesion actuator on a pair row.

The ``cuda`` tests run on a machine with the card and PyTorch only::

    python -m pytest --noconftest tests/test_torch_pair_variants.py -m cuda
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu_torch import BatchSimulation, load_compiled, model_from_numpy
from flygym_tpu_torch.compose.bridge import (
    ASSETS,
    THREEFLY,
    TWOFLY,
    TWOFLY_CONDIM6,
    TWOFLY_CONDIM6_GOLDEN,
    TWOFLY_FULL,
    TWOFLY_TERRAIN,
    TWOFLY_TERRAIN_GOLDEN,
    _read_npz,
    load_pair_variant_golden,
)
from flygym_tpu_torch.engine import contact
from flygym_tpu_torch.engine.step import step as engine_step
from flygym_tpu_torch.ops import _build
from flygym_tpu_torch.ops import megastep as ms

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
B = 2
VARIANTS = ("condim1", "condim4", "condim6", "terrain")
FIELDS = ("qpos", "qvel", "qacc", "xpos", "xquat", "contact_sensordata")
# The engine golden: |port - JAX engine| within 3 times |probe - JAX engine|
# at each step, or these floors (tests/test_torch_pairs.py).
PROBE_FLOOR = {"qpos": 3e-5, "qvel": 5e-2}
MULTI_FLY = {"twofly": TWOFLY, "twofly_full": TWOFLY_FULL, "threefly": THREEFLY,
             "twofly_condim6": TWOFLY_CONDIM6, "twofly_terrain": TWOFLY_TERRAIN}


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def exporter():
    return _script("export_pair_variants_golden")


@pytest.fixture(scope="module")
def goldens():
    return {"condim6": load_pair_variant_golden(TWOFLY_CONDIM6_GOLDEN),
            "terrain": load_pair_variant_golden(TWOFLY_TERRAIN_GOLDEN)}


@pytest.fixture(scope="module")
def fresh(exporter):
    """name -> (arrays, meta) of a fresh JAX export, for the two committed
    worlds and example 11's world at condim 1 and 4."""
    out = {}
    for name in ("twofly_condim1", "twofly_condim4", "twofly_condim6", "twofly_terrain"):
        _world, _sim, arrays, meta = exporter.export_model(name)
        out[name] = arrays, json.loads(json.dumps(meta))
    return out


@pytest.fixture(scope="module")
def cases(fresh, goldens):
    """variant -> dict(model (the JAX compile), static, state (B settled
    worlds), aux (planes and winners or None), want (the JAX emitter's step
    from ``state``), plain (the plain emitter's step))."""
    out = {}
    for v in VARIANTS:
        if v == "terrain":
            model, golden = load_compiled(TWOFLY_TERRAIN).model, goldens["terrain"]
            rec = {k: x[0] for k, x in golden["emitter"].items()}
        else:
            c = int(v[-1])
            golden = goldens["condim6"]
            model = (load_compiled(TWOFLY_CONDIM6) if c == 6
                     else model_from_numpy(*fresh[f"twofly_condim{c}"])).model
            rec = ({k: x[0] for k, x in golden["emitter"].items()} if c == 6
                   else {k: x[0] for k, x in golden[f"c{c}"].items()})
        state = golden["state"].map(lambda x: x[:B].clone())
        aux = None
        if v == "terrain":
            aux = torch.cat([torch.from_numpy(rec["planes"][:B]).reshape(B, -1),
                             torch.from_numpy(rec["widx"][:B])], dim=1)
        static = ms._Static(model)
        out[v] = dict(model=model, static=static, state=state, aux=aux, want=rec,
                      active=golden["active_pairs"][:B],
                      plain=ms.megastep_plain(static, state, None, aux))
    return out


# ---------------------------------------------------------------------------
# The committed worlds and the emitters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["twofly_condim6", "twofly_terrain"])
def test_committed_world_equals_a_fresh_export(fresh, name):
    arrays, meta = fresh[name]
    committed, committed_meta = _read_npz(ASSETS / f"{name}.npz")
    assert sorted(committed) == sorted(arrays)
    for key, value in arrays.items():
        np.testing.assert_array_equal(committed[key], value, err_msg=key)
    assert committed_meta == meta


def test_worlds_are_example_11_at_each_setting(cases):
    """The condims and row counts the worlds compile to, and the compressed
    terrain world's sizes."""
    for v in VARIANTS:
        m = cases[v]["model"]
        condim = 3 if v == "terrain" else int(v[-1])
        assert (m.condim, m.nv, m.ncand, m.ncand_pair) == (condim, 144, 269, 49), v
        assert m.can_invweight.shape == (269, contact.n_pyramid_rows(condim)), v
    st = cases["terrain"]["static"]
    assert cases["terrain"]["model"].has_hfield and st.ncand == 227
    assert [len(g["members"]) for g in st.pair_comp_groups] == [7] * 7


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_emitter_equals_jax_emit_step(cases, variant):
    """One step of the plain emitter against the JAX emitter's, to the last
    bit: at condim 1, 4 and 6 (the pair rows' torsion and rolling rows too)
    and on the terrain with the same planes and winners. A world of the
    inputs has an active pair row."""
    case = cases[variant]
    for name, field in (("qpos", "qpos"), ("qvel", "qvel"), ("qacc", "qacc"),
                        ("sensordata", "contact_sensordata")):
        np.testing.assert_array_equal(getattr(case["plain"], field).numpy(),
                                      case["want"][name][:B], err_msg=name)
    assert case["active"].sum() > 0


@pytest.mark.parametrize("order", [0, 1], ids=["in_order", "reversed"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_host_build_equals_plain(cases, variant, order):
    """K2's source with this world's header compiled as host C++ (g++),
    the block's parallel loops in order and reversed, against the plain
    emitter: 0 gaps. The terrain header reads the planes, then the
    winners."""
    case = cases[variant]
    static, s, aux = case["static"], case["state"], case["aux"]
    header, n_scratch = ms.model_header(case["model"])
    rows = 1 if variant == "condim1" else contact.n_pyramid_rows(3 if variant == "terrain"
                                                                 else int(variant[-1]))
    assert f"constexpr int NROWS = {rows};" in header
    assert ("#define MS_HFIELD 1" in header) == ("#define MS_PAIRS_COMPRESSED 1" in header) \
        == (variant == "terrain")
    lib = _build.build_megastep_host(header)
    n_in, n_out = ms._io_rows(static, 1)
    parts = [s.qpos.t(), s.qvel.t(), s.ctrl.t(), s.act.t(), s.qacc.t()]
    if aux is not None:
        parts.append(aux.t())
    packed = torch.cat(parts).contiguous()
    assert packed.shape == (n_in, B)
    out, scratch = torch.zeros((n_out, B)), torch.zeros((n_scratch, B))
    assert lib.megastep_host_f32(packed.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, 1,
                                 order) == 0
    got, _traj = ms._unpack(static, out, s, s.ctrl, 1)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(case["plain"], f)), f


def test_joint_sampler_equals_jax_samplers(cases, goldens):
    """The terrain world's ``sample_planes``: the JAX plane sampler's rows of
    the kept candidates, flattened, then the JAX winner sampler's winners,
    as JAX's ``make_megastep.sample_planes`` concatenates them
    (``megastep.py:2656-2673``), to the last bit, from all 8 settled
    worlds."""
    golden = goldens["terrain"]
    fn = ms.make_megastep(cases["terrain"]["model"])
    aux = fn.sample_planes(golden["state"])
    st = fn.static
    n = 4 * st.ncand
    assert aux.shape == (8, n + 7)
    np.testing.assert_array_equal(aux[:, :n].reshape(8, st.ncand, 4).numpy(),
                                  golden["emitter"]["planes"][0])
    np.testing.assert_array_equal(aux[:, n:].numpy(), golden["emitter"]["widx"][0])
    # The pair rows' planes are sampled and not read; the winners are whole.
    assert bool((aux[:, n:] == aux[:, n:].floor()).all())


@pytest.mark.parametrize("name", ["condim6", "terrain"])
def test_engine_step_tracks_the_golden_within_the_probe(goldens, name):
    """The golden's 8 worlds, 16 engine steps on the CPU against the JAX
    engine: within 3 times the conditioning probe's spread (or the floors)
    at each step. The engine picks winners and samples planes in the
    step."""
    golden = goldens[name]
    model = load_compiled(TWOFLY_CONDIM6 if name == "condim6" else TWOFLY_TERRAIN).model
    want, probe = golden["engine"], golden["probe"]
    state = golden["state"]
    for i in range(want["qpos"].shape[0]):
        state = engine_step(model, state)
        for key in ("qpos", "qvel"):
            bar = max(3.0 * np.abs(probe[key][i] - want[key][i]).max(), PROBE_FLOOR[key])
            gap = np.abs(getattr(state, key).numpy() - want[key][i]).max()
            assert gap <= bar, (key, i, gap, bar)


def test_goldens_rest_the_top_fly_on_the_bottom_one(goldens):
    """Example 11's check in the JAX settle, and active pair rows in most
    worlds."""
    for name, golden in goldens.items():
        assert (golden["settled_gap"] > 0.4).all(), name
        assert (golden["active_pairs"] > 0).sum() >= 4, name


def test_rollout_routes_the_terrain_world_through_the_joint_samples(cases):
    """``BatchSimulation(..., megastep=True)`` on the CPU: a 2-step rollout
    is one K = 2 step of the plain version, for which the K-chunk route of
    ``engine/step.py:rollout_batched`` samples planes and winners once."""
    from flygym_tpu_torch.engine import terrain

    sim = BatchSimulation(load_compiled(TWOFLY_TERRAIN), 1, device="cpu", megastep=True,
                          megastep_k=2)
    sim.state = cases["terrain"]["state"].map(lambda x: x[:1].clone())
    contact.reset_samples()
    terrain.reset_samples()
    sim.rollout(None, 2, record_trajectory=False)
    assert contact.samples["winners"] == 1 and terrain.samples["planes"] == 1
    assert bool(torch.isfinite(sim.state.qpos).all())


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


def _all_possible():
    from flygym_tpu_torch.demo.benchmark import make_model

    _fly, world, _cam = make_model(joints_preset="all_possible", actuated_dofs_preset="all")
    world.compile()
    return world.compiled


def test_all_possible_host_build_equals_plain():
    """``JointPreset.ALL_POSSIBLE`` (nv 210, 103 KB of shared memory): one
    step of its host build, in order and reversed, against the plain
    emitter."""
    compiled = _all_possible()
    model = compiled.model
    assert model.nv == 210 and ms.megastep_supported(model)
    assert 4 * ms.scratch_layout(model)["n_shared"] == 103436
    static = ms._Static(model)
    s = compiled.initial_state.map(lambda x: torch.cat([x] * B).clone())
    gen = torch.Generator().manual_seed(0)
    s = dataclasses.replace(s, qvel=0.1 * torch.randn(s.qvel.shape, generator=gen))
    want = ms.megastep_plain(static, s)
    header, n_scratch = ms.model_header(model)
    lib = _build.build_megastep_host(header)
    n_in, n_out = ms._io_rows(static, 1)
    packed = torch.cat([s.qpos.t(), s.qvel.t(), s.ctrl.t(), s.act.t(), s.qacc.t()]).contiguous()
    assert packed.shape == (n_in, B)
    for order in (0, 1):
        out, scratch = torch.zeros((n_out, B)), torch.zeros((n_scratch, B))
        assert lib.megastep_host_f32(packed.data_ptr(), out.data_ptr(), scratch.data_ptr(), B,
                                     1, order) == 0
        got, _traj = ms._unpack(static, out, s, s.ctrl, 1)
        for f in FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), (order, f)


def test_gate_takes_every_jax_feature_and_refuses_the_rest(cases, monkeypatch):
    """``megastep_supported`` takes the pair rows at condim 1, 4 and 6 and
    the compressed rows on the heightfield; it refuses PGS, welds, a pair
    row with a contact sensor or an adhesion actuator (only a hand-made
    model has one), and a world whose first scratch slot passes a block's
    shared memory."""
    for v in VARIANTS:
        assert ms.megastep_supported(cases[v]["model"]), v
    for name in ("pgs_fly", "softweld_fly"):
        assert not ms.megastep_supported(load_compiled(ASSETS / f"{name}.npz").model), name
    for v in ("condim4", "terrain"):
        m = cases[v]["model"]
        for field in ("can_sensor", "can_adh_act"):
            values = getattr(m, field).clone()
            values[m.ncand - 1] = 3
            assert not ms.megastep_supported(dataclasses.replace(m, **{field: values})), (v, field)
    monkeypatch.setattr(ms, "SHARED_LIMIT", 4 * 1000)
    assert not ms.megastep_supported(cases["condim6"]["model"])


@pytest.mark.parametrize("name", sorted(MULTI_FLY))
def test_no_compile_puts_a_sensor_or_adhesion_on_a_pair_row(name):
    """Every pair row of every committed multi-fly world has adhesion
    actuator -1 and sensor -1, in the JAX package's compile (the ``.npz``)
    and in the port's (``demo/worlds.py``): JAX fills pair rows without
    those fields (``flygym_tpu/compose/spec.py:742-753``), as the port
    does. So K2's refusal of such a row guards hand-made models only."""
    from flygym_tpu_torch.demo.worlds import build_world

    jax_model = load_compiled(MULTI_FLY[name]).model
    _fly, world = build_world(name)
    port_model, _state = world.compile()
    for model in (jax_model, port_model):
        ng = model.ncand - model.ncand_pair
        assert model.ncand_pair > 0
        assert bool((model.can_sensor[ng:] == -1).all()) and bool((model.can_adh_act[ng:] == -1).all())
        if model.nu:  # the ground rows of flies with leg adhesion carry it (the pile has none)
            assert bool((model.can_adh_act[:ng] >= 0).any())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _differ(model, state, seed: int):
    """``state`` with seeded noise in every hinge (0.01 rad) and in qvel
    (0.1), the forward kinematics redone: 64 worlds that differ, so that a
    world reading another world's rows would show."""
    from flygym_tpu_torch.engine.kinematics import forward_kinematics

    gen = torch.Generator().manual_seed(seed)
    qpos, qvel = state.qpos.clone(), state.qvel.clone()
    qpos[:, model.hinge_qadr] += 0.01 * torch.randn((qpos.shape[0], len(model.hinge_qadr)),
                                                    generator=gen)
    qvel += 0.1 * torch.randn(qvel.shape, generator=gen)
    xpos, xquat = forward_kinematics(model, qpos)
    return dataclasses.replace(state, qpos=qpos, qvel=qvel, xpos=xpos, xquat=xquat)


def _card_case(variant: str):
    """(model on the card, 64 worlds that differ, aux or None) without JAX:
    the condim-1 and -4 worlds composed by the port; ``ALL_POSSIBLE`` from
    its initial state, the others from their golden's settled worlds."""
    from flygym_tpu_torch.demo.two_flies import make_two_fly_world

    if variant == "all_possible":
        compiled = _all_possible()
        model = compiled.model
        state = compiled.initial_state.map(lambda x: torch.cat([x] * 64).clone())
    else:
        if variant in ("condim1", "condim4"):
            world = make_two_fly_world(condim=int(variant[-1]))
            world.compile()
            model = world.compiled.model
        else:
            model = load_compiled(TWOFLY_TERRAIN if variant == "terrain" else TWOFLY_CONDIM6).model
        golden = load_pair_variant_golden(TWOFLY_TERRAIN_GOLDEN if variant == "terrain"
                                          else TWOFLY_CONDIM6_GOLDEN)
        idx = torch.arange(64) % golden["state"].qpos.shape[0]
        state = golden["state"].map(lambda x: x[idx].clone())
    state = _differ(model, state, 0).to("cuda")
    model = model.to("cuda")
    fn = ms.make_megastep(model)
    return model, state, None if fn.sample_planes is None else fn.sample_planes(state)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [*VARIANTS, "all_possible"])
def test_kernel_matches_plain(cuda_device, variant):
    """K2 with each new header against its plain version on the card, one
    K = 1 launch at 64 worlds that differ: 0 gaps."""
    model, state, aux = _card_case(variant)
    fn = ms.make_megastep(model)
    before = ms.launches["megastep"]
    got, want = fn(state, aux), ms.megastep_plain(fn.static, state, None, aux)
    torch.cuda.synchronize()
    assert ms.launches["megastep"] == before + 1
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.cuda
def test_simulations_take_k2_for_the_new_worlds(cuda_device):
    """``Simulation`` and ``BatchSimulation`` route the new worlds to K2 on
    the card: 16 steps are 2 K = 8 launches."""
    from flygym_tpu_torch import Simulation

    for path in (TWOFLY_CONDIM6, TWOFLY_TERRAIN):
        for sim in (Simulation(load_compiled(path)), BatchSimulation(load_compiled(path), 16)):
            assert sim.megastep
            ms.reset_launches()
            sim.rollout(None, 16, record_trajectory=False)
            torch.cuda.synchronize()
            assert ms.launches["megastep"] == 2 and torch.isfinite(sim.state.qpos).all()
