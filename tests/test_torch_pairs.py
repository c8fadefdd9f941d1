"""Example 11's two stacked flies in the port, against the JAX package.

The world is ``examples/11_two_flies_interacting.py``'s
(``scripts/export_twofly_golden.py``): two LEGS_ONLY flies with leg adhesion,
joined by 49 uncompressed capsule-capsule pair rows. Inputs are the JAX
settled worlds of ``flygym_tpu_torch/assets/twofly_golden.npz`` (800 engine
steps, top fly dropped onto the bottom one, at least one active pair row in
every world). The JAX emitter runs eagerly on (B,) arrays, as
``tests/engine/test_megastep.py:70`` runs it. The stack is ill-conditioned
(a one-step Lipschitz constant of ~4e4 in qvel), so the engine step is held
to the spread of the golden's conditioning probe, while the plain emitter
and K2's host build, which repeat the JAX emitter's operations, are held to
the last bit.

The ``cuda`` tests at the end run on a machine with the card and PyTorch
only::

    python -m pytest --noconftest tests/test_torch_pairs.py -m cuda
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu_torch import BatchSimulation
from flygym_tpu_torch.compose.bridge import TWOFLY, _read_npz, load_compiled, load_twofly_golden
from flygym_tpu_torch.engine import contact, linalg
from flygym_tpu_torch.engine.kinematics import geom_poses
from flygym_tpu_torch.engine.step import step
from flygym_tpu_torch.ops import _build, ldl
from flygym_tpu_torch.ops import megastep as ms

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
B = 2
STEPS = 2
FIELDS = ("qpos", "qvel", "qacc", "xpos", "xquat", "actuator_force", "contact_sensordata")
# The engine golden: |port - JAX engine| within 3 times |probe - JAX engine|
# at each step, or these floors (tests/tpu/test_megastep_tpu.py:436-437).
PROBE_FLOOR = {"qpos": 3e-5, "qvel": 5e-2}


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def fresh():
    """(world, JAX simulation, arrays, meta) of a fresh export."""
    return _load_script("export_twofly_golden").export_model()


@pytest.fixture(scope="module")
def jax_model(fresh):
    return fresh[1].model


@pytest.fixture(scope="module")
def compiled():
    return load_compiled(TWOFLY)


@pytest.fixture(scope="module")
def golden():
    return load_twofly_golden()


@pytest.fixture(scope="module")
def settled(golden):
    return golden["state"].map(lambda x: x[:B].clone())


@pytest.fixture(scope="module")
def static(compiled):
    return ms._Static(compiled.model)


@pytest.fixture(scope="module")
def plain_first(static, settled):
    return ms.megastep_plain(static, settled)


def test_committed_twofly_asset_equals_a_fresh_export(fresh):
    _world, _sim, arrays, meta = fresh
    committed, committed_meta = _read_npz(TWOFLY)
    assert sorted(committed) == sorted(arrays)
    for key, value in arrays.items():
        np.testing.assert_array_equal(committed[key], value, err_msg=key)
    assert committed_meta == json.loads(json.dumps(meta))


def test_twofly_model_loads_with_uncompressed_pair_rows(compiled, static):
    m = compiled.model
    assert (m.nbody, m.nq, m.nv, m.nu, m.ncand, m.ncand_pair, m.ncon) == (
        139, 146, 144, 12, 269, 49, 32)
    assert not m.pair_compress and m.nsensor_contact == 12
    assert [tuple(j) for j in m.free_joints] == [(1, 0, 0), (70, 73, 72)]
    assert ms.megastep_supported(m)
    ng = m.ncand - m.ncand_pair
    # Pair rows join the bottom fly's trunk capsules to the top fly's and
    # carry neither a sensor nor an adhesion actuator.
    assert set(m.can_geom[ng:].tolist()) == {1, 2, 13, 14, 15, 16, 17}
    assert set(m.can_geom2[ng:].tolist()) == {70, 71, 82, 83, 84, 85, 86}
    assert (m.can_sensor[ng:] == -1).all() and (m.can_adh_act[ng:] == -1).all()
    # Two-body inverse weights, as the JAX compile filled them.
    assert (m.can_invweight[ng:] > m.can_invweight[:ng].min()).all()
    header, n_scratch = ms.model_header(m)
    assert "#define MS_PAIRS 1" in header and "MS_HFIELD" not in header
    assert "constexpr int NGROUND = 220;" in header and "constexpr int NPAIR = 49;" in header
    assert n_scratch == 30003
    assert static.cand_split[ng:] == [6] * 49


def _segments(n=400, seed=0):
    """Seeded segment pairs with parallel, crossing and zero-length ones."""
    rng = np.random.default_rng(seed)
    p1, q1, p2, q2 = (rng.normal(size=(n, 3)).astype(np.float32) for _ in range(4))
    k = n // 8
    q2[:k] = p2[:k] + (q1[:k] - p1[:k]) * 0.7  # parallel
    q2[k:2 * k] = p2[k:2 * k] - (q1[k:2 * k] - p1[k:2 * k])  # antiparallel
    mid = 0.5 * (p1[2 * k:3 * k] + q1[2 * k:3 * k])  # crossing at the midpoint
    p2[2 * k:3 * k], q2[2 * k:3 * k] = mid - p2[2 * k:3 * k] * 0.3, mid + p2[2 * k:3 * k] * 0.3
    q1[3 * k:4 * k] = p1[3 * k:4 * k]  # first segment a point
    q2[4 * k:5 * k] = p2[4 * k:5 * k]  # second segment a point
    q1[5 * k:6 * k], q2[5 * k:6 * k] = p1[5 * k:6 * k], p2[5 * k:6 * k]  # both points
    p2[6 * k:7 * k], q2[6 * k:7 * k] = p1[6 * k:7 * k], q1[6 * k:7 * k]  # the same segment
    return p1, q1, p2, q2


def test_segseg_closest_matches_jax():
    import jax.numpy as jnp

    from flygym_tpu.engine.contact import _segseg_closest

    segs = _segments()
    want = [np.asarray(w) for w in _segseg_closest(*(jnp.asarray(x) for x in segs))]
    got = contact.segseg_closest(*(torch.from_numpy(x) for x in segs))
    for g, w in zip(got, want):
        np.testing.assert_array_max_ulp(g.numpy(), w, maxulp=1)
    # The closest points lie on their segments.
    p1, q1 = (torch.from_numpy(x) for x in segs[:2])
    s = ((got[0] - p1) * (q1 - p1)).sum(-1) / ((q1 - p1) ** 2).sum(-1).clamp(min=1e-12)
    assert float(s.min()) >= -1e-5 and float(s.max()) <= 1 + 1e-5


def test_contact_candidates_with_pair_rows_match_jax(jax_model, compiled, golden):
    """Every candidate of the 8 settled worlds, ground and pair rows."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.engine import contact as jcontact
    from flygym_tpu.engine import kinematics as jkin

    state = golden["state"]
    xpos, xquat = jnp.asarray(state.xpos.numpy()), jnp.asarray(state.xquat.numpy())
    gpos, gquat = jax.vmap(jkin.geom_poses, in_axes=(None, 0, 0))(jax_model, xpos, xquat)
    want = jax.vmap(jcontact.contact_candidates, in_axes=(None, 0, 0))(jax_model, gpos, gquat)
    got = contact.contact_candidates(compiled.model, torch.tensor(np.asarray(gpos)),
                                     torch.tensor(np.asarray(gquat)))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    # Port geom poses give the same pair rows; some are active in every world.
    tgpos, tgquat = geom_poses(compiled.model, state.xpos, state.xquat)
    dist = contact.contact_candidates(compiled.model, tgpos, tgquat)[0]
    ng = compiled.model.ncand - compiled.model.ncand_pair
    assert (dist[:, ng:] < compiled.model.can_margin[ng:]).any(dim=1).all()


def test_static_pair_paths_and_signs_equal_jax(jax_model, static, settled):
    """Each candidate's DoF path and signs against the JAX emitter's
    ``_cand_geom`` (insertion order: body 1's DoFs +1, then body 2's -1)."""
    import jax.numpy as jnp

    from flygym_tpu.ops import megastep as jms

    jst = jms._Static(jax_model)
    assert jst.ncand_pair == static.ncand_pair and not jst.pair_comp_groups
    assert (jst.can_geom2 == static.can_geom2).all()
    cols = lambda x: [jnp.asarray(x[:, i]) for i in range(x.shape[1])]
    xpos = [tuple(cols(settled.xpos[:, b].numpy())) for b in range(static.nbody)]
    xquat = [tuple(cols(settled.xquat[:, b].numpy())) for b in range(static.nbody)]
    z, one = jnp.zeros(B), jnp.ones(B)
    cache = {}
    for c in list(range(0, static.ng_rows, 37)) + list(range(static.ng_rows, static.ncand)):
        want = jms._cand_geom(jst, c, xpos, xquat, xpos[jst.ref_body], None, z, one, cache)
        assert static.cand_paths[c] == want["path"], c
        assert static.cand_signs[c] == [want["signs"][d] for d in want["path"]], c


def test_cross_tree_fill_is_dropped(static):
    """On pair rows, the Hessian keeps exactly the pairs within one fly."""
    assert all(ms._fill_by_part(static, c) for c in range(static.ng_rows, static.ncand))
    c = static.ng_rows
    path, split = static.cand_paths[c], static.cand_split[c]
    assert ms._hkey(static, path[0], path[split]) is None
    assert ms._hkey(static, path[split + 1], path[split]) == (path[split], path[split + 1])


@pytest.fixture(scope="module")
def jax_first(jax_model, settled):
    """One JAX emitter step from the settled worlds."""
    import jax.numpy as jnp

    from flygym_tpu.ops import megastep as jms

    cols = lambda x: [jnp.asarray(np.asarray(x)[:, i]) for i in range(np.asarray(x).shape[1])]
    pack = lambda lst: np.stack([np.asarray(x) for x in lst], axis=1)
    r = jms.emit_step(jms._Static(jax_model), *(cols(getattr(settled, k).numpy())
                      for k in ("qpos", "qvel", "ctrl", "act", "qacc")))
    return dict(
        qpos=pack(r["qpos"]), qvel=pack(r["qvel"]), qacc=pack(r["qacc"]),
        xpos=np.stack([pack(v) for v in r["xpos"]], axis=1),
        xquat=np.stack([pack(v) for v in r["xquat"]], axis=1),
        actuator_force=pack(r["actuator_force"]),
        contact_sensordata=np.stack([pack(v) for v in r["sensordata"]], axis=1),
    )


@pytest.mark.parametrize("name", FIELDS)
def test_plain_emitter_with_pair_rows_equals_jax_emit_step(jax_first, plain_first, name):
    """To the last bit: the same fp32 operations in the same order."""
    want = jax_first[name]
    got = getattr(plain_first, name).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", [0, 1], ids=["in_order", "reversed"])
def test_host_build_with_pair_rows_equals_plain(compiled, static, settled, plain_first, order):
    """K2's source with the two-fly header, compiled as host C++ (g++),
    against the plain version, to the last bit, with the block's parallel
    loops run in order and reversed."""
    header, n_scratch = ms.model_header(compiled.model)
    lib = _build.build_megastep_host(header)
    n_in, n_out = ms._io_rows(static, 1)
    s = settled
    packed = torch.cat([s.qpos.t(), s.qvel.t(), s.ctrl.t(), s.act.t(), s.qacc.t()]).contiguous()
    assert packed.shape == (n_in, B)
    out, scratch = torch.zeros((n_out, B)), torch.zeros((n_scratch, B))
    assert lib.megastep_host_f32(packed.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, 1,
                                 order) == 0
    got, _traj = ms._unpack(static, out, s, s.ctrl, 1)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(plain_first, f)), f


def test_ldl_oracles_on_the_two_fly_forest_hessian(compiled, settled, monkeypatch):
    """K1/K1b's plain versions on the contact Hessian of an engine step of
    the stack (captured from the solver): the tree factor reads the two
    flies' trees and ignores the cross-tree entries that pair rows put into
    the dense H, so its solve equals a dense solve of H's tree pattern."""
    seen = []
    real = ldl.tree_ldl_factor

    def spy(tables, H):
        seen.append(H.clone())
        return real(tables, H)

    monkeypatch.setattr(ldl, "tree_ldl_factor", spy)
    step(compiled.model, settled)
    H = seen[-1]
    m = compiled.model
    pattern = torch.eye(m.nv, dtype=torch.bool)
    for d, chain in enumerate(m.dof_chains):
        pattern[d, list(chain)] = True
        pattern[list(chain), d] = True
    assert float((H * ~pattern).abs().max()) > 0.0  # pair rows couple the trees
    # No tree entry joins the two flies' DoFs: the forest has two roots.
    fly0 = torch.arange(m.nv) < m.free_joints[1][2]
    assert not (pattern & (fly0[:, None] != fly0[None, :])).any()
    b = torch.from_numpy(np.random.default_rng(0).normal(size=(B, m.nv)).astype(np.float32))
    L, d = linalg.tree_ldl_factor(m.ldl, H)
    x = linalg.tree_ldl_solve(m.ldl, L, d, b)
    want = torch.linalg.solve((H * pattern).double(), b.double()[..., None])[..., 0]
    # fp32 elimination against a float64 solve: 1e-4 of the largest value.
    assert float((x.double() - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("path", ["emitter", "engine"])
def test_first_steps_track_the_jax_golden(compiled, golden, path):
    """The golden's 8 worlds for 2 steps through ``BatchSimulation`` on the
    CPU: the plain emitter equals the JAX emitter to the last bit; the
    engine step is within 3 times the conditioning probe's spread (or the
    floors)."""
    sim = BatchSimulation(compiled, golden["state"].qpos.shape[0], device="cpu",
                          megastep=path == "emitter", megastep_k=1)
    sim.state = golden["state"]
    want, probe = golden[path], golden["probe"]
    for i in range(STEPS):
        sim.rollout(None, 1, record_trajectory=False)
        for key in ("qpos", "qvel"):
            got = getattr(sim.state, key).numpy()
            if path == "emitter":
                np.testing.assert_array_equal(got, want[key][i], err_msg=f"{key} step {i}")
            else:
                bar = max(3.0 * np.abs(probe[key][i] - want[key][i]).max(), PROBE_FLOOR[key])
                assert np.abs(got - want[key][i]).max() <= bar, (key, i)
    if path == "emitter":
        np.testing.assert_array_equal(sim.state.contact_sensordata.numpy(),
                                      want["sensordata"][STEPS - 1])


def test_each_fly_has_its_own_getters(compiled):
    """The two flies' index maps address disjoint parts of one state
    (``tests/core/test_multifly.py::TestTwoFlies``)."""
    sim = BatchSimulation(compiled, 3, device="cpu")
    for name in ("bottom", "top"):
        assert sim.get_body_positions(name).shape == (3, 69, 3)
        assert sim.get_joint_angles(name).shape == (3, len(compiled.flies[name]["qpos_adrs"]))
        assert sim.get_ground_contact_info(name)[0].shape == (3, 6)
    assert not set(compiled.flies["bottom"]["qpos_adrs"]) & set(compiled.flies["top"]["qpos_adrs"])
    # The top fly spawns 2 mm above the bottom one.
    pb, pt = sim.get_body_positions("bottom"), sim.get_body_positions("top")
    torch.testing.assert_close(pt[..., 2] - pb[..., 2], torch.full((3, 69), 2.0))
    torch.testing.assert_close(pt[..., :2], pb[..., :2])
    torch.testing.assert_close(sim.get_joint_angles("top"), sim.get_joint_angles("bottom"))
    sim.set_leg_adhesion_states("bottom", np.ones(6))
    bottom_ids = sim.actuator_ids("bottom", "adhesion")
    top_ids = sim.actuator_ids("top", "adhesion")
    assert (sim.state.ctrl[:, bottom_ids] == 1.0).all()
    assert (sim.state.ctrl[:, top_ids] == 0.0).all()
    assert (sim.get_actuator_forces("top", "adhesion") == 0.0).all()


def test_megastep_header_keeps_the_one_fly_tables():
    """A world without pair rows keeps the per-body path tables."""
    header, _n = ms.model_header(load_compiled().model)
    assert "MS_PAIRS" not in header and "kCandPathDof" not in header and "NGROUND" not in header


@pytest.fixture
def cuda_compiled():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return load_compiled(TWOFLY)


@pytest.mark.cuda
def test_kernel_with_pair_rows_equals_plain(cuda_compiled, golden):
    """K2 with pair rows against its plain version on the card, at 1000
    worlds, one K = 8 launch, to 1e-6 of the largest value of each output."""
    model = cuda_compiled.model.to("cuda")
    idx = torch.arange(1000) % golden["state"].qpos.shape[0]
    state = golden["state"].map(lambda x: x[idx].clone()).to("cuda")
    fn = ms.make_megastep(model, 8)
    seq = state.ctrl.expand((8,) + tuple(state.ctrl.shape)).contiguous()
    before = ms.launches["megastep"]
    (got, traj), (want, wtraj) = fn(state, seq), ms.megastep_plain(fn.static, state, seq)
    torch.cuda.synchronize()
    assert ms.launches["megastep"] == before + 1
    assert (traj - wtraj).abs().max() <= 1e-6 * wtraj.abs().max()
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a - b).abs().max() <= 1e-6 * b.abs().max(), f


@pytest.mark.cuda
def test_two_fly_rollout_launch_counts(cuda_compiled):
    """16 steps at 64 worlds through the default step are 2 K = 8 launches
    of K2; 4 engine steps are 4 K1 and 8 K1b launches."""
    sim = BatchSimulation(cuda_compiled, 64)
    assert sim.megastep
    sim.set_leg_adhesion_states("bottom", torch.ones(6, device="cuda"))
    ms.reset_launches()
    ldl.reset_launches()
    sim.rollout(None, 16, record_trajectory=False)
    torch.cuda.synchronize()
    assert ms.launches["megastep"] == 2 and ldl.launches["tree_ldl_factor"] == 0
    engine = BatchSimulation(cuda_compiled, 64, megastep=False)
    engine.rollout(None, 4, record_trajectory=False)
    torch.cuda.synchronize()
    assert ms.launches["megastep"] == 2
    assert ldl.launches["tree_ldl_factor"] == 4 and ldl.launches["tree_ldl_solve"] == 8
    assert torch.isfinite(engine.state.qpos).all() and torch.isfinite(sim.state.qpos).all()
