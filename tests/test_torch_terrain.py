"""Config 3 of the port, heightfield terrain, against the JAX package.

The world is example 08's (``scripts/export_terrain_golden.py``): one fly
with position actuators and leg adhesion on blocks terrain. Inputs are the
JAX settled worlds of ``flygym_tpu_torch/assets/terrain_fly_golden.npz``
(2,496 engine steps with adhesion on, roots moved apart) and the ground
planes the JAX sampler took from them. The JAX emitter runs eagerly on
(B,) arrays, as ``tests/engine/test_megastep.py:331-401`` runs it; the
closed loop is held against the committed goldens rather than a fresh JAX
run.

The ``cuda`` test at the end runs on a machine with the card and PyTorch
only::

    python -m pytest --noconftest tests/test_torch_terrain.py -m cuda
"""

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from flygym_tpu_torch import BatchSimulation
from flygym_tpu_torch.compose.bridge import (
    TERRAIN_FLY,
    _read_npz,
    load_compiled,
    load_terrain_golden,
)
from flygym_tpu_torch.control import HybridState
from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE
from flygym_tpu_torch.demo.hybrid_terrain import HybridLoop, place_roots, root_offsets
from flygym_tpu_torch.engine import contact, linalg, terrain
from flygym_tpu_torch.engine.kinematics import forward_kinematics, geom_poses
from flygym_tpu_torch.engine.step import rollout_batched, step
from flygym_tpu_torch.ops import _build, ldl
from flygym_tpu_torch.ops import megastep as ms

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
B = 2
# The plain emitter (and K2's host build) against the JAX emitter, as a
# share of the largest value: the same fp32 operations in the same order
# (measured bit-identical), the bar of chip_smoke.py's K2_RTOL.
K2_RTOL = 1e-6
LOOP_STEPS = 8


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def fresh():
    """(fly, world, JAX simulation, arrays, meta) of a fresh export."""
    return _load_script("export_terrain_golden").export_model()


@pytest.fixture(scope="module")
def jax_model(fresh):
    return fresh[2].model


@pytest.fixture(scope="module")
def compiled():
    return load_compiled(TERRAIN_FLY)


@pytest.fixture(scope="module")
def golden():
    return load_terrain_golden()


@pytest.fixture(scope="module")
def settled(golden):
    return golden["state"].map(lambda x: x[:B].clone())


@pytest.fixture(scope="module")
def planes(golden):
    """The JAX sampler's planes of the settled worlds (first sample)."""
    return torch.as_tensor(golden["emitter"]["planes"][0][:B])


@pytest.fixture(scope="module")
def static(compiled):
    return ms._Static(compiled.model)


@pytest.fixture(scope="module")
def plain_first(static, settled, planes):
    return ms.megastep_plain(static, settled, None, planes)


def test_committed_terrain_asset_equals_a_fresh_export(fresh):
    _fly, _world, _sim, arrays, meta = fresh
    committed, committed_meta = _read_npz(TERRAIN_FLY)
    assert sorted(committed) == sorted(arrays)
    for key, value in arrays.items():
        np.testing.assert_array_equal(committed[key], value, err_msg=key)
    assert committed_meta == json.loads(json.dumps(meta))


def test_terrain_model_loads(compiled):
    m = compiled.model
    assert m.has_hfield and tuple(m.hfield_data.shape) == (320, 320)
    assert m.hfield_cell.tolist() == [0.25, 0.25] and m.hfield_xy0.tolist() == [-40.0, -40.0]
    assert 0.2 <= float(m.hfield_data.max()) <= 0.35 and float(m.hfield_data.min()) == 0.0
    assert len(compiled.flies["rugged"]["tip_bodies"]) == 6
    assert ms.megastep_supported(m)
    assert ms._io_rows(ms._Static(m), 1)[0] == 73 + 72 + 48 + 0 + 72 + 4 * 110


def _grids():
    """(name, heights, xy0, cell): the blocks and gapped grids of the JAX
    package's worlds, and a tilted plane on an uneven grid."""
    from flygym_tpu.compose import BlocksTerrainWorld, GappedTerrainWorld

    out = []
    for name, world in (("blocks", BlocksTerrainWorld(block_size=1.3, height_range=(0.2, 0.35))),
                        ("gapped", GappedTerrainWorld())):
        hf = world._spec.hfield
        out.append((name, hf["data"], hf["xy0"], hf["cell"]))
    yy, xx = np.mgrid[0:12, 0:10]
    out.append(("tilted", (0.3 * xx * 0.5 - 0.2 * yy * 0.7).astype(np.float32), (-2.0, -3.0),
                (0.5, 0.7)))
    return out


def _hfield_models(heights, xy0, cell):
    import jax.numpy as jnp

    f32 = lambda a: np.asarray(a, np.float32)
    jm = SimpleNamespace(has_hfield=True, hfield_data=jnp.asarray(f32(heights)),
                         hfield_xy0=jnp.asarray(f32(xy0)), hfield_cell=jnp.asarray(f32(cell)))
    tm = SimpleNamespace(has_hfield=True, hfield_data=torch.tensor(f32(heights)),
                         hfield_xy0=torch.tensor(f32(xy0)), hfield_cell=torch.tensor(f32(cell)))
    return jm, tm


@pytest.mark.parametrize("grid", _grids(), ids=lambda g: g[0])
def test_ground_height_normal_matches_jax(grid):
    """Seeded points over and beyond the grid (the clamped edges), and the
    grid's corners: equal, or within 1 ulp."""
    import jax.numpy as jnp

    from flygym_tpu.engine.contact import ground_height_normal as jax_ghn

    _name, heights, xy0, cell = grid
    jm, tm = _hfield_models(heights, xy0, cell)
    nr, nc = heights.shape
    lo = np.float32(xy0) - 1.0
    hi = np.float32(xy0) + np.float32(cell) * [nc, nr] + 1.0
    rng = np.random.default_rng(0)
    xy = rng.uniform(lo, hi, (4000, 2)).astype(np.float32)
    corners = np.float32([[xy0[0], xy0[1]], [lo[0], lo[1]], [hi[0], hi[1]], [lo[0], hi[1]]])
    xy = np.concatenate([xy, corners])
    h_j, n_j = (np.asarray(a) for a in jax_ghn(jm, jnp.asarray(xy)))
    h, n = contact.ground_height_normal(tm, torch.from_numpy(xy))
    np.testing.assert_array_max_ulp(h.numpy(), h_j, maxulp=1)
    np.testing.assert_array_max_ulp(n.numpy(), n_j, maxulp=1)


def test_flat_ground_height_normal(compiled):
    flat = dataclasses.replace(compiled.model, has_hfield=False)
    h, n = contact.ground_height_normal(flat, torch.zeros(5, 2))
    assert torch.equal(h, flat.ground_pos[2].expand(5))
    assert torch.equal(n, torch.tensor([0.0, 0.0, 1.0]).expand(5, 3))
    assert terrain.make_plane_sampler(flat) is None


def _posed(golden, compiled, n, seed):
    """The golden's settled worlds with seeded pose noise: xpos, xquat."""
    idx = torch.arange(n) % golden["state"].qpos.shape[0]
    qpos = golden["state"].qpos[idx].clone()
    gen = torch.Generator().manual_seed(seed)
    qpos[:, :2] += 6.0 * torch.rand((n, 2), generator=gen) - 3.0
    qpos[:, 7:] += 0.1 * torch.randn(qpos[:, 7:].shape, generator=gen)
    return forward_kinematics(compiled.model, qpos)


@pytest.mark.parametrize("grid", ["blocks", "gapped", "golden"])
def test_plane_sampler_matches_jax(jax_model, compiled, golden, grid):
    """The port's gather sampler against JAX's default (windowed one-hot)
    sampler on posed batched states (``golden``: the golden's settled ones,
    whose planes the JAX emitter golden was fed first), jitted as the JAX
    package's rollouts run it: to the last bit in h and the normal."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.engine.terrain import make_plane_sampler as jax_sampler

    jm, model = jax_model, compiled.model
    if grid == "gapped":
        _n, heights, xy0, cell = _grids()[1]
        jm = dataclasses.replace(jm, hfield_data=jnp.asarray(heights),
                                 hfield_xy0=jnp.asarray(np.float32(xy0)),
                                 hfield_cell=jnp.asarray(np.float32(cell)))
        model = dataclasses.replace(model, hfield_data=torch.tensor(heights),
                                    hfield_xy0=torch.tensor(np.float32(xy0)),
                                    hfield_cell=torch.tensor(np.float32(cell)))
    if grid == "golden":
        xpos, xquat = golden["state"].xpos, golden["state"].xquat
    else:
        xpos, xquat = _posed(golden, compiled, 6, seed=1)
    sample_j = jax_sampler(jm)
    assert sample_j.method == "window"
    want = np.asarray(jax.jit(sample_j)(jnp.asarray(xpos.numpy()), jnp.asarray(xquat.numpy())))
    terrain.reset_samples()
    got = terrain.make_plane_sampler(model)(xpos, xquat)
    assert terrain.samples["planes"] == 1
    assert got.shape == (xpos.shape[0], model.ncand, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    if grid == "golden":
        np.testing.assert_array_equal(got.numpy(), golden["emitter"]["planes"][0])


def test_contact_candidates_match_jax_engine(jax_model, compiled, settled):
    import jax
    import jax.numpy as jnp

    from flygym_tpu.engine import contact as jcontact
    from flygym_tpu.engine import kinematics as jkin

    xpos, xquat = jnp.asarray(settled.xpos.numpy()), jnp.asarray(settled.xquat.numpy())
    gpos, gquat = jax.vmap(jkin.geom_poses, in_axes=(None, 0, 0))(jax_model, xpos, xquat)
    want = jax.vmap(jcontact.contact_candidates, in_axes=(None, 0, 0))(jax_model, gpos, gquat)
    got = contact.contact_candidates(compiled.model, torch.tensor(np.asarray(gpos)),
                                     torch.tensor(np.asarray(gquat)))
    for g, w, atol in zip(got, want, (1e-6, 1e-6, 1e-6)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)
    # Candidates stand on blocks and on the floor between them.
    h, _n = contact.ground_height_normal(compiled.model, got[1][..., :2])
    assert float(h.max()) > 0.2 and float(h.min()) == 0.0


def _controlled(compiled, golden, settled):
    """The settled worlds with the first closed-loop controls (the port's
    hybrid controller from the golden's controller state)."""
    sim = BatchSimulation(compiled, B, device="cpu", megastep=False)
    cs = HybridState.from_numpy({k: v[:B] for k, v in golden["controller"].items()},
                                device="cpu")
    state, _cs = HybridLoop(sim).control(settled, cs)
    return state


def test_engine_step_on_terrain_matches_jax_step(jax_model, compiled, golden, settled):
    """One engine step with the first closed-loop controls against
    ``jax.jit(step)``, to the bars of ``tests/test_torch_engine.py``."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.engine.model import State as JState
    from flygym_tpu.engine.step import step as jstep

    start = _controlled(compiled, golden, settled)
    jit_step = jax.jit(jstep)
    want = {}
    for w in range(B):
        out = jit_step(jax_model, JState(**{f.name: jnp.asarray(getattr(start, f.name)[w].numpy())
                                            for f in dataclasses.fields(JState)}))
        for f in dataclasses.fields(JState):
            want.setdefault(f.name, []).append(np.asarray(getattr(out, f.name)))
    want = {k: np.stack(v) for k, v in want.items()}
    got = step(compiled.model, start)
    close = lambda name, **kw: np.testing.assert_allclose(getattr(got, name).numpy(), want[name],
                                                          **kw)
    close("xpos", atol=1e-5)
    close("qacc", atol=0.2, rtol=6e-3)
    close("qvel", atol=1e-3)
    close("qpos", atol=1e-6 + 2e-4 * compiled.model.timestep)
    close("actuator_force", atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.contact_sensordata[..., :4].numpy(),
                               want["contact_sensordata"][..., :4], atol=2e-3)


def test_ldl_oracles_on_the_terrain_hessian(jax_model, compiled, golden, settled, monkeypatch):
    """K1/K1b's plain versions on the contact Hessian of an engine step on
    terrain (captured from the solver) against the JAX package's linalg."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.engine import linalg as jlinalg

    seen = []
    real = ldl.tree_ldl_factor

    def spy(tables, H):
        seen.append(H.clone())
        return real(tables, H)

    monkeypatch.setattr(ldl, "tree_ldl_factor", spy)
    step(compiled.model, _controlled(compiled, golden, settled))
    H = seen[-1]
    b = torch.from_numpy(np.random.default_rng(0).normal(size=(B, compiled.model.nv))
                         .astype(np.float32))
    tables = compiled.model.ldl
    L, d = linalg.tree_ldl_factor(tables, H)
    x = linalg.tree_ldl_solve(tables, L, d, b)
    L_j, d_j = jax.vmap(jlinalg.tree_ldl_factor, in_axes=(None, 0))(jax_model, jnp.asarray(H))
    x_j = jax.vmap(jlinalg.tree_ldl_solve, in_axes=(None, 0, 0))(jax_model, (L_j, d_j),
                                                                 jnp.asarray(b))
    rel = lambda g, w: float(np.abs(g.numpy() - np.asarray(w)).max() / np.abs(np.asarray(w)).max())
    assert rel(L, L_j) <= 1e-6 and rel(d, d_j) <= 1e-6 and rel(x, x_j) <= 1e-6


@pytest.mark.parametrize(
    "name",
    ["has_hfield", "topo", "pair_keys", "elim_order", "dof_path", "adh_groups", "sensor_groups",
     "free_dof_axis"],
)
def test_static_tables_equal_jax(jax_model, static, name):
    from flygym_tpu.ops import megastep as jms

    assert getattr(static, name) == getattr(jms._Static(jax_model), name)


@pytest.fixture(scope="module")
def jax_first(jax_model, settled, planes):
    """One JAX emitter step from the settled worlds with the same planes."""
    import jax.numpy as jnp

    from flygym_tpu.ops import megastep as jms

    cols = lambda x: [jnp.asarray(np.asarray(x)[:, i]) for i in range(np.asarray(x).shape[1])]
    pack = lambda lst: np.stack([np.asarray(x) for x in lst], axis=1)
    p = planes.numpy()
    ter = [tuple(jnp.asarray(p[:, c, k]) for k in range(4)) for c in range(p.shape[1])]
    r = jms.emit_step(jms._Static(jax_model), *(cols(getattr(settled, k).numpy())
                      for k in ("qpos", "qvel", "ctrl", "act", "qacc")), ter)
    return dict(
        qpos=pack(r["qpos"]), qvel=pack(r["qvel"]), qacc=pack(r["qacc"]),
        xpos=np.stack([pack(v) for v in r["xpos"]], axis=1),
        xquat=np.stack([pack(v) for v in r["xquat"]], axis=1),
        actuator_force=pack(r["actuator_force"]),
        contact_sensordata=np.stack([pack(v) for v in r["sensordata"]], axis=1),
    )


@pytest.mark.parametrize(
    "name", ["qpos", "qvel", "qacc", "xpos", "xquat", "actuator_force", "contact_sensordata"]
)
def test_plain_emitter_with_planes_matches_jax_emit_step(jax_first, plain_first, name):
    want = jax_first[name]
    got = getattr(plain_first, name).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= K2_RTOL * np.abs(want).max()


def test_sensors_report_the_terrain_frame(plain_first):
    """Legs on block edges see tilted normals; every reported frame is
    orthonormal."""
    data = plain_first.contact_sensordata
    normal, tangent = data[..., 10:13], data[..., 13:16]
    found = data[..., 0] > 0
    assert bool(found.any())
    torch.testing.assert_close(normal[found].norm(dim=-1), torch.ones(int(found.sum())))
    assert float((normal[found] * tangent[found]).sum(-1).abs().max()) <= 1e-6


def test_k_steps_plain_with_fixed_planes_equals_chained_steps(static, settled, planes):
    """K = 2 in one call with one set of planes is two K = 1 steps with
    those planes, bit for bit."""
    seq = torch.stack([settled.ctrl, settled.ctrl * 1.01])
    fused, traj = ms.megastep_plain(static, settled, seq, planes)
    state, rows = settled, []
    for i in range(2):
        state = ms.megastep_plain(static, dataclasses.replace(state, ctrl=seq[i]), None, planes)
        rows.append(state.qpos)
    assert torch.equal(traj, torch.stack(rows))
    for f in dataclasses.fields(state):
        if f.name != "time":
            assert torch.equal(getattr(fused, f.name), getattr(state, f.name)), f.name


@pytest.mark.parametrize("order", [0, 1], ids=["in_order", "reversed"])
def test_host_build_with_terrain_matches_plain(compiled, static, settled, planes, plain_first,
                                                order):
    """K2's source with the terrain header, compiled as host C++ (g++),
    against the plain version (measured bit-identical), with the block's
    parallel loops run in order and reversed."""
    header, n_scratch = ms.model_header(compiled.model)
    assert "#define MS_HFIELD 1" in header
    lib = _build.build_megastep_host(header)
    n_in, n_out = ms._io_rows(static, 1)
    s = settled
    packed = torch.cat([s.qpos.t(), s.qvel.t(), s.ctrl.t(), s.act.t(), s.qacc.t(),
                        planes.reshape(B, -1).t()]).contiguous()
    assert packed.shape == (n_in, B)
    out, scratch = torch.zeros((n_out, B)), torch.zeros((n_scratch, B))
    assert lib.megastep_host_f32(packed.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, 1,
                                 order) == 0
    got, _traj = ms._unpack(static, out, s, s.ctrl, 1)
    for f in ("qpos", "qvel", "qacc", "xpos", "xquat", "actuator_force", "contact_sensordata"):
        want = getattr(plain_first, f)
        assert (getattr(got, f) - want).abs().max() <= K2_RTOL * want.abs().max(), f


def test_flat_header_is_unchanged_by_the_terrain_switch():
    """The flat benchmark fly's header carries no terrain rows."""
    header, _n = ms.model_header(load_compiled().model)
    assert "MS_HFIELD" not in header and "N_AUX" not in header and "S_FRAME" not in header


class _Spy:
    """A stand-in step over one shard with a plane sampler that counts its
    calls."""

    def __init__(self, k_steps=1):
        self.k_steps, self.calls, self.samples = k_steps, [], 0
        self.sample_planes = self._sample

    def _sample(self, states):
        self.samples += 1
        return [torch.full((1, 1, 4), float(self.samples))]

    def __call__(self, states, *args):
        self.calls.append(args)
        (state,) = states
        if self.k_steps == 1:
            return [dataclasses.replace(state, time=state.time + 1)]
        return [dataclasses.replace(state, time=state.time + self.k_steps)], [state.qpos.expand(
            (self.k_steps,) + tuple(state.qpos.shape))]


@pytest.mark.parametrize(
    "kind, n_steps, resample, samples, launches",
    [("kchunk", 24, 8, 3, 3), ("one_step", 24, 8, 3, 24), ("indivisible", 20, 8, 0, 20)],
)
def test_plane_resample_schedule(compiled, kind, n_steps, resample, samples, launches):
    """K-chunk path: one sample per launch; one-step path: one per
    ``terrain_resample`` steps when it divides the run, else none here (the
    step samples at every call); as ``flygym_tpu/engine/step.py:256-308``."""
    state = compiled.initial_state
    if kind == "kchunk":
        spy = _Spy(8)
        rollout_batched([state], None, n_steps, kstep_fn=spy, record=False)
    else:
        spy = _Spy(1)
        rollout_batched([state], None, n_steps, batched_step=spy, record=False,
                        terrain_resample=resample)
    assert spy.samples == samples and len(spy.calls) == launches
    if kind != "indivisible":
        got = [int(c[-1][0][0, 0, 0]) for c in spy.calls]
        per = 1 if kind == "kchunk" else resample
        assert got == [1 + i // per for i in range(launches)]
    else:
        assert all(c == () for c in spy.calls)


def test_wrapper_samples_planes_itself_and_checks_them(compiled, settled, planes):
    fn = ms.make_megastep(compiled.model)
    terrain.reset_samples()
    plain = ms.megastep_plain(fn.static, settled, None, fn.sample_planes(settled))
    assert terrain.samples["planes"] == 1
    assert torch.equal(fn(settled).qpos, plain.qpos)
    assert terrain.samples["planes"] == 2
    with pytest.raises(ValueError, match="terrain_planes"):
        fn(settled, planes[:, :5])
    flat = load_compiled()
    assert ms.make_megastep(flat.model).sample_planes is None
    with pytest.raises(ValueError, match="without a heightfield"):
        ms.make_megastep(flat.model)(flat.initial_state, planes[:1])


def test_root_offsets_spread_the_worlds(compiled):
    sim = BatchSimulation(compiled, 64, device="cpu")
    off = root_offsets(64, torch.Generator().manual_seed(0), device="cpu")
    assert float(off.abs().max()) <= 20.0 and float(off.std()) > 5.0
    x0 = sim.state.xpos.clone()
    place_roots(sim, off)
    # Every body but the world body (0) moves with its root.
    torch.testing.assert_close(sim.state.xpos[:, 1:, :2] - x0[:, 1:, :2],
                               off[:, None].expand(-1, x0.shape[1] - 1, -1), atol=1e-5, rtol=0)
    torch.testing.assert_close(sim.state.xpos[..., 2], x0[..., 2])


@pytest.mark.parametrize("path", ["emitter", "engine", "sampler"])
def test_closed_loop_tracks_the_jax_golden(compiled, golden, path):
    """2 worlds x 8 closed-loop steps of config 3 on the CPU (the plain
    emitter with planes every 8 steps, or the engine step) against the JAX
    golden of that path, within ``GOLDEN_TOLERANCE``. The emitter path is
    fed the planes the JAX sampler took, or (``sampler``) takes its own
    sampler's, which round as the jitted JAX one's: controller and emitter
    then repeat the JAX run bit for bit."""
    sim = BatchSimulation(compiled, B, device="cpu", megastep=path != "engine")
    sim.state = golden["state"].map(lambda x: x[:B].clone())
    loop = HybridLoop(sim)
    sampled = []
    jax_planes = torch.as_tensor(golden["emitter"]["planes"][:, :B])

    def golden_planes(state):
        sampled.append(state)
        return jax_planes[len(sampled) - 1]

    if path == "emitter":
        loop.sample_planes = golden_planes
    cs = HybridState.from_numpy({k: v[:B] for k, v in golden["controller"].items()},
                                device="cpu")
    cs, rec = loop.run(cs, LOOP_STEPS, record=True)
    assert len(sampled) == (LOOP_STEPS // sim.terrain_resample if path == "emitter" else 0)
    want = golden["engine" if path == "engine" else "emitter"]
    for key in ("qpos", "qvel"):
        gap = np.abs(rec[key].numpy() - want[key][:LOOP_STEPS, :B]).max()
        assert gap <= GOLDEN_TOLERANCE[key], (key, gap)
        if path != "engine":
            assert gap == 0.0, (key, gap)
    found = rec["sensordata"][..., 0].numpy() != want["sensordata"][:LOOP_STEPS, :B, :, 0]
    assert found.mean() <= GOLDEN_TOLERANCE["found_share"]


@pytest.fixture
def cuda_compiled():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return load_compiled(TERRAIN_FLY)


@pytest.mark.cuda
@pytest.mark.parametrize("k_steps", [1, 8])
def test_kernel_with_planes_matches_plain(cuda_compiled, golden, k_steps):
    """K2 with terrain planes against its plain version on the card, at 1000
    worlds, to ``K2_RTOL`` of the largest value; one launch."""
    model = cuda_compiled.model.to("cuda")
    idx = torch.arange(1000) % golden["state"].qpos.shape[0]
    state = golden["state"].map(lambda x: x[idx].clone()).to("cuda")
    fn = ms.make_megastep(model, k_steps)
    planes = fn.sample_planes(state)
    before = ms.launches["megastep"]
    if k_steps == 1:
        got, want = fn(state, planes), ms.megastep_plain(fn.static, state, None, planes)
    else:
        seq = state.ctrl.expand((k_steps,) + tuple(state.ctrl.shape)).contiguous()
        (got, _t), (want, _w) = fn(state, seq, planes), ms.megastep_plain(fn.static, state, seq,
                                                                        planes)
    torch.cuda.synchronize()
    assert ms.launches["megastep"] == before + 1
    for f in ("qpos", "qvel", "qacc", "xpos", "xquat", "actuator_force", "contact_sensordata"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a - b).abs().max() <= K2_RTOL * b.abs().max(), f
