"""The engine-only solver variants in the port against the JAX package: soft
welds (``TetheredWorld(weld="soft")``) and the PGS solver, and the muscle
activation slot that the JAX engine leaves unclamped.

The worlds and their goldens come from ``scripts/export_taxis_golden.py``
(``softweld_fly``, ``pgs_fly``: the benchmark fly, 8 settled worlds and 20
replay steps of the JAX engine). JAX's mega-step refuses both variants, and
so does the port's: they run on the engine step, whose tree-LDL factor and
solve (K1, K1b) carry the soft-welded fly, and whose PGS solve takes a dense
Cholesky as JAX's ``cho_factor`` does. JAX is imported inside the tests that
need it, so the ``cuda`` test runs on a machine with the card and PyTorch
only::

    python -m pytest --noconftest tests/test_torch_solvers.py -m cuda
"""

import dataclasses
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu_torch import BatchSimulation, load_compiled
from flygym_tpu_torch.compose.bridge import ASSETS, MUSCLE_FLY, load_actuator_golden
from flygym_tpu_torch.engine import actuation
from flygym_tpu_torch.engine.step import step as engine_step
from flygym_tpu_torch.ops import ldl
from flygym_tpu_torch.ops import megastep as ms

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SOFTWELD_FLY = ASSETS / "softweld_fly.npz"
SOFTWELD_GOLDEN = ASSETS / "softweld_fly_golden.npz"
PGS_FLY = ASSETS / "pgs_fly.npz"
PGS_GOLDEN = ASSETS / "pgs_fly_golden.npz"
B = 2
# The engine step against the jitted JAX engine's record over 20 (soft
# weld) and 5 (PGS) chained steps: XLA fuses multiply-adds (ROADMAP queue
# 3 item 1). Measured: the soft-welded fly's qpos 1.5e-8 and qvel 7.6e-6
# (of up to 60), the PGS fly's qpos 1.2e-7 and qvel 5.3e-5 (of up to 178;
# its sweeps sum the dual's rows in another order than XLA's dot
# products); the bars sit ~100x above.
TOL = {"softweld": {"qpos": 1e-6, "qvel": 1e-3}, "pgs": {"qpos": 1e-5, "qvel": 5e-3}}
PGS_STEPS = 5


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _replay(compiled, golden, n_steps: int, device="cpu"):
    """``n_steps`` engine steps of the golden's controls from its settled
    state: the (n_steps, B, ·) qpos and qvel."""
    state = golden["state"].map(lambda x: x[:B].clone()).to(device)
    model = compiled.model.to(device)
    qpos, qvel = [], []
    for t in range(n_steps):
        ctrl = torch.from_numpy(golden["ctrl"][t, :B]).to(device)
        state = engine_step(model, dataclasses.replace(state, ctrl=ctrl))
        qpos.append(state.qpos)
        qvel.append(state.qvel)
    return torch.stack(qpos).cpu().numpy(), torch.stack(qvel).cpu().numpy()


def test_soft_weld_engine_matches_jax():
    """20 engine steps of the soft-welded fly against the JAX engine: the
    weld's restoring forces keep the root within 1e-3 mm of its tether,
    and the trajectory stays within ``TOL``."""
    compiled = load_compiled(SOFTWELD_FLY)
    golden = load_actuator_golden(SOFTWELD_GOLDEN)
    model = compiled.model
    assert len(model.welds) == 1 and model.ncand == 0 and model.nv == 72
    assert not ms.megastep_supported(model)
    assert not BatchSimulation(compiled, B, device="cpu").megastep
    n = golden["ctrl"].shape[0]
    before = ldl.launches["tree_ldl_factor"], ldl.launches["tree_ldl_solve"]
    qpos, qvel = _replay(compiled, golden, n)
    assert (ldl.launches["tree_ldl_factor"], ldl.launches["tree_ldl_solve"]) == before  # the CPU takes plain
    eng = golden["engine"]
    assert np.abs(qpos - eng["qpos"][:n, :B]).max() <= TOL["softweld"]["qpos"]
    assert np.abs(qvel - eng["qvel"][:n, :B]).max() <= TOL["softweld"]["qvel"]
    tether = np.asarray(model.welds[0][3])
    assert np.abs(qpos[-1, :, :3] - tether).max() <= 1e-3


def test_soft_weld_forces_match_jax():
    """The weld's generalised forces alone on seeded root offsets, against
    JAX's ``_weld_forces`` (rtol 1e-5: the impedance's pow and the norm)."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu_torch.engine import step as step_mod

    # The module, not the ``step`` function that ``flygym_tpu.engine`` exports.
    jstep_mod = importlib.import_module("flygym_tpu.engine.step")

    fly, world = _script("export_taxis_golden").build_world("softweld_fly")
    jmodel, jstate = world.compile()
    compiled = load_compiled(SOFTWELD_FLY)
    rng = np.random.default_rng(3)
    qpos = np.tile(np.asarray(jstate.qpos), (B, 1)).astype(np.float32)
    qpos[:, :3] += rng.uniform(-0.05, 0.05, (B, 3)).astype(np.float32)
    qpos[:, 3:7] += rng.uniform(-0.02, 0.02, (B, 4)).astype(np.float32)
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    qvel = rng.uniform(-1.0, 1.0, (B, jmodel.nv)).astype(np.float32)
    M = rng.standard_normal((B, jmodel.nv, jmodel.nv)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda q, v, m: jstep_mod._weld_forces(jmodel, q, v, m))(
        jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(M)))
    got = step_mod._weld_forces(compiled.model, torch.from_numpy(qpos), torch.from_numpy(qvel),
                                torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert np.abs(want).max() > 1.0


def test_pgs_engine_matches_jax():
    """5 engine steps of the PGS fly against the JAX engine within ``TOL``;
    no K2 launch and no tree-LDL launch (the dense Cholesky)."""
    compiled = load_compiled(PGS_FLY)
    golden = load_actuator_golden(PGS_GOLDEN)
    assert compiled.model.solver_type == "pgs"
    assert not ms.megastep_supported(compiled.model)
    qpos, qvel = _replay(compiled, golden, PGS_STEPS)
    eng = golden["engine"]
    assert np.abs(qpos - eng["qpos"][:PGS_STEPS, :B]).max() <= TOL["pgs"]["qpos"]
    assert np.abs(qvel - eng["qvel"][:PGS_STEPS, :B]).max() <= TOL["pgs"]["qvel"]


def test_pgs_dual_solve_matches_jax():
    """``_solve_dual_pgs`` alone on seeded rows of the PGS fly, against
    JAX's: the multipliers and the acceleration within 1e-4 of their
    largest values (the Cholesky and the sweeps' sums round otherwise)."""
    import jax
    import jax.numpy as jnp

    from flygym_tpu.engine import contact as jc
    from flygym_tpu_torch.engine import contact

    compiled = load_compiled(PGS_FLY)
    model = compiled.model
    golden = load_actuator_golden(PGS_GOLDEN)
    nv, nr = model.nv, 16 * 4
    rng = np.random.default_rng(5)
    A = rng.standard_normal((B, nv, nv)).astype(np.float32)
    Mh = np.einsum("bij,bkj->bik", A, A) / nv + np.eye(nv, dtype=np.float32)
    Jp = rng.standard_normal((B, nr, nv)).astype(np.float32)
    D = rng.uniform(0.0, 10.0, (B, nr)).astype(np.float32)
    D[:, ::5] = 0.0
    aref = rng.standard_normal((B, nr)).astype(np.float32)
    qfrc = rng.standard_normal((B, nv)).astype(np.float32)
    active = D > 0
    # JAX's solve reads the model's solver_iterations alone.
    jmodel = types.SimpleNamespace(solver_iterations=model.solver_iterations)
    want = [jax.jit(lambda *a: jc._solve_dual_pgs(jmodel, *a, 16, jnp.float32))(
        *(jnp.asarray(x[b]) for x in (Mh, Jp, D, aref, qfrc, active))) for b in range(B)]
    got = contact._solve_dual_pgs(model, *(torch.from_numpy(x) for x in
                                           (Mh, Jp, D, aref, qfrc, active)))
    for i, name in enumerate(("qacc", "lam")):
        w = np.stack([np.asarray(x[i]) for x in want])
        np.testing.assert_allclose(got[i].numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
    assert (got[1].numpy()[~active] == 0).all() and (got[1].numpy() > 0).any()
    assert golden["meta"]["settle_steps"] == 1000


def test_muscle_slot_0_is_left_unclamped_as_the_jax_engine_leaves_it():
    """The muscle-driven fly's activation slot 0 starts outside [0, 1]: the
    JAX engine's ``integrate_act`` leaves it there (its slotless adhesion
    actuators write last into slot 0's muscle mask), and so does the port's
    engine; every other muscle slot is clamped. K2's plain version keeps
    JAX's emitter rule and clamps slot 0 too."""
    import jax

    from flygym_tpu.engine.actuation import integrate_act

    fly, world = _script("export_actuator_golden").build_world("muscle_fly")
    jmodel, _state = world.compile()
    compiled = load_compiled(MUSCLE_FLY)
    model = compiled.model
    rng = np.random.default_rng(7)
    act = rng.uniform(0.2, 0.8, (B, model.na)).astype(np.float32)
    act[:, 0] = (1.3, -0.2)
    act[:, 1] = (1.3, -0.2)
    ctrl = np.tile(compiled.initial_state.ctrl.numpy(), (B, 1))
    dt = model.timestep
    want = np.asarray(jax.vmap(integrate_act, in_axes=(None, 0, 0, None))(jmodel, act, ctrl, dt))
    got = actuation.integrate_act(model, torch.from_numpy(act), torch.from_numpy(ctrl),
                                  dt).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[0, 0] > 1.0 and got[1, 0] < 0.0  # slot 0: unclamped
    assert got[0, 1] == 1.0 and got[1, 1] == 0.0  # slot 1: clamped
    state = compiled.initial_state.map(lambda x: x.expand(B, *x.shape[1:]).clone())
    state = dataclasses.replace(state, act=torch.from_numpy(act))
    plain = ms.megastep_plain(ms._Static(model), state)
    assert plain.act[0, 0] == 1.0 and plain.act[1, 0] == 0.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
def test_soft_weld_and_pgs_on_the_card(cuda_device):
    """Both variants' engine steps on the card: the soft-welded fly through
    K1 and K1b, the PGS fly through the dense Cholesky; each within ``TOL``
    of the JAX engine's record."""
    for name, path, golden_path, n in (("softweld", SOFTWELD_FLY, SOFTWELD_GOLDEN, 20),
                                       ("pgs", PGS_FLY, PGS_GOLDEN, PGS_STEPS)):
        compiled = load_compiled(path)
        golden = load_actuator_golden(golden_path)
        before = ldl.launches["tree_ldl_factor"]
        qpos, qvel = _replay(compiled, golden, n, device=cuda_device)
        if name == "softweld":
            assert ldl.launches["tree_ldl_factor"] - before == n
        eng = golden["engine"]
        assert np.abs(qpos - eng["qpos"][:n, :B]).max() <= TOL[name]["qpos"], name
        assert np.abs(qvel - eng["qvel"][:n, :B]).max() <= TOL[name]["qvel"], name
