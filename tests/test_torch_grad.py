"""Gradients through the port's step against the JAX package's, on the CPU.

- ``powf``, ``sinf`` and ``cosf`` (``engine/maths.py``): their forward is
  the glibc algorithm, bit-equal to ``jnp.power``/``jnp.sin``/``jnp.cos``
  on XLA's CPU backend, and their gradients are JAX's rules, against
  ``jax.vjp`` of the jnp functions (:data:`MATHS_BAR`).
- The tree-LDL solve under autograd (``ops/ldl.py:tree_ldl_solve_grad``):
  gH entry by entry and gb against ``jax.grad`` through JAX's plain tree
  LDL (``flygym_tpu/engine/linalg.py``) on the benchmark fly's sample
  Hessians, and against autograd through the port's plain versions
  (:data:`LDL_BAR`).
- The JAX differentiable test's capsule (``tests/engine/test_differentiable.py``),
  composed by the port: the 15-step rollout's gradient against central
  differences (JAX's 5%), against ``jax.grad``
  (``flygym_tpu_torch/assets/grad_golden.npz``,
  ``scripts/export_grad_golden.py``; :data:`GOLDEN_BAR`), the gravity
  gradient, and the forward with ``differentiable`` on and off bit-equal.
- The benchmark fly's 2-step gradient against the golden's ``jax.grad``.
- PGS differentiates, and its sweeps give the in-place loop's values.
- Example 10 (``demo/gradient_optimization.py``): its loss and gradient
  at 5 steps against the golden's ``jax.value_and_grad`` of the example's
  loss, and a few Adam iterations.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flygym_tpu.engine import linalg as j_linalg
from flygym_tpu.ops import megastep as j_megastep

from flygym_tpu_torch import load_compiled
from flygym_tpu_torch.compose.bridge import ASSETS, BENCHMARK_FLY, load_golden
from flygym_tpu_torch.demo import gradient_optimization as go
from flygym_tpu_torch.engine import contact, linalg, maths
from flygym_tpu_torch.engine.model import State
from flygym_tpu_torch.engine.step import step
from flygym_tpu_torch.ops import ldl, refuse_grad
from flygym_tpu_torch.ops.megastep import megastep_supported

torch.set_num_threads(1)

GRAD_GOLDEN = ASSETS / "grad_golden.npz"
PGS_FLY = ASSETS / "pgs_fly.npz"

# The maths gradients against jax.vjp: the same products of the same
# float32 factors (g, y and a glibc power; g and a glibc cos or sin) give
# the same bits, and are held to them; the exponent's log(x) is torch's
# against XLA's (measured: 2.3e-7 relative in 12% of the elements).
MATHS_BAR = 1e-6
# The LDL Function's gradients against jax.grad through JAX's plain factor
# and solve, relative to the largest |g|: the plain factor's autodiff and
# the adjoint solve are the same sums in other orders; the sample Hessians
# are tiny-mass SPD matrices whose gH reaches ~3e9 (measured: 2.9e-7).
LDL_BAR = 1e-5
# The rollouts' gradients against the golden's jax.grad, relative to the
# largest |g| of each: 15 (capsule) or 2 (fly) steps of float32 physics
# whose engine rounds as eager JAX but for the ulps of the compile, against
# JAX jitted, whose XLA fuses otherwise (measured: capsule 2.2e-6, fly
# ctrl 5.1e-6 and qvel 4.5e-5; JAX jitted against JAX eager on the fly's
# ctrl: 8e-6).
GOLDEN_BAR = 1e-4
# Example 10's loss, lean and thorax height at 5 steps against JAX's, relative:
# float32 physics from the compiled state, eager against jitted (measured:
# loss and lean 4.4e-6, thorax z 6.3e-7; the gradient 1.4e-5 of max|g|,
# held to GOLDEN_BAR).
STANCE_VALUE_BAR = 1e-4
# JAX's own bar for the gradient against central differences.
FD_BAR = 0.05


@pytest.fixture(scope="module")
def golden():
    with np.load(GRAD_GOLDEN) as g:
        return {k: g[k] for k in g.files}


def _vjp_jax(fn, args, w, argnum):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return np.asarray(vjp(jnp.asarray(w))[argnum])


def _rel(got, want):
    """max |got - want| over max |want|."""
    got, want = (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


# --------------------------------------------------------------------------
# maths
# --------------------------------------------------------------------------

def _maths_inputs(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, n).astype(np.float32)
    x[:4] = [0.0, 1.0, 0.5, 2.0**-130]  # a zero, a one and a subnormal flushed to zero
    y = rng.uniform(1.0, 4.0, n).astype(np.float32)
    a = rng.uniform(-8.0, 8.0, n).astype(np.float32)
    w = rng.standard_normal(n).astype(np.float32)
    return x, y, a, w


@pytest.mark.parametrize("name", ["powf", "sinf", "cosf"])
def test_maths_forward_is_the_glibc_algorithm(name):
    """The Functions' forward is the algorithm as it was, bit for bit, and
    equal to XLA's CPU results."""
    x, y, a, _w = _maths_inputs()
    if name == "powf":
        got = maths.powf(torch.from_numpy(x), torch.from_numpy(y))
        raw = maths._powf(torch.from_numpy(x), torch.from_numpy(y))
        want = np.asarray(jnp.power(jnp.asarray(x), jnp.asarray(y)))
    else:
        got = getattr(maths, name)(torch.from_numpy(a))
        raw = maths._sincosf(torch.from_numpy(a), cos=name == "cosf")
        want = np.asarray((jnp.sin if name == "sinf" else jnp.cos)(jnp.asarray(a)))
    assert torch.equal(got, raw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["powf_x", "powf_y", "powf_x_float_y", "sinf", "cosf"])
def test_maths_gradients_are_jax_rules(case):
    x, y, a, w = _maths_inputs(1)
    if case == "powf_x_float_y":
        t = torch.from_numpy(x).requires_grad_(True)
        (maths.powf(t, 3.0) * torch.from_numpy(w)).sum().backward()
        got, want = t.grad.numpy(), _vjp_jax(lambda u: jnp.power(u, 3.0), [x], w, 0)
    elif case.startswith("powf"):
        argnum = 0 if case == "powf_x" else 1
        # x > 0 for the exponent's gradient, whose log(0) JAX reads as log(1).
        xs = x if argnum == 0 else np.maximum(x, np.float32(1e-3))
        tx, ty = torch.from_numpy(xs).requires_grad_(True), torch.from_numpy(y).requires_grad_(True)
        (maths.powf(tx, ty) * torch.from_numpy(w)).sum().backward()
        got = (tx.grad if argnum == 0 else ty.grad).numpy()
        want = _vjp_jax(jnp.power, [xs, y], w, argnum)
    else:
        t = torch.from_numpy(a).requires_grad_(True)
        (getattr(maths, case)(t) * torch.from_numpy(w)).sum().backward()
        got, want = t.grad.numpy(), _vjp_jax(jnp.sin if case == "sinf" else jnp.cos, [a], w, 0)
    assert np.isfinite(got).all()
    if case == "powf_x":
        # x = 2^-130 (element 3): XLA's pow reads a subnormal x as 2^-150
        # (glibc's normalisation under denormals-are-zero), so x^(y-1) is
        # 2^(-150 (y-1)), not 0, where y - 1 < 1; the port's powf, whose
        # forward this PR keeps bit for bit, reads it as 0 (ROADMAP queue 3).
        y3 = np.float64(y[3])
        assert got[3] == 0.0
        assert np.isclose(want[3], w[3] * y3 * 2.0 ** (-150 * (y3 - 1)), rtol=1e-6, atol=0.0)
        got, want = np.delete(got, 3), np.delete(want, 3)
    if case == "powf_y":
        np.testing.assert_allclose(got, want, rtol=MATHS_BAR, atol=0.0)
    else:
        np.testing.assert_array_equal(got, want)


def test_powf_output_has_a_graph_and_broadcasts():
    """powf no longer cuts the graph (it went through the integer bits of
    x), and a broadcast exponent's gradient comes back in its own shape."""
    x = torch.rand(5, 3).requires_grad_(True)
    y = torch.tensor([1.5, 2.0, 3.0]).requires_grad_(True)
    out = maths.powf(x, y)
    assert out.grad_fn is not None
    out.sum().backward()
    assert x.grad.shape == x.shape and y.grad.shape == y.shape
    gy = torch.sum(torch.log(x.detach()) * out.detach(), dim=0)
    torch.testing.assert_close(y.grad, gy, rtol=1e-6, atol=0.0)


def test_impedance_gradient_matches_jax():
    """The contact impedance, all pow, against jax.grad of JAX's
    ``_impedance`` with respect to the penetration and to solimp."""
    from flygym_tpu.engine import contact as j_contact

    rng = np.random.default_rng(2)
    solimp = np.tile(np.float32([0.9, 0.95, 1e-3, 0.5, 2.0]), (64, 1))
    solimp[:, 4] = rng.uniform(1.5, 4.0, 64)
    solimp[:, 3] = rng.uniform(0.2, 0.8, 64)
    pos = rng.uniform(-2e-3, 0.0, 64).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    ts, tp = torch.from_numpy(solimp).requires_grad_(True), torch.from_numpy(pos).requires_grad_(True)
    (contact._impedance(ts, tp) * torch.from_numpy(w)).sum().backward()
    for argnum, got in ((0, ts.grad), (1, tp.grad)):
        want = _vjp_jax(j_contact._impedance, [solimp, pos], w, argnum)
        assert np.abs(got.numpy()).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# --------------------------------------------------------------------------
# the tree-LDL solve under autograd
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fly_model():
    return load_compiled(BENCHMARK_FLY).model


@pytest.fixture(scope="module")
def problems(fly_model):
    H, b = ldl.sample_problems(fly_model, 4, seed=3)
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(b.shape).astype(np.float32))
    return H, b, w


def _function_grads(tables, H, b, w, n_solves=1):
    Ht, bt = H.clone().requires_grad_(True), b.clone().requires_grad_(True)
    L, d = ldl.tree_ldl_factor(tables, Ht.detach())
    x, loss = bt, 0.0
    for _ in range(n_solves):
        x = ldl.tree_ldl_solve_grad(tables, Ht, L, d, x)
        loss = loss + (x * w).sum()
    loss.backward()
    return x.detach(), Ht.grad, bt.grad


def _plain_grads(tables, H, b, w, n_solves=1):
    Ht, bt = H.clone().requires_grad_(True), b.clone().requires_grad_(True)
    L, d = linalg.tree_ldl_factor(tables, Ht)
    x, loss = bt, 0.0
    for _ in range(n_solves):
        x = linalg.tree_ldl_solve(tables, L, d, x)
        loss = loss + (x * w).sum()
    loss.backward()
    return x.detach(), Ht.grad, bt.grad


def test_ldl_function_forward_is_the_plain_solve(fly_model, problems):
    H, b, _w = problems
    L, d = ldl.tree_ldl_factor(fly_model.ldl, H)
    x = ldl.tree_ldl_solve_grad(fly_model.ldl, H.requires_grad_(False), L, d, b)
    assert torch.equal(x, linalg.tree_ldl_solve(fly_model.ldl, L, d, b))


def test_ldl_function_gradients_match_jax_grad(fly_model, problems):
    """gH entry by entry and gb against jax.grad through JAX's plain tree
    LDL (vmapped over the worlds), on the benchmark fly's tables."""
    H, b, w = problems
    _x, gH, gb = _function_grads(fly_model.ldl, H, b, w)
    jm = _jax_tables(fly_model)

    def loss(Hj, bj):
        fac = jax.vmap(lambda A: j_linalg.tree_ldl_factor(jm, A))(Hj)
        x = jax.vmap(lambda L, d, v: j_linalg.tree_ldl_solve(jm, (L, d), v))(*fac, bj)
        return jnp.sum(x * jnp.asarray(w.numpy()))

    jH, jb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(H.numpy()), jnp.asarray(b.numpy()))
    jH, jb = np.asarray(jH), np.asarray(jb)
    assert np.array_equal(gH.numpy() != 0, jH != 0)  # the same entries, lower and diagonal
    assert _rel(gH, jH) < LDL_BAR and _rel(gb, jb) < LDL_BAR, (_rel(gH, jH), _rel(gb, jb))


def _jax_tables(model):
    """The static fields JAX's plain tree LDL reads, from the port's model."""
    return type("Tables", (), dict(
        nv=model.nv, dof_anc=jnp.asarray(model.ldl.dof_anc.numpy()),
        dof_height_levels=model.dof_height_levels, dof_depth_levels=model.dof_depth_levels))


@pytest.mark.parametrize("n_solves", [1, 2])
def test_ldl_function_gradients_match_autograd_through_plain(fly_model, problems, n_solves):
    """Against autograd through the port's plain factor and solve; two
    solves on one factor (as the Newton loop makes) sum their gH."""
    H, b, w = problems
    x, gH, gb = _function_grads(fly_model.ldl, H, b, w, n_solves)
    px, pH, pb = _plain_grads(fly_model.ldl, H, b, w, n_solves)
    assert torch.equal(x, px)
    assert _rel(gH, pH) < LDL_BAR and _rel(gb, pb) < LDL_BAR, (_rel(gH, pH), _rel(gb, pb))


def test_ldl_gradient_lands_on_the_envelope(fly_model, problems):
    """gH is nonzero only on the entries K1 reads: each DoF's row over its
    ancestors and the diagonal (813 of 5,184 entries for the fly), none
    above the diagonal."""
    H, b, w = problems
    _x, gH, _gb = _function_grads(fly_model.ldl, H, b, w)
    i, a = fly_model.ldl.env_index
    mask = torch.zeros_like(gH[0], dtype=torch.bool)
    mask[i, a] = True
    assert int(mask.sum()) == fly_model.ldl.n_env == 813
    assert not gH[:, ~mask].any() and bool((gH[:, mask] != 0).all())
    assert not torch.triu(gH, diagonal=1).any()


def test_refuse_grad():
    t = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="would cut the graph"):
        refuse_grad("k", torch.zeros(3), t)
    refuse_grad("k", torch.zeros(3))
    with torch.no_grad():
        refuse_grad("k", t)


# --------------------------------------------------------------------------
# the capsule of JAX's differentiable test
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def capsule():
    c = go.capsule_world()
    return c.model, c.initial_state


def _capsule_qvel0(golden):
    return torch.from_numpy(golden["qvel0"])[None].clone()


def _capsule_grad(model, state, qvel0):
    v = qvel0.clone().requires_grad_(True)
    loss = go.capsule_loss(model, state, v)
    (g,) = torch.autograd.grad(loss, v)
    return loss.detach(), g[0]


@pytest.mark.parametrize("i", [0, 2])
def test_capsule_gradient_matches_finite_differences(capsule, golden, i):
    """JAX's test: the slide DoF (friction path) and the normal DoF
    (contact), central differences of step 1e-2, within 5%."""
    model, state = capsule
    qvel0 = _capsule_qvel0(golden)
    _loss, g = _capsule_grad(model, state, qvel0)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    e = torch.zeros_like(qvel0)
    e[0, i] = 1e-2
    with torch.no_grad():
        fd = (go.capsule_loss(model, state, qvel0 + e)
              - go.capsule_loss(model, state, qvel0 - e)).item() / 2e-2
    assert abs(g[i].item() - fd) < FD_BAR * max(abs(fd), 1e-3), (i, g[i].item(), fd)


def test_capsule_gravity_gradient_is_finite_and_nonzero(capsule, golden):
    model, state = capsule
    g = model.gravity.clone().requires_grad_(True)
    loss = go.capsule_loss(dataclasses.replace(model, gravity=g), state,
                           _capsule_qvel0(golden))
    (gg,) = torch.autograd.grad(loss, g)
    assert torch.isfinite(gg).all() and gg[2].item() != 0.0


def test_capsule_gradients_match_the_jax_golden(capsule, golden):
    """Against ``jax.grad`` of JAX's test rollout, with respect to qvel0
    and to the gravity vector, and the forward's loss and final qpos."""
    model, state = capsule
    qvel0 = _capsule_qvel0(golden)
    loss, g = _capsule_grad(model, state, qvel0)
    assert _rel(g, golden["grad_qvel0"]) < GOLDEN_BAR
    grav = model.gravity.clone().requires_grad_(True)
    lg = go.capsule_loss(dataclasses.replace(model, gravity=grav), state, qvel0)
    (gg,) = torch.autograd.grad(lg, grav)
    assert _rel(gg, golden["grad_gravity"]) < GOLDEN_BAR
    assert abs(loss.item() - float(golden["loss"])) <= 1e-6 * abs(float(golden["loss"]))


@pytest.mark.parametrize("world", ["capsule", "fly"])
def test_forward_is_bit_equal_with_differentiable_on_and_off(capsule, fly_model, world):
    if world == "capsule":
        model, state = capsule
        state = dataclasses.replace(state, qvel=state.qvel + torch.tensor([50.0, 0, 0, 0, 0, 0]))
        n = 15
    else:
        model, state, n = fly_model, load_golden()["state"].map(lambda t: t[:2].clone()), 3
    outs = []
    for diff in (False, True):
        m, s = dataclasses.replace(model, differentiable=diff), state
        for _ in range(n):
            s = step(m, s)
        outs.append(s)
    for f in dataclasses.fields(State):
        assert torch.equal(getattr(outs[0], f.name), getattr(outs[1], f.name)), f.name


def test_capsule_compile_equals_jax():
    """With ``differentiable=True`` the port's compile of the capsule
    equals the JAX package's: every array (``can_invweight`` within the
    compile tests' Cholesky bar, 5e-5 relative) and every static field."""
    jm = _jax_capsule_model()
    arrays, meta, _names = go.capsule_spec().compile_arrays()
    assert meta["model"]["differentiable"] is True and jm.differentiable is True
    n_arrays = 0
    for f in dataclasses.fields(jm):
        want = getattr(jm, f.name)
        if f.metadata.get("static"):
            assert meta["model"][f.name] == json.loads(json.dumps(want)), f.name
            continue
        got, want = arrays[f"model.{f.name}"], np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype, f.name
        if f.name == "can_invweight":
            np.testing.assert_allclose(got, want, rtol=5e-5, atol=0.0)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        n_arrays += 1
    assert n_arrays > 50


def test_differentiable_capsule_takes_jax_megastep_gate(capsule):
    """K2's gate does not look at ``differentiable``, as JAX's does not:
    both take (or both refuse) the capsule in either mode."""
    model, _ = capsule
    assert model.differentiable
    want = j_megastep.megastep_supported(_jax_capsule_model())
    assert megastep_supported(model) == want
    assert megastep_supported(dataclasses.replace(model, differentiable=False)) == want


def _jax_capsule_model():
    return _load_export_script().capsule_world()[0]


def _load_export_script():
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "scripts" / "export_grad_golden.py"
    spec = importlib.util.spec_from_file_location("export_grad_golden", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# --------------------------------------------------------------------------
# the benchmark fly
# --------------------------------------------------------------------------

def _fly_grads(model, n_steps):
    st = load_golden()["state"].map(lambda t: t[:1].clone())
    ctrl = st.ctrl.clone().requires_grad_(True)
    qvel = st.qvel.clone().requires_grad_(True)
    s = dataclasses.replace(st, ctrl=ctrl, qvel=qvel)
    for _ in range(n_steps):
        s = step(model, s)
    loss = (s.qpos[0, 0] + s.qpos[0, 2] + 1e-3 * s.qvel.sum()
            + 1e-4 * s.contact_sensordata.sum())
    g_ctrl, g_qvel = torch.autograd.grad(loss, (ctrl, qvel))
    return loss.detach(), g_ctrl[0], g_qvel[0]


def test_fly_gradients_match_the_jax_golden(fly_model, golden):
    """The benchmark fly's 2 steps from its settled world 0: the contact
    rows, the impedance's pow and the sensors are on the gradient path."""
    model = dataclasses.replace(fly_model, differentiable=True)
    loss, g_ctrl, g_qvel = _fly_grads(model, int(golden["fly.n_steps"]))
    assert abs(loss.item() - float(golden["fly.loss"])) <= 1e-6 * abs(float(golden["fly.loss"]))
    assert _rel(g_ctrl, golden["fly.grad_ctrl"]) < GOLDEN_BAR
    assert _rel(g_qvel, golden["fly.grad_qvel"]) < GOLDEN_BAR


def test_fly_gradients_through_the_function_match_autograd_through_plain(fly_model, golden):
    """Differentiable mode (the Function) against the plain tree LDL under
    autograd (the CPU path with ``differentiable`` off): the same
    gradient, rounded in another order."""
    n = int(golden["fly.n_steps"])
    on = _fly_grads(dataclasses.replace(fly_model, differentiable=True), n)
    off = _fly_grads(dataclasses.replace(fly_model, differentiable=False), n)
    assert torch.equal(on[0], off[0])
    for a, b in zip(on[1:], off[1:]):
        assert _rel(a, b) < LDL_BAR


# --------------------------------------------------------------------------
# PGS
# --------------------------------------------------------------------------

def _pgs_in_place(model, Mh, Jp, D, aref, qfrc, row_active):
    """``_solve_dual_pgs`` as it was, writing each row into lam in place."""
    mv = lambda A, x: (A @ x[..., None])[..., 0]
    chol = torch.linalg.cholesky(Mh)
    qacc_smooth = torch.cholesky_solve(qfrc[..., None], chol)[..., 0]
    X = torch.cholesky_solve(Jp.transpose(-1, -2), chol)
    A = Jp @ X
    R = torch.where(D > 0, 1.0 / torch.clamp(D, min=1e-12), torch.zeros_like(D))
    b0 = mv(Jp, qacc_smooth) - aref
    diag = torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1) + R, min=1e-12)
    on = row_active.to(Jp.dtype)
    lam = torch.zeros_like(D)
    for _sweep in range(max(model.solver_iterations, 8)):
        for r in range(Jp.shape[1]):
            res = torch.sum(A[:, r] * lam, dim=-1) + R[:, r] * lam[:, r] + b0[:, r]
            lam[:, r] = torch.clamp(lam[:, r] - res / diag[:, r], min=0.0) * on[:, r]
    return qacc_smooth + mv(X, lam), lam


@pytest.fixture(scope="module")
def pgs_model():
    return load_compiled(PGS_FLY).model


def test_pgs_sweeps_equal_the_in_place_loop(pgs_model):
    """Seeded rows of the PGS fly: the select form gives the in-place
    loop's qacc and multipliers bit for bit."""
    rng = np.random.default_rng(5)
    B, nv, n = 2, pgs_model.nv, 24
    Mh = ldl.sample_problems(pgs_model, B, seed=5)[0]
    Jp = torch.from_numpy(rng.standard_normal((B, n, nv)).astype(np.float32)) * 0.1
    D = torch.from_numpy(rng.uniform(0.0, 2e4, (B, n)).astype(np.float32))
    aref = torch.from_numpy(rng.standard_normal((B, n)).astype(np.float32))
    qfrc = torch.from_numpy(rng.standard_normal((B, nv)).astype(np.float32))
    active = torch.from_numpy(rng.uniform(size=(B, n)) < 0.7)
    args = (pgs_model, Mh, Jp, D, aref, qfrc, active)
    for got, want in zip(contact._solve_dual_pgs(*args), _pgs_in_place(*args)):
        assert torch.equal(got, want)


def test_pgs_step_differentiates(pgs_model):
    """Two engine steps of the PGS fly backpropagate (the in-place row
    writes failed with "modified by an inplace operation")."""
    st = load_golden()["state"].map(lambda t: t[:1].clone())
    ctrl = st.ctrl.clone().requires_grad_(True)
    s = dataclasses.replace(st, ctrl=ctrl)
    for _ in range(2):
        s = step(pgs_model, s)
    (g,) = torch.autograd.grad(s.qpos[0, 2] + s.qvel.sum() * 1e-3, ctrl)
    assert torch.isfinite(g).all() and g.abs().max() > 0


# --------------------------------------------------------------------------
# example 10
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stance(golden):
    return go.stance_loss(int(golden["stance.n_steps"]), "cpu")[0]


@pytest.mark.parametrize("j", [0, 1], ids=["zero_offset", "seeded_offset"])
def test_example_10_loss_and_gradient_match_the_jax_golden(stance, golden, j):
    """Example 10's world and loss at 5 steps, at the zero offset and at a
    seeded one, against JAX's ``value_and_grad`` of the example's own loss
    (``scripts/export_grad_golden.py:stance_case``): the actuator and
    adhesion index maps, ``index_add``/``index_fill`` and their gradients
    are on its path."""
    x = torch.from_numpy(golden["stance.offset"][j]).requires_grad_(True)
    val, lean, z = stance(x)
    (g,) = torch.autograd.grad(val, x)
    for got, key in ((val, "stance.loss"), (lean, "stance.lean"), (z, "stance.z")):
        want = float(golden[key][j])
        assert abs(got.item() - want) <= STANCE_VALUE_BAR * abs(want), (key, got.item(), want)
    assert _rel(g, golden["stance.grad"][j]) < GOLDEN_BAR


def test_example_10_descends_on_the_cpu():
    """Example 10 at 5 steps and 3 iterations: finite losses, and the Adam
    steps move the stance toward a larger lean."""
    history = go.main(n_steps=5, n_iters=3, device="cpu", verbose=False)
    assert len(history) == 3
    assert all(np.isfinite([h["loss"], h["lean"], h["z"]]).all() for h in history)
    assert history[-1]["loss"] < history[0]["loss"]


def test_example_10_refuses_a_missing_card():
    """Like every entry point, example 10 runs on the card by default."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        go.main(n_steps=1, n_iters=1)
