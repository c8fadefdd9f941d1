"""K1/K1b's redesign on the CPU: the owner tables, and the host build of the
new schedule against K1/K1b as they stood before the redesign.

The redesigned kernels (``csrc/tree_ldl.cu``) run one warp per world: per
height level the lanes take the level's DoFs, then its L entries, then its
downdate targets, each target owned by one lane that subtracts the target's
contributions in elimination order (``engine/linalg.py:kernel_tables``).
That gives the serial elimination's roundings only if every target has one
owner and its contributions come in elimination (height-level) order. The
host build (g++) walks the same tables, each phase's items in order and
reversed, and must equal the host build of ``scripts/k1_before_redesign/tree_ldl.cu`` to
the last bit in L, d and x, on the benchmark fly (nv 72), the default
two-fly preset (nv 144) and the 3-fly pile (nv 216). Both stay within the
plain version's tolerance of JAX's Pallas kernel bodies
(``flygym_tpu/ops/ldl_pallas.py`` ``_factor_kernel``, ``_solve_kernel``),
run on numpy as ``test_torch_ldl.py`` runs them.
"""

import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu.ops import ldl_pallas

from flygym_tpu_torch import load_compiled
from flygym_tpu_torch.compose.bridge import THREEFLY, TWOFLY_FULL
from flygym_tpu_torch.engine.linalg import (ALIGN, SECTIONS, LdlTables, kernel_tables,
                                             pack_kernel_tables)
from flygym_tpu_torch.ops import _build, ldl

torch.set_num_threads(1)

BEFORE = Path(__file__).resolve().parents[1] / "scripts" / "k1_before_redesign"
MODELS = {"fly": None, "twofly_full": TWOFLY_FULL, "threefly": THREEFLY}
B = 5
# The plain version's bar against the Pallas bodies (test_torch_ldl.py),
# relative to the largest value.
RTOL = 1e-6


@pytest.fixture(scope="module")
def models():
    return {name: load_compiled(path) if path else load_compiled()
            for name, path in MODELS.items()}


@pytest.fixture(scope="module")
def host_builds():
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    return _build.build_ldl_host(), _build.build_ldl_host(BEFORE / "tree_ldl.cu")


@pytest.fixture(scope="module")
def before():
    """``scripts/k1_before_redesign/before.py``, the before build's launcher."""
    spec = importlib.util.spec_from_file_location("k1_before_redesign", BEFORE / "before.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lists(tables):
    chains = [[a for a in row if a >= 0] for row in tables.dof_anc.tolist()]
    height = [lvl.tolist() for lvl in tables.height_levels]
    depth = [lvl.tolist() for lvl in tables.depth_levels]
    return chains, height, depth


def _host_new(lib, tables, H, b, order):
    n, nv, maxc = H.shape[0], tables.nv, tables.maxc
    n_chain = tables.n_chain
    L, d, x = torch.empty((n, nv, maxc)), torch.empty((n, nv)), torch.empty((n, nv))
    assert lib.tree_ldl_factor_host_f32(
        H.data_ptr(), L.data_ptr(), d.data_ptr(), tables.kernel.data_ptr(), nv, maxc,
        tables.n_env, n_chain, n, order) == 0
    assert lib.tree_ldl_solve_host_f32(
        L.data_ptr(), d.data_ptr(), b.data_ptr(), x.data_ptr(), tables.kernel.data_ptr(), nv,
        maxc, tables.n_env, n_chain, n, order) == 0
    return L, d, x


def _pallas(tables, H, b):
    """JAX's Pallas kernel bodies on numpy in their (rows, B) layout."""
    n, nv, maxc = H.shape[0], tables.nv, tables.maxc
    chains, height, depth = _lists(tables)
    H_t = np.ascontiguousarray(H.numpy().transpose(1, 2, 0).reshape(nv * nv, n))
    L_t, d_t = np.zeros((nv * maxc, n), np.float32), np.zeros((nv, n), np.float32)
    ldl_pallas._factor_kernel(nv, maxc, chains, height, H_t, L_t, d_t, np.zeros_like(H_t))
    x_t = np.zeros((nv, n), np.float32)
    ldl_pallas._solve_kernel(nv, maxc, chains, height, depth, L_t, d_t,
                             np.ascontiguousarray(b.numpy().T), x_t, np.zeros_like(x_t))
    return L_t.reshape(nv, maxc, n).transpose(2, 0, 1), d_t.T, x_t.T


@pytest.mark.parametrize("name", list(MODELS))
def test_host_build_equals_the_before_build(models, host_builds, before, name):
    new, old = host_builds
    model = models[name].model
    tables = model.ldl
    H, b = ldl.sample_problems(model, B, seed=len(name))
    want = before.BeforeBuild(old, tables, H, b, host=True).run()
    for order in (0, 1):  # each phase's items in order, then reversed
        got = _host_new(new, tables, H, b, order)
        for label, g, w in zip("Ldx", got, want):
            assert torch.isfinite(g).all(), label
            assert torch.equal(g, w), f"{name}, order {order}: {label} differs from the before build"
    for label, g, w in zip("Ldx", want, _pallas(tables, H, b)):
        gap = np.abs(g.numpy() - w).max()
        assert gap <= RTOL * np.abs(w).max(), f"{name}: {label} {gap:.3e} from the Pallas bodies"


def _owners(t, pre, lev):
    """Level ``lev`` of owner tables ``pre`` decoded: [(target, [contribution
    words in order])]."""
    rec = t[f"{pre}_rec"].reshape(-1, 2)
    k0, k1 = t[f"{pre}_rec_ptr"][lev], t[f"{pre}_rec_ptr"][lev + 1]
    rounds = t[f"{pre}_round"][t[f"{pre}_round_ptr"][lev]:t[f"{pre}_round_ptr"][lev + 1]]
    out = []
    for k in range(k0, k1):
        target, n = _lo16(rec[k, 0]), _hi16(rec[k, 0])
        out.append((target, [int(rec[k, 1])] + [int(t[f"{pre}_more"][rounds[q - 1] + k])
                                                for q in range(1, n)]))
    return out


def _lo16(e):
    return int(e) & 0xFFFF


def _hi16(e):
    return (int(e) & 0xFFFFFFFF) >> 16


@pytest.mark.parametrize("name", list(MODELS))
def test_owner_tables(models, name):
    """One owner per target; contributions in elimination order, each the
    product its serial step makes; every chain entry scaled once; the
    buffer's head gives each section's offset and length."""
    tables = models[name].model.ldl
    chains, height, depth = _lists(tables)
    nv = tables.nv
    t = kernel_tables(nv, chains, height, depth)
    buf = pack_kernel_tables(t)
    np.testing.assert_array_equal(buf, tables.kernel.numpy())
    for s, key in enumerate(SECTIONS):
        off, n = buf[s], buf[len(SECTIONS) + 1 + s]
        assert off % ALIGN == 0 and n == len(t[key])
        np.testing.assert_array_equal(buf[off:off + n], t[key])
    ptr = t["chain_ptr"]
    row = {(a, c): ptr[a] + a + k for a in range(nv) for k, c in enumerate(chains[a] + [a])}
    assert t["env_src"].tolist() == [a * nv + c for (a, c) in sorted(row, key=row.get)]
    assert len(row) == tables.n_env == nv + len(t["chain_idx"])
    step = {i: k for k, i in enumerate(i for lvl in height for i in lvl)}
    dof_of = t["chain_dof"]
    totals = {"f": [0, 0], "s": [0, 0]}  # targets, contributions
    for lev, level in enumerate(height):
        scale = t["scale"].reshape(-1, 2)[t["scale_ptr"][lev]:t["scale_ptr"][lev + 1]]
        assert sorted(_lo16(e) for e in scale[:, 0]) == [
            p for i in level for p in range(ptr[i], ptr[i + 1])]
        assert all(diag == row[(_hi16(e), _hi16(e))] for e, diag in scale)
        for pre, kind in (("f", "factor"), ("s", "solve")):
            owners = _owners(t, pre, lev)
            targets = [tgt for tgt, _ in owners]
            assert len(set(targets)) == len(targets), f"{kind}: a target with two owners"
            counts = [len(src) for _, src in owners]
            assert counts == sorted(counts, reverse=True)
            want = set()
            for i in level:
                ch = chains[i]
                want |= ({row[(a, ch[cb])] for ca, a in enumerate(ch) for cb in range(ca + 1)}
                         if pre == "f" else set(ch))
            assert set(targets) == want
            for target, srcs in owners:
                dofs = [int(dof_of[_lo16(e)]) for e in srcs]
                assert all(i in level for i in dofs)
                assert [step[i] for i in dofs] == sorted(step[i] for i in dofs), \
                    f"{kind}: contributions out of elimination order"
                for e, i in zip(srcs, dofs):
                    ca = _lo16(e) - ptr[i]
                    if pre == "f":  # L[i, ca] * A[i, cb] into A[chain[ca], chain[cb]]
                        cb = _hi16(e) - (ptr[i] + i)
                        assert 0 <= cb <= ca and row[(chains[i][ca], chains[i][cb])] == target
                    else:  # L[i, ca] * y[i] into y[chain[ca]]
                        assert _hi16(e) == i and chains[i][ca] == target
            totals[pre][0] += len(owners)
            totals[pre][1] += sum(counts)
    assert totals["s"][1] == len(t["chain_idx"])
    if name == "fly":
        assert (tables.n_env, totals["f"][1], totals["f"][0]) == (813, 4721, 3566)
        assert max(len(src) for lev in range(len(height)) for _, src in _owners(t, "f", lev)) == 6


def test_shared_memory_bound(models):
    """Every committed model's world fits a block; a model whose envelope
    does not raises on the card's path before any launch (checked here with
    the sizes alone)."""
    for compiled in models.values():
        sizes = ldl.shared_bytes(compiled.model.ldl)
        assert max(sizes.values()) <= ldl.SHARED_LIMIT
    tables = models["threefly"].model.ldl
    assert ldl.shared_bytes(tables)["tree_ldl_factor"] == 4 * ldl.WORLDS * (2439 + 2223)
    # The chain of 121 DoFs that the card's test feeds the wrappers.
    chain = LdlTables.from_static(121, [list(range(i)) for i in range(121)],
                                  [[i] for i in reversed(range(121))], [[i] for i in range(121)])
    assert ldl.shared_bytes(chain)["tree_ldl_factor"] > ldl.SHARED_LIMIT
