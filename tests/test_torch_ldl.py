"""The port's tree-LDL factor and solve against the JAX package's.

Two references, on the benchmark fly (nv 72, chains of up to 16):

- ``flygym_tpu.engine.linalg``, which the JAX package runs for the batched
  step off the TPU;
- the Pallas kernel bodies ``_factor_kernel`` and ``_solve_kernel`` of
  ``flygym_tpu/ops/ldl_pallas.py``, run directly on numpy arrays in their
  (rows, B) layout: they are plain Python over refs.

The kernels themselves run only on a CUDA device: ``test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flygym_tpu.demo.benchmark import make_model
from flygym_tpu.engine import linalg as jlinalg
from flygym_tpu.ops import ldl_pallas

from flygym_tpu_torch import load_compiled
from flygym_tpu_torch.engine import linalg
from flygym_tpu_torch.ops import ldl

torch.set_num_threads(1)

B = 3


@pytest.fixture(scope="module")
def jax_model():
    _fly, world, _cam = make_model()
    model, _state = world.compile()
    return model


@pytest.fixture(scope="module")
def tables():
    return load_compiled().model.ldl


@pytest.fixture(scope="module")
def problems():
    """B = 3 tree-sparse SPD matrices and right-hand sides (numpy, fp32):
    Mh at qpos0 and two contact Hessians (see ``ldl.sample_problems``)."""
    H, b = ldl.sample_problems(load_compiled().model, B, seed=0)
    return H.numpy(), b.numpy()


def _rel_err(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


def test_tables_match_the_jax_model(jax_model, tables):
    assert tables.nv == jax_model.nv
    assert tables.maxc == jax_model.dof_anc.shape[1] == 16
    np.testing.assert_array_equal(tables.dof_anc.numpy(), np.asarray(jax_model.dof_anc))
    assert tables.n_chain == sum(len(c) for c in jax_model.dof_chains) == 741
    order = torch.cat(tables.height_levels).tolist()
    assert order == [i for lvl in jax_model.dof_height_levels for i in lvl]
    assert sorted(order) == list(range(jax_model.nv))


def test_plain_matches_jax_linalg(jax_model, tables, problems):
    """Same algorithm, same operation order: equal to fp32 rounding."""
    H, b = problems
    factor = jax.jit(jax.vmap(jlinalg.tree_ldl_factor, in_axes=(None, 0)))
    solve = jax.jit(jax.vmap(jlinalg.tree_ldl_solve, in_axes=(None, 0, 0)))
    L_j, d_j = factor(jax_model, jnp.asarray(H))
    x_j = solve(jax_model, (L_j, d_j), jnp.asarray(b))
    L, d = linalg.tree_ldl_factor(tables, torch.from_numpy(H))
    x = linalg.tree_ldl_solve(tables, L, d, torch.from_numpy(b))
    assert _rel_err(L, L_j) <= 1e-6
    assert _rel_err(d, d_j) <= 1e-6
    assert _rel_err(x, x_j) <= 1e-6
    # And the factor solves the system it factored (to fp32 rounding of the
    # ill-conditioned contact case: relative to |H| |x|).
    xs = x.numpy().astype(np.float64)
    res = np.einsum("bij,bj->bi", H.astype(np.float64), xs) - b
    assert np.abs(res).max() <= 1e-5 * np.abs(H).max() * np.abs(xs).max()


def test_plain_matches_pallas_kernel_bodies(jax_model, tables, problems):
    """The Pallas bodies eliminate in the same order, one DoF at a time and
    with 1/d multiplied in. Measured gaps, relative to the largest value:
    2.5e-7 in L, 2.0e-7 in d, 3.5e-7 in x; the bounds leave a factor of 3."""
    H, b = problems
    nv, maxc = jax_model.nv, tables.maxc
    chains = jax_model.dof_chains
    H_t = np.ascontiguousarray(H.transpose(1, 2, 0).reshape(nv * nv, B))
    L_t = np.zeros((nv * maxc, B), np.float32)
    d_t = np.zeros((nv, B), np.float32)
    ldl_pallas._factor_kernel(
        nv, maxc, chains, jax_model.dof_height_levels, H_t, L_t, d_t,
        np.zeros_like(H_t),
    )
    x_t = np.zeros((nv, B), np.float32)
    ldl_pallas._solve_kernel(
        nv, maxc, chains, jax_model.dof_height_levels, jax_model.dof_depth_levels,
        L_t, d_t, np.ascontiguousarray(b.T), x_t, np.zeros((nv, B), np.float32),
    )
    L_p = L_t.reshape(nv, maxc, B).transpose(2, 0, 1)

    L, d = linalg.tree_ldl_factor(tables, torch.from_numpy(H))
    x = linalg.tree_ldl_solve(tables, L, d, torch.from_numpy(b))
    assert _rel_err(L, L_p) <= 1e-6
    assert _rel_err(d, d_t.T) <= 1e-6
    assert _rel_err(x, x_t.T) <= 1e-6


def test_wrappers_take_the_plain_path_on_cpu(tables, problems):
    H, b = problems
    ldl.reset_launches()
    L, d = ldl.tree_ldl_factor(tables, torch.from_numpy(H))
    x = ldl.tree_ldl_solve(tables, L, d, torch.from_numpy(b))
    L0, d0 = linalg.tree_ldl_factor(tables, torch.from_numpy(H))
    torch.testing.assert_close(L, L0, rtol=0, atol=0)
    torch.testing.assert_close(x, linalg.tree_ldl_solve(tables, L0, d0, torch.from_numpy(b)),
                               rtol=0, atol=0)
    assert ldl.launches == {"tree_ldl_factor": 0, "tree_ldl_solve": 0,
                            "tree_ldl_solve_backward": 0}


@pytest.mark.parametrize(
    "bad, match",
    [
        (lambda H: H.double(), "float32"),
        (lambda H: H[:, :-1], "shape"),
    ],
)
def test_wrapper_rejects_bad_input(tables, problems, bad, match):
    H, _ = problems
    with pytest.raises((TypeError, ValueError), match=match):
        ldl.tree_ldl_factor(tables, bad(torch.from_numpy(H)))
