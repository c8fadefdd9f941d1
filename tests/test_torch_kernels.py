"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one; it imports no
JAX, so it runs on a machine with the card and PyTorch only:

    python -m pytest tests/test_torch_kernels.py -m cuda
"""

import pytest
import torch

from flygym_tpu_torch import load_compiled
from flygym_tpu_torch.engine import linalg
from flygym_tpu_torch.ops import ldl


@pytest.fixture
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return load_compiled().model.to("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_worlds", [1, 1000, 4096])
def test_tree_ldl_kernels_match_plain(model, n_worlds):
    """K1 and K1b within 1e-5 of the largest value of the plain versions:
    the kernels multiply by 1/d and fuse multiply-adds, and the plain
    versions' scatters accumulate with atomics in no fixed order."""
    H, b = ldl.sample_problems(model, n_worlds, seed=n_worlds)
    before = dict(ldl.launches)
    L, d = ldl.tree_ldl_factor(model.ldl, H)
    x = ldl.tree_ldl_solve(model.ldl, L, d, b)
    torch.cuda.synchronize()
    assert ldl.launches["tree_ldl_factor"] == before["tree_ldl_factor"] + 1
    assert ldl.launches["tree_ldl_solve"] == before["tree_ldl_solve"] + 1
    L0, d0 = linalg.tree_ldl_factor(model.ldl, H)
    x0 = linalg.tree_ldl_solve(model.ldl, L0, d0, b)
    for got, want in ((L, L0), (d, d0), (x, x0)):
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
def test_wrappers_refuse_cpu_tables_for_cuda_tensors(model):
    H, _ = ldl.sample_problems(model, 4)
    with pytest.raises(ValueError, match="tables"):
        ldl.tree_ldl_factor(model.ldl.to("cpu"), H)
