"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one; it imports no
JAX, so it runs on a machine with the card and PyTorch only:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

K1 and K1b are also held to the last bit against their build before the
redesign (``scripts/k1_before_redesign/tree_ldl.cu``, launched by
``before.py`` beside it).
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from flygym_tpu_torch import load_compiled
from flygym_tpu_torch.compose.bridge import THREEFLY, TWOFLY_FULL
from flygym_tpu_torch.engine import linalg
from flygym_tpu_torch.ops import _build, ldl

K1_BEFORE = Path(__file__).resolve().parents[1] / "scripts" / "k1_before_redesign"


@pytest.fixture
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return load_compiled().model.to("cuda")


def _equal_to_before(tables, H, b, L, d, x):
    spec = importlib.util.spec_from_file_location("k1_before_redesign", K1_BEFORE / "before.py")
    before = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(before)
    L0, d0, x0 = before.BeforeBuild(_build.load_ldl(before.SOURCE), tables, H, b).run()
    torch.cuda.synchronize()
    return torch.equal(L, L0) and torch.equal(d, d0) and torch.equal(x, x0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_worlds", [1, 1000, 4096])
def test_tree_ldl_kernels_match_plain(model, n_worlds):
    """K1 and K1b within 1e-5 of the largest value of the plain versions
    (the kernels multiply by 1/d, and the plain versions' scatters
    accumulate with atomics in no fixed order), and equal to the build
    before the redesign to the last bit."""
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
    assert _equal_to_before(model.ldl, H, b, L, d, x)


@pytest.mark.cuda
@pytest.mark.parametrize("path", [TWOFLY_FULL, THREEFLY], ids=["twofly_full", "threefly"])
def test_tree_ldl_kernels_equal_the_before_build_on_larger_trees(path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = load_compiled(path).model.to("cuda")
    H, b = ldl.sample_problems(model, 1000, seed=7)
    L, d = ldl.tree_ldl_factor(model.ldl, H)
    x = ldl.tree_ldl_solve(model.ldl, L, d, b)
    assert L.is_contiguous() and d.is_contiguous() and x.is_contiguous()
    assert _equal_to_before(model.ldl, H, b, L, d, x)


@pytest.mark.cuda
def test_wrappers_raise_on_an_envelope_too_large_for_shared_memory(model):
    """A chain of 121 DoFs: its envelope and chains (14,641 floats a world)
    do not fit 4 worlds in a block's shared memory."""
    nv = 121
    tables = linalg.LdlTables.from_static(
        nv, [list(range(i)) for i in range(nv)], [[i] for i in reversed(range(nv))],
        [[i] for i in range(nv)]).to("cuda")
    H = torch.eye(nv, device="cuda").expand(2, nv, nv).contiguous()
    before = dict(ldl.launches)
    with pytest.raises(ValueError, match="shared memory"):
        ldl.tree_ldl_factor(tables, H)
    with pytest.raises(ValueError, match="shared memory"):
        ldl.tree_ldl_solve(tables, H[:, :, :nv - 1].contiguous(), H[:, 0], H[:, 0])
    assert ldl.launches == before


@pytest.mark.cuda
def test_wrappers_refuse_cpu_tables_for_cuda_tensors(model):
    H, _ = ldl.sample_problems(model, 4)
    with pytest.raises(ValueError, match="tables"):
        ldl.tree_ldl_factor(model.ldl.to("cpu"), H)
