"""Tree-LDL factor (K1) and solve (K1b): CUDA kernels and their wrappers.

The kernels are in ``flygym_tpu_torch/csrc/tree_ldl.cu`` and replace the
Pallas kernels ``_factor_kernel`` and ``_solve_kernel`` of
``flygym_tpu/ops/ldl_pallas.py``. Each wrapper takes the public batch-first
layout, (B, nv, nv) for H and (B, nv, ...) for the factor, and:

- for a CPU tensor, runs the plain version in
  :mod:`flygym_tpu_torch.engine.linalg`;
- for a CUDA tensor, launches its kernel or raises. There is no fallback.

The kernels read and write that layout as it is: H where the engine writes
it, L (B, nv, maxc) and d (B, nv) contiguous, so a factor from
:func:`tree_ldl_factor` reaches :func:`tree_ldl_solve` without a copy. A
model whose world does not fit in a block's shared memory raises
(:func:`shared_bytes`).

``launches`` counts kernel launches per wrapper. Only a launch adds to it
(the recorder's ``launches.<wrapper>``).

Gradients: :func:`tree_ldl_solve_grad` is the solve under autograd (a
``torch.autograd.Function``). Its forward is one K1b launch on a factor of
H made without autograd, its backward the adjoint solve, one more K1b
launch on the same factor (H is symmetric), counted apart in
``launches["tree_ldl_solve_backward"]``. The JAX package has no backward
kernel: its differentiable mode swaps the Pallas ops for the plain tree LDL
and lets ``jax.grad`` through it (``flygym_tpu/engine/contact.py:468-479``).
Outside the Function, a kernel given a tensor that requires grad raises, as
JAX's Pallas ops, which have no VJP, do: its output would have no graph.
"""

import torch
from torch.autograd.function import once_differentiable

from flygym_tpu_torch.engine import linalg
from flygym_tpu_torch.engine.linalg import LdlTables
from flygym_tpu_torch.ops import refuse_grad
from flygym_tpu_torch.utils.profiling import register_launches

__all__ = [
    "tree_ldl_factor",
    "tree_ldl_solve",
    "tree_ldl_solve_grad",
    "launches",
    "reset_launches",
    "sample_problems",
    "shared_bytes",
    "kernel_shape",
    "WORLDS",
    "SHARED_LIMIT",
]

WORLDS = 4  # worlds per block: LDL_WORLDS in tree_ldl.cu (kernel_shape's threads / 32)
SHARED_LIMIT = 232448  # bytes of shared memory a block may use on the H100

launches = {"tree_ldl_factor": 0, "tree_ldl_solve": 0, "tree_ldl_solve_backward": 0}
register_launches(launches)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def shared_bytes(tables: LdlTables) -> dict:
    """Dynamic shared memory per block of each kernel: WORLDS worlds of the
    factor's envelope and L over the chains, and of the solve's y and L over
    the chains (float32)."""
    return {"tree_ldl_factor": 4 * WORLDS * (tables.n_env + tables.n_chain),
            "tree_ldl_solve": 4 * WORLDS * (tables.nv + tables.n_chain)}


def _device_path(tables: LdlTables, device: torch.device) -> None:
    """Raise unless the kernels can run on ``device`` with these tables."""
    if device.type != "cuda":
        raise RuntimeError(f"tree-LDL kernels run on CUDA tensors, got {device}")
    if tables.kernel.device != device:
        raise ValueError(f"LDL tables on {tables.kernel.device}, tensors on {device}")
    need = shared_bytes(tables)["tree_ldl_factor"]
    if need > SHARED_LIMIT:
        raise ValueError(
            f"tree-LDL factor: {WORLDS} worlds of an envelope of {tables.n_env} entries need "
            f"{need} bytes of shared memory per block, more than the {SHARED_LIMIT} a block "
            f"may use")


def _raise_on_error(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.cuda_error_string(err).decode()}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def tree_ldl_factor(tables: LdlTables, H: torch.Tensor):
    """Factor H = L D Lᵀ per world. H: (B, nv, nv) → L (B, nv, maxc), d (B, nv)."""
    B, nv, maxc = H.shape[0], tables.nv, tables.maxc
    _check("H", H, (B, nv, nv), H.device)
    if H.device.type == "cpu":
        return linalg.tree_ldl_factor(tables, H)
    _device_path(tables, H.device)
    refuse_grad("tree_ldl_factor", H)
    if B == 0:
        return H.new_zeros((0, nv, maxc)), H.new_zeros((0, nv))

    from flygym_tpu_torch.ops._build import load_library

    lib = load_library()
    H = H.contiguous()
    L, d = H.new_empty((B, nv, maxc)), H.new_empty((B, nv))
    with torch.cuda.device(H.device):
        err = lib.tree_ldl_factor_f32(
            H.data_ptr(), L.data_ptr(), d.data_ptr(), tables.kernel.data_ptr(), nv, maxc,
            tables.n_env, tables.n_chain, B, _stream(H))
    _raise_on_error(lib, err, "tree_ldl_factor")
    launches["tree_ldl_factor"] += 1
    return L, d


def tree_ldl_solve(tables: LdlTables, L: torch.Tensor, d: torch.Tensor, b: torch.Tensor):
    """Solve L D Lᵀ x = b per world. L (B, nv, maxc), d (B, nv), b (B, nv) → x (B, nv)."""
    return _solve(tables, L, d, b, "tree_ldl_solve")


def _solve(tables: LdlTables, L, d, b, count: str):
    """:func:`tree_ldl_solve`, its launch counted under ``count``."""
    B, nv, maxc = b.shape[0], tables.nv, tables.maxc
    _check("L", L, (B, nv, maxc), b.device)
    _check("d", d, (B, nv), b.device)
    _check("b", b, (B, nv), b.device)
    if b.device.type == "cpu":
        return linalg.tree_ldl_solve(tables, L, d, b)
    _device_path(tables, b.device)
    refuse_grad("tree_ldl_solve", L, d, b)
    if B == 0:
        return b.new_zeros((0, nv))

    from flygym_tpu_torch.ops._build import load_library

    lib = load_library()
    L, d, b = L.contiguous(), d.contiguous(), b.contiguous()
    x = b.new_empty((B, nv))
    with torch.cuda.device(b.device):
        err = lib.tree_ldl_solve_f32(
            L.data_ptr(), d.data_ptr(), b.data_ptr(), x.data_ptr(), tables.kernel.data_ptr(),
            nv, maxc, tables.n_env, tables.n_chain, B, _stream(b))
    _raise_on_error(lib, err, "tree_ldl_solve")
    launches[count] += 1
    return x


class _TreeLdlSolve(torch.autograd.Function):
    """x = H⁻¹ b through a given tree-LDL factor (L, d) of H.

    Forward: :func:`tree_ldl_solve` (one K1b launch on the card). Backward:
    gb = H⁻¹ g, one more K1b launch on the same factor, and gH on exactly
    the entries K1 reads (each DoF's row over its ancestors, and the
    diagonal: ``LdlTables.env_index``), where the plain factor reads H and
    ``jax.grad`` through it puts its gradient: off the diagonal
    gH[i, a] = −(gb_i x_a + gb_a x_i), on it gH[i, i] = −gb_i x_i, zero
    elsewhere (x depends on H[i, a] and H[a, i] as one symmetric entry)."""

    @staticmethod
    def forward(ctx, H, b, tables, L, d):
        x = _solve(tables, L, d, b, "tree_ldl_solve")
        ctx.tables = tables
        ctx.save_for_backward(L, d, x)
        return x

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        L, d, x = ctx.saved_tensors
        tables = ctx.tables
        gb = _solve(tables, L, d, g.contiguous(), "tree_ldl_solve_backward")
        gH = None
        if ctx.needs_input_grad[0]:
            B, nv = x.shape
            i, a = tables.env_index
            # 0.5 on the diagonal: -(gb_i x_i + gb_i x_i) / 2 is -gb_i x_i exactly.
            vals = -(gb[:, i] * x[:, a] + gb[:, a] * x[:, i]) * tables.env_half
            gH = x.new_zeros((B, nv * nv))
            gH[:, i * nv + a] = vals
            gH = gH.reshape(B, nv, nv)
        return gH, gb, None, None, None


def tree_ldl_solve_grad(tables: LdlTables, H: torch.Tensor, L: torch.Tensor, d: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """:func:`tree_ldl_solve` under autograd: x = H⁻¹ b, differentiable in H
    (B, nv, nv) and b (B, nv); (L, d) is the factor of H, made without
    autograd (``tree_ldl_factor(tables, H.detach())``), and is not
    differentiated. A factor that serves several solves gives each its own
    node with H as input, and autograd sums their gH."""
    return _TreeLdlSolve.apply(H, b, tables, L, d)


def kernel_shape(tables: LdlTables) -> dict:
    """The launch for these tables: threads per block, and each kernel's
    dynamic shared bytes per block and blocks resident per SM."""
    import ctypes

    from flygym_tpu_torch.ops._build import load_library

    lib = load_library()
    shape = (ctypes.c_int * 5)()
    err = lib.tree_ldl_shape(tables.nv, tables.n_env, tables.n_chain, ctypes.addressof(shape))
    _raise_on_error(lib, err, "tree_ldl_shape")
    return {"threads": shape[0],
            "tree_ldl_factor": {"shared_bytes": shape[1], "blocks_per_sm": shape[2]},
            "tree_ldl_solve": {"shared_bytes": shape[3], "blocks_per_sm": shape[4]}}


def sample_problems(model, n_worlds: int, seed: int = 0):
    """Contact Hessians and right-hand sides at the main path's shapes, for
    checking and timing the kernels.

    World 0 is the mass matrix Mh at qpos0. Every other world is s·Mh plus
    four random contact rows on the root path of every leaf DoF (the
    construction of ``tests/engine/test_linalg.py:66-87``), with s in
    [0.5, 2] and row weights at the scale the Newton solver gives the
    benchmark fly's active rows (D ≈ 1.2e-4 at rest), so the matrices are
    conditioned like the solver's (cond(H) ≈ 240 at rest).

    Returns:
        H (n_worlds, nv, nv) and b (n_worlds, nv), float32 on the model's device.
    """
    from flygym_tpu_torch.engine import dynamics
    from flygym_tpu_torch.engine.kinematics import dof_subspace, kinematics_full

    qpos = model.qpos0[None]
    xpos, xquat, hinge_xaxis = kinematics_full(model, qpos)
    ref = xpos[:, model.ref_body]
    S = dof_subspace(model, xpos, hinge_xaxis, ref)
    M = dynamics.crba(model, dynamics.body_spatial_inertias(model, xpos, xquat, ref), S)
    Mh = (M + model.timestep * torch.diag(model.dof_damping))[0].cpu()

    nv = model.nv
    anc = model.dof_anc.cpu()
    leaves = sorted(set(range(nv)) - set(anc[anc >= 0].tolist()))
    support = torch.zeros(4 * len(leaves), nv)
    for k, leaf in enumerate(leaves):
        support[4 * k : 4 * k + 4, leaf] = 1.0
        support[4 * k : 4 * k + 4, anc[leaf][anc[leaf] >= 0]] = 1.0

    gen = torch.Generator().manual_seed(seed)
    n = n_worlds
    J = torch.randn((n,) + support.shape, generator=gen) * support
    W = 1e-4 * (0.5 + torch.rand((n, len(support)), generator=gen))
    s = 0.5 + 1.5 * torch.rand((n, 1, 1), generator=gen)
    W[0], s[0] = 0.0, 1.0
    H = s * Mh + (J.transpose(1, 2) * W[:, None, :]) @ J
    H = 0.5 * (H + H.transpose(1, 2))
    b = torch.randn((n, nv), generator=gen)
    return H.to(model.device), b.to(model.device)
