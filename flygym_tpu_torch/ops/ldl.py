"""Tree-LDL factor (K1) and solve (K1b): CUDA kernels and their wrappers.

The kernels are in ``flygym_tpu_torch/csrc/tree_ldl.cu`` and replace the
Pallas kernels ``_factor_kernel`` and ``_solve_kernel`` of
``flygym_tpu/ops/ldl_pallas.py``. Each wrapper takes the public batch-first
layout, (B, nv, nv) for H and (B, nv, ...) for the factor, and:

- for a CPU tensor, runs the plain version in
  :mod:`flygym_tpu_torch.engine.linalg`;
- for a CUDA tensor, launches its kernel or raises. There is no fallback.

Inside, the kernels work world-minor: the wrapper hands them (rows, B)
buffers, and returns the factor as views of those buffers, so a factor from
:func:`tree_ldl_factor` reaches :func:`tree_ldl_solve` without a copy.

``launches`` counts kernel launches per wrapper. Only a launch adds to it.
"""

import torch

from flygym_tpu_torch.engine import linalg
from flygym_tpu_torch.engine.linalg import LdlTables

__all__ = [
    "tree_ldl_factor",
    "tree_ldl_solve",
    "launches",
    "reset_launches",
    "sample_problems",
]

MAX_CHAIN = 64  # kMaxChain in tree_ldl.cu

launches = {"tree_ldl_factor": 0, "tree_ldl_solve": 0}


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


def _device_path(tables: LdlTables, device: torch.device) -> None:
    """Raise unless the kernels can run on ``device`` with these tables."""
    if device.type != "cuda":
        raise RuntimeError(f"tree-LDL kernels run on CUDA tensors, got {device}")
    if tables.chain_idx.device != device:
        raise ValueError(f"LDL tables on {tables.chain_idx.device}, tensors on {device}")
    if tables.maxc > MAX_CHAIN:
        raise ValueError(f"ancestor chains of {tables.maxc} > {MAX_CHAIN} DoFs")


def _raise_on_error(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.cuda_error_string(err).decode()}")


def tree_ldl_factor(tables: LdlTables, H: torch.Tensor):
    """Factor H = L D Lᵀ per world. H: (B, nv, nv) → L (B, nv, maxc), d (B, nv)."""
    B, nv, maxc = H.shape[0], tables.nv, tables.maxc
    _check("H", H, (B, nv, nv), H.device)
    if H.device.type == "cpu":
        return linalg.tree_ldl_factor(tables, H)
    _device_path(tables, H.device)
    if B == 0:
        return H.new_zeros((0, nv, maxc)), H.new_zeros((0, nv))

    from flygym_tpu_torch.ops._build import load_library

    lib = load_library()
    # The kernel destroys its world-minor working copy, so it gets a fresh
    # buffer: .contiguous() may return H itself (always when B == 1).
    work = torch.empty((nv * nv, B), dtype=H.dtype, device=H.device)
    work.copy_(H.reshape(B, nv * nv).t())
    Lt = torch.empty((nv * maxc, B), dtype=H.dtype, device=H.device)
    dt = torch.empty((nv, B), dtype=H.dtype, device=H.device)
    err = lib.tree_ldl_factor_f32(
        work.data_ptr(), Lt.data_ptr(), dt.data_ptr(),
        tables.order_height.data_ptr(), tables.chain_ptr.data_ptr(),
        tables.chain_idx.data_ptr(), nv, maxc, B,
        torch.cuda.current_stream(H.device).cuda_stream,
    )
    _raise_on_error(lib, err, "tree_ldl_factor")
    launches["tree_ldl_factor"] += 1
    return Lt.view(nv, maxc, B).permute(2, 0, 1), dt.t()


def tree_ldl_solve(tables: LdlTables, L: torch.Tensor, d: torch.Tensor, b: torch.Tensor):
    """Solve L D Lᵀ x = b per world. L (B, nv, maxc), d (B, nv), b (B, nv) → x (B, nv)."""
    B, nv, maxc = b.shape[0], tables.nv, tables.maxc
    _check("L", L, (B, nv, maxc), b.device)
    _check("d", d, (B, nv), b.device)
    _check("b", b, (B, nv), b.device)
    if b.device.type == "cpu":
        return linalg.tree_ldl_solve(tables, L, d, b)
    _device_path(tables, b.device)
    if B == 0:
        return b.new_zeros((0, nv))

    from flygym_tpu_torch.ops._build import load_library

    lib = load_library()
    # No-ops for a factor from tree_ldl_factor, which is world-minor already.
    Lt = L.permute(1, 2, 0).contiguous()
    dt = d.t().contiguous()
    bt = b.t().contiguous()
    xt = torch.empty((nv, B), dtype=b.dtype, device=b.device)
    err = lib.tree_ldl_solve_f32(
        Lt.data_ptr(), dt.data_ptr(), bt.data_ptr(), xt.data_ptr(),
        tables.order_height.data_ptr(), tables.order_depth.data_ptr(),
        tables.chain_ptr.data_ptr(), tables.chain_idx.data_ptr(), nv, maxc, B,
        torch.cuda.current_stream(b.device).cuda_stream,
    )
    _raise_on_error(lib, err, "tree_ldl_solve")
    launches["tree_ldl_solve"] += 1
    return xt.t()


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
