"""Tree-sparse LDLᵀ factorization and solves, plain PyTorch, batch-first.

Port of ``flygym_tpu/engine/linalg.py``. The mass matrix and the contact
Hessian are nonzero only on DoF pairs on one root-to-leaf path of the
kinematic tree, so eliminating DoFs leaves-first produces no fill-in and all
DoFs of one height level eliminate at once.

These functions are the oracles of the CUDA kernels in
``flygym_tpu_torch/csrc/tree_ldl.cu``; the wrappers in
:mod:`flygym_tpu_torch.ops.ldl` run them for CPU tensors only. Their padded
scatters are ``index_add_`` calls with repeated indices, which CUDA
accumulates in an order that changes from run to run, so on the card they
agree with the kernels to rounding, not bit for bit.
"""

from dataclasses import dataclass, fields, replace

import torch

__all__ = ["LdlTables", "tensors_to", "tree_ldl_factor", "tree_ldl_solve"]


def tensors_to(obj, device):
    """A copy of a frozen dataclass with its tensors, tuples of tensors and
    nested ``.to``-able fields moved to ``device``."""
    moved = {}
    for f in fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, tuple) and v and isinstance(v[0], torch.Tensor):
            v = tuple(t.to(device) for t in v)
        elif hasattr(v, "to"):
            v = v.to(device)
        moved[f.name] = v
    return replace(obj, **moved)


@dataclass(frozen=True)
class LdlTables:
    """Static structure of a model's tree LDL, as tensors on one device.

    ``dof_anc`` and the level lists drive the plain functions below; the
    int32 CSR tables drive the CUDA kernels.
    """

    nv: int
    maxc: int
    dof_anc: torch.Tensor  # (nv, maxc) int64, ancestors root→self, -1 padded
    height_levels: tuple  # tuple of (k,) int64 tensors, leaves → root
    depth_levels: tuple  # tuple of (k,) int64 tensors, root → leaves
    order_height: torch.Tensor  # (nv,) int32: height levels concatenated
    order_depth: torch.Tensor  # (nv,) int32: depth levels concatenated
    chain_ptr: torch.Tensor  # (nv + 1,) int32 CSR offsets into chain_idx
    chain_idx: torch.Tensor  # (sum of chain lengths,) int32

    @classmethod
    def from_static(cls, nv, dof_chains, dof_height_levels, dof_depth_levels):
        maxc = max((len(c) for c in dof_chains), default=1) or 1
        anc = torch.full((nv, maxc), -1, dtype=torch.int64)
        for i, chain in enumerate(dof_chains):
            anc[i, : len(chain)] = torch.tensor(chain, dtype=torch.int64)
        ptr = [0]
        for chain in dof_chains:
            ptr.append(ptr[-1] + len(chain))
        i32, i64 = torch.int32, torch.int64
        return cls(
            nv=nv,
            maxc=maxc,
            dof_anc=anc,
            height_levels=tuple(torch.tensor(l, dtype=i64) for l in dof_height_levels),
            depth_levels=tuple(torch.tensor(l, dtype=i64) for l in dof_depth_levels),
            order_height=torch.tensor([i for l in dof_height_levels for i in l], dtype=i32),
            order_depth=torch.tensor([i for l in dof_depth_levels for i in l], dtype=i32),
            chain_ptr=torch.tensor(ptr, dtype=i32),
            chain_idx=torch.tensor([a for c in dof_chains for a in c], dtype=i32),
        )

    def to(self, device) -> "LdlTables":
        return tensors_to(self, device)


def tree_ldl_factor(tables: LdlTables, A: torch.Tensor):
    """Factor A = L D Lᵀ exploiting kinematic-tree sparsity.

    Args:
        A: (B, nv, nv) SPD matrices with tree sparsity.

    Returns:
        L: (B, nv, maxc) unit-lower rows stored over each DoF's ancestor list.
        d: (B, nv) the diagonal.
    """
    B, nv = A.shape[0], tables.nv
    C = tables.maxc
    anc = tables.dof_anc
    n1 = nv + 1
    # A scratch row/column at index nv takes the -1 padded entries.
    Ap = A.new_zeros((B, n1, n1))
    Ap[:, :nv, :nv] = A
    Ap = Ap.reshape(B, n1 * n1)
    anc_s = torch.where(anc >= 0, anc, nv)
    valid = (anc >= 0).to(A.dtype)

    L = A.new_zeros((B, nv, C))
    d = A.new_ones((B, nv))
    for idx in tables.height_levels:  # leaves → root
        a_idx = anc_s[idx]  # (k, C)
        v_idx = valid[idx]
        di = Ap[:, idx * n1 + idx]  # (B, k)
        rows = Ap[:, idx[:, None] * n1 + a_idx] * v_idx  # (B, k, C)
        Li = rows / di[..., None]
        # Rank-1 downdates of the ancestor blocks of the whole level at once;
        # repeated (root) entries accumulate in index_add_.
        outer = Li[..., :, None] * rows[..., None, :]  # (B, k, C, C)
        mask2 = v_idx[:, :, None] * v_idx[:, None, :]
        flat = a_idx[:, :, None] * n1 + a_idx[:, None, :]
        Ap.index_add_(1, flat.reshape(-1), (-outer * mask2).reshape(B, -1))
        L[:, idx] = Li
        d[:, idx] = di
    return L, d


def tree_ldl_solve(tables: LdlTables, L: torch.Tensor, d: torch.Tensor, b: torch.Tensor):
    """Solve A x = b given the tree LDLᵀ factor. b: (B, nv) → x: (B, nv)."""
    B, nv = b.shape[0], tables.nv
    anc = tables.dof_anc
    anc_s = torch.where(anc >= 0, anc, nv)
    valid = (anc >= 0).to(b.dtype)

    # Pass 1, leaves → root: y_i is final at its height level and pushes its
    # contribution to its ancestors.
    y = b.new_zeros((B, nv + 1))
    y[:, :nv] = b
    for idx in tables.height_levels:
        yi = y[:, idx]
        contrib = L[:, idx] * yi[..., None] * valid[idx]  # (B, k, C)
        y.index_add_(1, anc_s[idx].reshape(-1), -contrib.reshape(B, -1))

    z = y.clone()
    z[:, :nv] = y[:, :nv] / d

    # Pass 2, root → leaves: gather from already-final ancestors.
    for idx in tables.depth_levels:
        gathered = z[:, anc_s[idx]] * valid[idx]
        z[:, idx] = z[:, idx] + -torch.sum(L[:, idx] * gathered, dim=-1)
    return z[:, :nv]
