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

import numpy as np
import torch

__all__ = [
    "LdlTables",
    "ALIGN",
    "SECTIONS",
    "kernel_tables",
    "pack_kernel_tables",
    "tensors_to",
    "tree_ldl_factor",
    "tree_ldl_solve",
]


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


# The sections of the CUDA kernels' table buffer, in the order of the enum
# Section in csrc/tree_ldl.cu.
SECTIONS = (
    "env_src", "scale_ptr", "scale",
    "f_rec_ptr", "f_rec", "f_round_ptr", "f_round", "f_more",
    "s_rec_ptr", "s_rec", "s_round_ptr", "s_round", "s_more",
    "depth_ptr", "order_depth", "chain_ptr", "chain_idx", "chain_dof",
)
ALIGN = 4  # each section starts on a 16-byte boundary of the buffer


def _csr(groups) -> np.ndarray:
    return np.cumsum([0, *map(len, groups)]).astype(np.int64)


def _pack16(lo, hi) -> int:
    """Two offsets in one int32 word, ``lo`` in the low 16 bits (read as
    unsigned by the kernels)."""
    return int(np.uint32(lo | (hi << 16)).view(np.int32))


def _owner_tables(levels) -> dict:
    """Records and rounds of owner tables. ``levels``: per level, the
    targets with their contributions in order (the most contributions
    first). A target's record is two words, its own (lo) with its count
    (hi), and its first contribution; its q-th contribution (q >= 1) lies
    in ``more`` at ``round[q - 1] + k``, k its record's index: round q of a
    level holds the q-th contributions of its first targets, a prefix."""
    rec, rounds, more, k0 = [], [], [], 0
    for level in levels:
        for target, src in level:
            rec += [_pack16(target, len(src)), src[0]]
        depth = max((len(src) for _, src in level), default=0)
        rounds.append([])
        for q in range(1, depth):
            rounds[-1].append(len(more) - k0)
            more += [src[q] for _, src in level if len(src) > q]
        k0 += len(level)
    return {"rec_ptr": _csr(levels), "rec": rec, "round_ptr": _csr(rounds),
            "round": [r for lvl in rounds for r in lvl], "more": more}


def kernel_tables(nv, dof_chains, dof_height_levels, dof_depth_levels) -> dict:
    """The CUDA kernels' schedule of the tree LDL, as int32 arrays.

    A world's envelope is packed row by row: row ``a`` starts at
    ``chain_ptr[a] + a`` and holds H[a, chain(a)] (root first), then H[a, a];
    L is packed over the chains as ``chain_idx`` is. The factor eliminates
    one height level at a time: the level's L entries (``scale``: {L offset
    | DoF << 16, the envelope offset of the DoF's diagonal}), then its
    downdates through owner tables: each target (an envelope offset) takes
    its contributions (L offset | envelope offset << 16, the two factors of
    ``L[i, ca] * A[i, cb]``) in elimination order, which is the order of the
    serial elimination, so each entry sees the same roundings. The solve's first pass does the same per height level
    (target: a DoF; contribution: L offset | source DoF << 16). A level's
    targets come with the most contributions first, so that the lanes that
    take the shared root entries also take fewer others, and the ``f_*`` and
    ``s_*`` sections keep them as :func:`_owner_tables` lays them out.

    Returns:
        ``{name: (n,) int32}`` for each name in :data:`SECTIONS`.
    """
    chains = [list(c) for c in dof_chains]
    chain_ptr = _csr(chains)
    row = lambda a: int(chain_ptr[a]) + a
    env = {}  # (row, col) -> envelope offset
    for a, ch in enumerate(chains):
        env.update({(a, b): row(a) + c for c, b in enumerate(ch)})
        env[(a, a)] = row(a) + len(ch)
    t = {
        "env_src": [a * nv + b for (a, b) in sorted(env, key=env.get)],
        "depth_ptr": _csr(dof_depth_levels),
        "order_depth": [i for level in dof_depth_levels for i in level],
        "chain_ptr": chain_ptr,
        "chain_idx": [a for ch in chains for a in ch],
        "chain_dof": [i for i, ch in enumerate(chains) for _ in ch],
    }
    scale, f_levels, s_levels = [], [], []
    for level in dof_height_levels:
        scale.append([(_pack16(int(chain_ptr[i]) + c, i), env[(i, i)]) for i in level
                      for c in range(len(chains[i]))])
        f, s = {}, {}  # target -> contributions, in elimination order
        for i in level:
            ch, p0 = chains[i], int(chain_ptr[i])
            for ca, a in enumerate(ch):
                s.setdefault(a, []).append(_pack16(p0 + ca, i))
                for cb in range(ca + 1):
                    f.setdefault(env[(a, ch[cb])], []).append(
                        _pack16(p0 + ca, env[(i, ch[cb])]))
        f_levels.append(sorted(f.items(), key=lambda kv: -len(kv[1])))
        s_levels.append(sorted(s.items(), key=lambda kv: -len(kv[1])))
    t["scale_ptr"], t["scale"] = _csr(scale), [w for lvl in scale for e in lvl for w in e]
    for pre, levels in (("f", f_levels), ("s", s_levels)):
        t.update({f"{pre}_{k}": v for k, v in _owner_tables(levels).items()})
    return {name: np.asarray(t[name], dtype=np.int64).astype(np.int32) for name in SECTIONS}


def pack_kernel_tables(tables: dict) -> np.ndarray:
    """:func:`kernel_tables` in one int32 buffer: a head of the sections'
    offsets (len(SECTIONS) + 1 words, the last the buffer's length) and
    lengths (len(SECTIONS) words), then the sections in :data:`SECTIONS`
    order, each from a multiple of ALIGN words (zero padding between)."""
    pad = lambda n: -(-n // ALIGN) * ALIGN
    head = 2 * len(SECTIONS) + 1
    offsets, at = [], pad(head)
    for name in SECTIONS:
        offsets.append(at)
        at = pad(at + len(tables[name]))
    buf = np.zeros(at, np.int32)
    buf[:head] = offsets + [at] + [len(tables[name]) for name in SECTIONS]
    for name, off in zip(SECTIONS, offsets):
        buf[off : off + len(tables[name])] = tables[name]
    return buf


@dataclass(frozen=True)
class LdlTables:
    """Static structure of a model's tree LDL, as tensors on one device.

    ``dof_anc`` and the level lists drive the plain functions below;
    ``kernel`` (:func:`kernel_tables` in one buffer) drives the CUDA kernels.
    """

    nv: int
    maxc: int
    dof_anc: torch.Tensor  # (nv, maxc) int64, ancestors root→self, -1 padded
    height_levels: tuple  # tuple of (k,) int64 tensors, leaves → root
    depth_levels: tuple  # tuple of (k,) int64 tensors, root → leaves
    n_chain: int  # entries of the ancestor chains, summed over the DoFs
    n_env: int  # entries of the envelope: nv diagonals and the chains
    kernel: torch.Tensor  # int32: the sections of kernel_tables, one buffer
    env_index: torch.Tensor  # (2, n_env) int64: (row, column) of H of each envelope entry
    env_half: torch.Tensor  # (n_env,) float32: 0.5 on the diagonal's entries, else 1

    @classmethod
    def from_static(cls, nv, dof_chains, dof_height_levels, dof_depth_levels):
        maxc = max((len(c) for c in dof_chains), default=1) or 1
        anc = torch.full((nv, maxc), -1, dtype=torch.int64)
        for i, chain in enumerate(dof_chains):
            anc[i, : len(chain)] = torch.tensor(chain, dtype=torch.int64)
        n_chain = sum(len(c) for c in dof_chains)
        env = [(i, a) for i, chain in enumerate(dof_chains) for a in (*chain, i)]
        env_index = torch.tensor(env, dtype=torch.int64).reshape(-1, 2).T.contiguous()
        return cls(
            nv=nv,
            maxc=maxc,
            dof_anc=anc,
            height_levels=tuple(torch.tensor(l, dtype=torch.int64) for l in dof_height_levels),
            depth_levels=tuple(torch.tensor(l, dtype=torch.int64) for l in dof_depth_levels),
            n_chain=n_chain,
            n_env=nv + n_chain,
            kernel=torch.from_numpy(pack_kernel_tables(
                kernel_tables(nv, dof_chains, dof_height_levels, dof_depth_levels))),
            env_index=env_index,
            env_half=torch.where(env_index[0] == env_index[1], 0.5, 1.0),
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
