"""Launch K1/K1b as they stood before their redesign (``tree_ldl.cu`` beside
this file), the yardstick of ``chip_smoke.py`` phase 2 and of the tests:
``tests/test_torch_kernels.py`` (the card build) and
``tests/test_torch_ldl_redesign.py`` (the host build, g++).

The before kernels take world-minor (rows, B) buffers and four int32 CSR
tables, which the shipped ``LdlTables`` no longer carry: :func:`csr_tables`
makes them from its ancestor lists and levels. :class:`BeforeBuild` holds
the buffers, made once; its launches count nowhere. This file is in no
package: its users load it by its path (``importlib.util``).
"""

from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().with_name("tree_ldl.cu")


def csr_tables(tables) -> dict:
    """The before kernels' tables, int32 on ``tables``' device: the height
    and depth levels concatenated, and the ancestor chains as CSR."""
    anc = tables.dof_anc
    n = (anc >= 0).sum(1)
    i32, dev = torch.int32, tables.kernel.device
    return {
        "order_height": torch.cat(tables.height_levels).to(dev, i32),
        "order_depth": torch.cat(tables.depth_levels).to(dev, i32),
        "chain_ptr": torch.cat([n.new_zeros(1), n.cumsum(0)]).to(dev, i32),
        "chain_idx": anc[anc >= 0].to(dev, i32),
    }


class BeforeBuild:
    """K1 and K1b of the before build ``lib`` (``_build.load_ldl(SOURCE)``,
    or ``_build.build_ldl_host(SOURCE)`` with ``host``) on world-minor
    buffers for H (B, nv, nv) and b (B, nv).

    :meth:`copy_H` and :meth:`copy_b` make the copies the before wrapper
    made (H and b transposed); :meth:`factor` and :meth:`solve` launch one
    kernel each and return its error code. The factor destroys its working
    copy of H, so a repeated factor without :meth:`copy_H` works on what the
    last one left: the same bytes and operations on other values.
    :meth:`outputs` gives L, d and x batch-first (views).
    """

    def __init__(self, lib, tables, H: torch.Tensor, b: torch.Tensor, host: bool = False):
        B, nv, maxc = H.shape[0], tables.nv, tables.maxc
        self.lib, self.host, self.H, self.b = lib, host, H, b
        self.shape = (nv, maxc, B)
        self.csr = csr_tables(tables)
        self.work = H.new_empty((nv * nv, B))
        self.L, self.d = H.new_empty((nv * maxc, B)), H.new_empty((nv, B))
        self.bt, self.x = b.new_empty((nv, B)), b.new_empty((nv, B))
        self.copy_H()
        self.copy_b()

    def copy_H(self) -> None:
        B, nv = self.H.shape[0], self.shape[0]
        self.work.copy_(self.H.reshape(B, nv * nv).t())

    def copy_b(self) -> None:
        self.bt.copy_(self.b.t())

    def _tail(self):
        c = self.csr
        tail = (c["chain_ptr"].data_ptr(), c["chain_idx"].data_ptr(), *self.shape)
        return tail if self.host else (*tail, torch.cuda.current_stream().cuda_stream)

    def factor(self) -> int:
        fn = (self.lib.tree_ldl_before_factor_host_f32 if self.host
              else self.lib.tree_ldl_before_factor_f32)
        return fn(self.work.data_ptr(), self.L.data_ptr(), self.d.data_ptr(),
                  self.csr["order_height"].data_ptr(), *self._tail())

    def solve(self) -> int:
        fn = (self.lib.tree_ldl_before_solve_host_f32 if self.host
              else self.lib.tree_ldl_before_solve_f32)
        return fn(self.L.data_ptr(), self.d.data_ptr(), self.bt.data_ptr(), self.x.data_ptr(),
                  self.csr["order_height"].data_ptr(), self.csr["order_depth"].data_ptr(),
                  *self._tail())

    def outputs(self):
        nv, maxc, B = self.shape
        return self.L.view(nv, maxc, B).permute(2, 0, 1), self.d.t(), self.x.t()

    def run(self):
        """The copies, both launches, and L, d, x batch-first."""
        self.copy_H()
        self.copy_b()
        if self.factor() != 0 or self.solve() != 0:
            raise RuntimeError("K1/K1b before the redesign: launch failed")
        return self.outputs()
