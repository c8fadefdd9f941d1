"""K2 as it stood before its redesign (``scripts/k2_before_redesign``: one
world per thread, scratch rows in global memory, with its own model header
for the benchmark fly), which ``chip_smoke.py`` profiles beside the shipped
kernel: compiled as host C++ (g++), it takes the shipped kernel's input
pack and gives the shipped kernel's outputs to the last bit, so its phase
profile is one of the same computation. CPU only."""

import ctypes
import dataclasses
import re
from pathlib import Path

import torch

from flygym_tpu_torch import load_compiled
from flygym_tpu_torch.compose.bridge import load_golden
from flygym_tpu_torch.ops import _build
from flygym_tpu_torch.ops import megastep as ms

BEFORE = Path(__file__).resolve().parents[1] / "scripts" / "k2_before_redesign"
B, K = 2, 2


def _before_host_build(header: str) -> ctypes.CDLL:
    src = BEFORE / "megastep.cu"
    d = _build._megastep_dir(header, _build.GXX_FLAGS, src)
    out = d / "libmegastep_host.so"
    if not out.exists():
        _build._compile([_build._gxx(), *_build.GXX_FLAGS, "-I", str(d)], out, [src],
                        "megastep_before_host")
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.megastep_host_f32.argtypes = [p, p, p, i, i]
    lib.megastep_host_f32.restype = i
    return lib


def test_kernel_before_the_redesign_equals_the_shipped_kernel():
    compiled = load_compiled()
    golden = load_golden()
    static = ms._Static(compiled.model)
    state = golden["state"].map(lambda x: x[:B].clone())
    ids = torch.tensor(compiled.flies[compiled.fly_names[0]]["act_ids"]["position"])
    seq = state.ctrl.expand((K,) + state.ctrl.shape).clone()
    seq[:, :, ids] = torch.as_tensor(golden["targets"][:B, :K]).transpose(0, 1)
    state = dataclasses.replace(state, ctrl=seq[0])
    packed = ms._pack(static, state, seq, None, K)
    n_out = ms._io_rows(static, K)[1]

    header = (BEFORE / "megastep_model.h").read_text()
    n_scratch = int(re.search(r"N_SCRATCH = (\d+);", header).group(1))
    before, scratch = torch.zeros((n_out, B)), torch.zeros((n_scratch, B))
    lib = _before_host_build(header)
    assert lib.megastep_host_f32(packed.data_ptr(), before.data_ptr(), scratch.data_ptr(),
                                 B, K) == 0

    layout = ms.scratch_layout(compiled.model)
    shipped = torch.zeros((n_out, B))
    scratch = torch.zeros(B * (layout["n_shared"] + layout["n_global"]))
    lib = _build.build_megastep_host(ms.model_header(compiled.model)[0])
    assert lib.megastep_host_f32(packed.data_ptr(), shipped.data_ptr(), scratch.data_ptr(),
                                 B, K, 0) == 0
    assert torch.isfinite(shipped).all()
    assert torch.equal(before, shipped)
