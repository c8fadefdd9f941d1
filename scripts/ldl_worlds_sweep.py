#!/usr/bin/env python3
"""Sweep the worlds per block of the tree-LDL kernels K1 and K1b on one card.

``flygym_tpu_torch/csrc/tree_ldl.cu`` runs one warp per world and four
worlds per block (``LDL_WORLDS``). This script builds it with 1, 2, 4 and 8
worlds per block (one nvcc each, all at once), prints each build's ptxas
registers and spills and its launch shape for the benchmark fly, holds each
build's L, d and x equal to the shipped wrappers' to the last bit, and times
each build's factor and solve launches alone at 4096 worlds with CUDA
events, in turns (the builds in order, then reversed). Run from the
repository root on a machine with the card:

    python3 scripts/ldl_worlds_sweep.py

The last line is a JSON summary with the card's name and power limit.
"""

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from flygym_tpu_torch import load_compiled  # noqa: E402
from flygym_tpu_torch.ops import _build, ldl  # noqa: E402

WORLDS = (1, 2, 4, 8)
N_WORLDS = 4096
TIMED_LAUNCHES = 20
KERNEL_NAME = re.compile(r"_Z\w*?((factor|solve)_kernel)\w*")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def time_ms(fn, n: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``n`` calls, by CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def build(worlds: int):
    """The build with ``worlds`` worlds per block, loaded, and its ptxas report."""
    path = _build._build_alone(_build.LDL_SRC, (*_build.NVCC_FLAGS, f"-DLDL_WORLDS={worlds}"),
                               "ldl")
    lib = ctypes.CDLL(str(path))
    _build._ldl_signatures(lib)
    return lib, _build.ptxas_report(library=path)


def main() -> int:
    if not torch.cuda.is_available():
        print("ldl_worlds_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    with ThreadPoolExecutor(max_workers=len(WORLDS)) as pool:
        libs = dict(zip(WORLDS, pool.map(build, WORLDS)))
    model = load_compiled().model.to("cuda")
    tables = model.ldl
    nv, maxc, n_env, n_chain = tables.nv, tables.maxc, tables.n_env, tables.n_chain
    H, b = ldl.sample_problems(model, N_WORLDS, seed=1)
    L0, d0 = ldl.tree_ldl_factor(tables, H)
    want = (L0, d0, ldl.tree_ldl_solve(tables, L0, d0, b))
    stream = torch.cuda.current_stream().cuda_stream
    runs, ok = {}, True
    for w, (lib, ptxas) in libs.items():
        for line in ptxas.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill")):
                line = KERNEL_NAME.sub(r"\1", line.strip())
                print(f"[{w} worlds] ptxas: {line}")
        shape = (ctypes.c_int * 5)()
        assert lib.tree_ldl_shape(nv, n_env, n_chain, ctypes.addressof(shape)) == 0
        print(f"[{w} worlds] {shape[0]} threads; factor {shape[1]} shared bytes per block, "
              f"{shape[2]} blocks per SM; solve {shape[3]} and {shape[4]}")
        L, d, x = torch.empty_like(L0), torch.empty_like(d0), torch.empty_like(b)
        factor = lambda lib=lib, L=L, d=d: lib.tree_ldl_factor_f32(
            H.data_ptr(), L.data_ptr(), d.data_ptr(), tables.kernel.data_ptr(), nv, maxc, n_env,
            n_chain, N_WORLDS, stream)
        solve = lambda lib=lib, L=L, d=d, x=x: lib.tree_ldl_solve_f32(
            L.data_ptr(), d.data_ptr(), b.data_ptr(), x.data_ptr(), tables.kernel.data_ptr(), nv,
            maxc, n_env, n_chain, N_WORLDS, stream)
        assert factor() == 0 and solve() == 0
        torch.cuda.synchronize()
        same = all(torch.equal(g, e) for g, e in zip((L, d, x), want))
        print(f"[{w} worlds] equal to the shipped build: {same}")
        ok &= same
        runs[w] = {"tree_ldl_factor": factor, "tree_ldl_solve": solve}
    result = {}
    for name in ("tree_ldl_factor", "tree_ldl_solve"):
        turns = {w: [] for w in WORLDS}
        for w in [*WORLDS, *reversed(WORLDS)]:
            turns[w].append(time_ms(runs[w][name], TIMED_LAUNCHES))
        for w, t in turns.items():
            print(f"[{w} worlds] {name} at B={N_WORLDS}, launch alone: {sum(t) / 2:.4f} ms "
                  f"(turns {' / '.join(f'{x:.4f}' for x in t)})")
        result[name] = {str(w): t for w, t in turns.items()}
    print(json.dumps({"card": card, "equal": ok, "ms": result}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
