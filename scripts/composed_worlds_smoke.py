#!/usr/bin/env python3
"""``chip_smoke.py``'s phases 45-48 alone, on one CUDA card: the worlds the
PyTorch port composes and compiles itself (the benchmark world and
``make_model``'s options, the fly with every biological joint, the tethered
and blocks-terrain worlds) at 4096 worlds, and the benchmark world's MJCF.

It builds the K2 headers those phases need (and K1/K1b/K3's library), all
at once, then calls the phases' functions of ``chip_smoke.py``. A quick
check of the compose layer on the card (~100 s of command time on an H100,
against ~15 minutes for the whole smoke). Run from the repository root::

    python3 scripts/composed_worlds_smoke.py
"""

import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    from flygym_tpu_torch import load_compiled
    from flygym_tpu_torch.compose.bridge import TERRAIN_FLY, TETHERED_FLY
    from flygym_tpu_torch.ops import _build, megastep

    if not torch.cuda.is_available():
        print("composed_worlds_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    composed = cs.compose_all()
    models = {f"composed {n}": w.compiled.model for n, (_f, w) in composed.items()
              if megastep.megastep_supported(w.compiled.model)}
    models["tethered file"] = load_compiled(TETHERED_FLY).model
    models["terrain file"] = load_compiled(TERRAIN_FLY).model
    headers = {n: megastep.model_header(m)[0] for n, m in models.items()}

    def timed(fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(headers) + 1) as pool:
        jobs = {"K1, K1b, K3": pool.submit(timed, _build.build)}
        jobs.update({f"K2, {n}": pool.submit(timed, _build.build_megastep, h)
                     for n, h in headers.items()})
        for name, job in jobs.items():
            print(f"[build] {name} in {job.result():.1f} s", flush=True)
    for name, header in headers.items():
        for line in _build.ptxas_report(header).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] K2 {name} ptxas: {line.strip()}")
    cs.lap("the builds")
    try:
        k2, counts, bench_sim = cs.phase_composed_benchmark(composed["benchmark"][1])
        cs.lap("phase 45")
        cs.phase_composed_options(composed, bench_sim)
        del bench_sim
        cs.lap("phase 46")
        cs.phase_all_biological(*composed["all_biological"])
        cs.phase_composed_against_files(composed)
        cs.lap("phase 47")
        cs.phase_mjcf(composed["benchmark"][1])
        cs.lap("phase 48")
    except cs.PhaseFailed as e:
        print(f"composed_worlds_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(cs.k2_entry("megastep_composed", k2, counts["megastep"], cs.MEGASTEP_K))
    return 0


if __name__ == "__main__":
    sys.exit(main())
