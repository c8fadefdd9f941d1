#!/usr/bin/env python3
"""``chip_smoke.py``'s phases 49-51 alone, on one CUDA card: the tree-LDL
solve under autograd at 4096 worlds, gradients through the engine step (the
JAX differentiable test's capsule, the benchmark fly, example 10 reduced)
and the pose conversion. Then, unless ``--no-full``, example 10's own
400-step loss for two iterations (``demo/gradient_optimization.main(400,
2)``): the seconds an iteration of the full example takes on the card.

It builds K1/K1b/K3's library and K2 for the benchmark fly (phase 49 feeds
K2 an input that requires grad), at once, then calls the phases' functions
of ``chip_smoke.py``. Run from the repository root::

    python3 scripts/grad_smoke.py [--no-full]
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
    from flygym_tpu_torch.compose.bridge import ENV_FLY
    from flygym_tpu_torch.demo import gradient_optimization as go
    from flygym_tpu_torch.ops import _build, megastep

    if not torch.cuda.is_available():
        print("grad_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    compiled, env_compiled = load_compiled(), load_compiled(ENV_FLY)
    header = megastep.model_header(compiled.model)[0]
    with ThreadPoolExecutor(max_workers=2) as pool:
        jobs = {"K1, K1b, K3": pool.submit(_build.build),
                "K2, benchmark fly": pool.submit(_build.build_megastep, header)}
        for name, job in jobs.items():
            print(f"[build] {name}: {job.result().name}", flush=True)
    cs.lap("the builds")
    try:
        kernels = cs.phase_grad_kernels(compiled.model.to("cuda"), env_compiled)
        cs.lap("phase 49")
        counts = cs.phase_grad_step(compiled)
        cs.lap("phase 50")
        cs.phase_pose_conversion()
        cs.lap("phase 51")
    except cs.PhaseFailed as e:
        print(f"grad_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"[grad smoke] backward K1b: {counts['tree_ldl_solve_backward']} launches on example "
          f"10 reduced; {kernels['ms']:.4f} ms at 4096 worlds (plain {kernels['plain_ms']:.4f} "
          f"ms, bound {kernels['bound'][0]:.4f} ms)")
    if "--no-full" not in sys.argv[1:]:
        t0 = time.perf_counter()
        history = go.main(n_steps=400, n_iters=2, device="cuda")
        print(f"[example 10, 400 steps] 2 iterations in {time.perf_counter() - t0:.1f} s on "
              f"{cs.card_line()}: " + ", ".join(f"{h['seconds']:.2f} s" for h in history))
        cs.lap("example 10 at 400 steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
