#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each failure ends the run with a non-zero exit code):

0. The card (``nvidia-smi`` name and power limit) and the torch/CUDA versions.
1. Build the CUDA kernels from ``flygym_tpu_torch/csrc`` with nvcc.
2. Hold the tree-LDL factor (K1) and solve (K1b) kernels against their plain
   PyTorch versions at 4096 and at 1000 worlds, within 1e-5 of the largest
   plain value, and time both at 4096 worlds with CUDA events.
3. The main path: the benchmark fly in ``BatchSimulation`` at 4096 worlds,
   adhesion on, a 500-step settle and a timed 1000-step replay of the
   Spotlight clip. All state must be finite, and the kernels' launch counts
   in this run must be 1500 (factor) and 3000 (solve).
4. The golden: 8 worlds from the JAX package's settled state, 50 replay
   steps, against the JAX trajectory to the tolerances the CPU test uses
   (``GOLDEN_TOLERANCE`` in ``flygym_tpu_torch/demo/benchmark.py``).

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

N_WORLDS = 4096
N_STEPS = 1000
SETTLE_STEPS = 500
CHECK_WORLDS = (4096, 1000)
KERNEL_RTOL = 1e-5
TIMED_LAUNCHES = 20


class PhaseFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseFailed(what)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def time_ms(fn, n: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``n`` calls, by CUDA events."""
    import torch

    fn()  # warm up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def phase_kernels(model) -> dict:
    """K1 and K1b against the plain versions; times at N_WORLDS."""
    import torch

    from flygym_tpu_torch.engine import linalg
    from flygym_tpu_torch.ops import ldl

    tables = model.ldl
    err = {"tree_ldl_factor": 0.0, "tree_ldl_solve": 0.0}
    for n in CHECK_WORLDS:
        H, b = ldl.sample_problems(model, n, seed=n)
        L, d = ldl.tree_ldl_factor(tables, H)
        x = ldl.tree_ldl_solve(tables, L, d, b)
        L0, d0 = linalg.tree_ldl_factor(tables, H)
        x0 = linalg.tree_ldl_solve(tables, L0, d0, b)
        torch.cuda.synchronize()
        for name, got, want, kernel in (
            ("L", L, L0, "tree_ldl_factor"),
            ("d", d, d0, "tree_ldl_factor"),
            ("x", x, x0, "tree_ldl_solve"),
        ):
            abs_err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            print(f"[kernels] B={n} {name}: max|kernel-plain| {abs_err:.3e}, "
                  f"max|plain| {scale:.3e}, ratio {abs_err / scale:.3e}")
            check(bool(torch.isfinite(got).all()), f"{name} not finite at B={n}")
            check(abs_err <= KERNEL_RTOL * scale,
                  f"{name} at B={n}: {abs_err:.3e} > {KERNEL_RTOL} * {scale:.3e}")
            err[kernel] = max(err[kernel], abs_err)

    H, b = ldl.sample_problems(model, N_WORLDS, seed=1)
    L, d = ldl.tree_ldl_factor(tables, H)
    times = {}
    # Plain, kernel, kernel, plain: the mean of each pair.
    for kernel, plain, name in (
        (lambda: ldl.tree_ldl_factor(tables, H),
         lambda: linalg.tree_ldl_factor(tables, H), "tree_ldl_factor"),
        (lambda: ldl.tree_ldl_solve(tables, L, d, b),
         lambda: linalg.tree_ldl_solve(tables, L, d, b), "tree_ldl_solve"),
    ):
        p1, k1 = time_ms(plain, TIMED_LAUNCHES), time_ms(kernel, TIMED_LAUNCHES)
        k2, p2 = time_ms(kernel, TIMED_LAUNCHES), time_ms(plain, TIMED_LAUNCHES)
        times[name] = (0.5 * (k1 + k2), 0.5 * (p1 + p2))
        print(f"[kernels] {name} at B={N_WORLDS}: kernel {times[name][0]:.4f} ms, "
              f"plain {times[name][1]:.4f} ms (runs {k1:.4f}/{k2:.4f} and {p1:.4f}/{p2:.4f})")
    return {"err": err, "times": times}


def phase_slice(compiled):
    """The replay benchmark through the kernels; returns the launch counts."""
    import torch

    from flygym_tpu_torch.demo.benchmark import ReplayTargetData, run_simulation
    from flygym_tpu_torch.ops import ldl

    fly = compiled.fly_names[0]
    dof_order = [tuple(d) for d in compiled.flies[fly]["actuated_dofs"]["position"]]
    targets = ReplayTargetData(compiled.model.timestep, dof_order).make_target_angles_all_worlds(
        N_WORLDS, N_STEPS
    )
    ldl.reset_launches()
    t0 = time.perf_counter()
    walltime, sim = run_simulation(
        compiled, targets, device="cuda", warmup_steps=SETTLE_STEPS
    )
    total = time.perf_counter() - t0
    counts = dict(ldl.launches)
    print(f"[slice] {N_WORLDS} worlds: settle {SETTLE_STEPS} + replay {N_STEPS} steps in "
          f"{total:.2f} s; launches {counts}")
    n_total = SETTLE_STEPS + N_STEPS
    check(counts["tree_ldl_factor"] == n_total,
          f"factor launches {counts['tree_ldl_factor']} != {n_total}")
    check(counts["tree_ldl_solve"] == 2 * n_total,
          f"solve launches {counts['tree_ldl_solve']} != {2 * n_total}")
    st = sim.state
    for name in ("qpos", "qvel", "qacc", "xpos", "xquat", "actuator_force", "contact_sensordata"):
        check(bool(torch.isfinite(getattr(st, name)).all()), f"state.{name} not finite")
    check(abs(sim.time - n_total * compiled.model.timestep) < 1e-3, f"time {sim.time}")
    found = st.contact_sensordata[..., 0].mean().item()
    z = st.qpos[:, 2]
    print(f"[slice] root z min/mean/max {z.min().item():.4f}/{z.mean().item():.4f}/"
          f"{z.max().item():.4f} mm, contact found share {found:.3f}, "
          f"max|qvel| {st.qvel.abs().max().item():.2f}")
    rate = N_STEPS * N_WORLDS / walltime
    print(f"[slice] replay {walltime:.3f} s: {rate:.0f} world-steps/s on {card_line()}")
    return counts


def phase_golden(compiled) -> None:
    """8 worlds from the JAX settled state, 50 replay steps vs the JAX trajectory."""
    from flygym_tpu_torch.compose.bridge import load_golden
    from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE, track_golden

    golden = load_golden()
    worst = track_golden(compiled, golden, device="cuda")
    n_worlds, n_steps = golden["targets"].shape[:2]
    print(f"[golden] {n_worlds} worlds x {n_steps} steps vs JAX: max|dqpos| "
          f"{worst['qpos']:.3e}, max|dqvel| {worst['qvel']:.3e}, share of found flags "
          f"differing {worst['found_share']:.4f}; tolerances {GOLDEN_TOLERANCE}")
    for key, tol in GOLDEN_TOLERANCE.items():
        check(worst[key] <= tol, f"golden {key}: {worst[key]:.3e} > {tol}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import flygym_tpu_torch
        from flygym_tpu_torch.ops import _build

        t0 = time.perf_counter()
        lib_path = _build.build()
        _build.load_library()
        print(f"[build] {lib_path.name} in {time.perf_counter() - t0:.2f} s")

        compiled = flygym_tpu_torch.load_compiled()
        kernels = phase_kernels(compiled.model.to("cuda"))
        counts = phase_slice(compiled)
        phase_golden(compiled)
    except (PhaseFailed, ImportError, RuntimeError, ValueError, TypeError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    replaces = {
        "tree_ldl_factor": "flygym_tpu/ops/ldl_pallas.py:54",
        "tree_ldl_solve": "flygym_tpu/ops/ldl_pallas.py:72",
    }
    summary = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": "flygym_tpu_torch/csrc/tree_ldl.cu",
                "replaces": replaces[name],
                "launches": counts[name],
                "max_abs_err": kernels["err"][name],
                "ms": kernels["times"][name][0],
                "plain_ms": kernels["times"][name][1],
            }
            for name in ("tree_ldl_factor", "tree_ldl_solve")
        ]
    }
    print(json.dumps(summary))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
