#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card, and check them.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each failure ends the run with a non-zero exit code):

0. The card (``nvidia-smi`` name and power limit) and the torch/CUDA versions.
1. Build the kernels from ``flygym_tpu_torch/csrc`` with nvcc, the
   tree-LDL library and the mega-step kernel K2 (with the benchmark fly's
   generated header) at once; print each build's seconds and K2's ptxas
   report (registers, stack, spills).
2. Hold the tree-LDL factor (K1) and solve (K1b) kernels against their plain
   PyTorch versions at 4096 and at 1000 worlds, within 1e-5 of the largest
   plain value; time both, their plain versions and ``torch.linalg``'s
   dense LDL at 4096 worlds with CUDA events.
3. Hold K2 against its plain version (``ops/megastep.py:megastep_plain``)
   at 1000 and 4096 worlds from the golden's settled state with the first
   replay targets: one K = 1 launch against one plain step, one K = 8
   launch against 8 chained plain steps (final state and qpos rows); time
   K = 1 and K = 8 launches at 4096 worlds.
4. The main path, the mega-step: the benchmark fly in ``BatchSimulation``
   with its default step at 4096 worlds, adhesion on, a 500-step settle (one
   step per launch: 8 does not divide 500) and a timed 1000-step replay of
   the Spotlight clip (8 steps per launch). K2's launch count must be 625,
   and K1/K1b's 0; all state finite.
5. The engine path (PR 1's): the same width through the eager engine step
   with K1/K1b, at a smaller depth, 100 settle + 200 replay steps; K1 and
   K1b launches must be 300 and 600, K2's 0.
6. The goldens: 8 worlds from the JAX settled state, 50 replay steps, the
   engine path against the JAX engine trajectory and the mega-step path
   against the JAX mega-step emitter's, to ``GOLDEN_TOLERANCE``
   (``flygym_tpu_torch/demo/benchmark.py``).

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

N_WORLDS = 4096
N_STEPS = 1000
SETTLE_STEPS = 500
ENGINE_STEPS = 200
ENGINE_SETTLE_STEPS = 100
MEGASTEP_K = 8
CHECK_WORLDS = (4096, 1000)
KERNEL_RTOL = 1e-5
# K2 against its plain version, as a share of the largest plain value of
# each output. The two run the same fp32 operations in the same order, with
# no fused multiply-adds, true divisions and the same sin/cos, so they agree
# to the last bit where nothing else differs (PERF.md has the measured
# gaps). The bar is one float32 ulp of the largest value, times 8 for the
# fused steps; it is far inside the emitter-vs-engine bars of
# tests/engine/test_megastep.py:120-145 (xpos 1e-5, qpos 1e-6 + 2e-4 dt,
# qvel 1e-3, qacc rtol 6e-3 / atol 0.2, actuator_force 1e-4, sensors 2e-3).
K2_RTOL = 1e-6
TIMED_LAUNCHES = 20
# Peak rates of one H100 SXM (NVIDIA's data sheet): fp32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


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


def time_ms(fn, n: int, warm_up: bool = True) -> float:
    """Mean milliseconds per call of ``fn`` over ``n`` calls, by CUDA events."""
    import torch

    if warm_up:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def bound_ms(ops: float, nbytes: float) -> tuple:
    """The least time for ``ops`` fp32 operations moving ``nbytes``, and
    which of the two bounds it."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_build(compiled) -> None:
    """Both nvcc builds at once, each timed."""
    from flygym_tpu_torch.ops import _build, megastep

    header, _n_scratch = megastep.model_header(compiled.model)

    def timed(fn, *args):
        t0 = time.perf_counter()
        path = fn(*args)
        return path, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=2) as pool:
        ldl_job = pool.submit(timed, _build.build)
        k2_job = pool.submit(timed, _build.build_megastep, header)
        (ldl_path, ldl_s), (k2_path, k2_s) = ldl_job.result(), k2_job.result()
    _build.load_library()
    _build.load_megastep(header)
    print(f"[build] {ldl_path.name} (K1, K1b) in {ldl_s:.2f} s; "
          f"{k2_path.parent.name}/{k2_path.name} (K2) in {k2_s:.2f} s")
    for line in _build.ptxas_report(header).splitlines():
        if any(w in line for w in ("registers", "stack frame", "spill")):
            print(f"[build] K2 ptxas: {line.strip()}")


def ldl_work(tables, B: int) -> dict:
    """Operations and bytes of one factor and one solve at B worlds: the
    tree elimination's multiplies, subtractions and divisions, and each input
    read and each output written once (fp32)."""
    chains = (tables.chain_ptr[1:] - tables.chain_ptr[:-1]).tolist()
    nv, maxc = tables.nv, tables.maxc
    factor_ops = sum(1 + n + n * (n + 1) for n in chains)
    solve_ops = 4 * sum(chains) + nv
    return {
        "tree_ldl_factor": (B * factor_ops, 4 * B * (nv * nv + nv * maxc + nv)),
        "tree_ldl_solve": (B * solve_ops, 4 * B * (nv * maxc + 3 * nv)),
    }


def phase_kernels(model) -> dict:
    """K1 and K1b against the plain versions; times, library times and
    bounds at N_WORLDS."""
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
    LD, pivots = torch.linalg.ldl_factor(H)
    times, library = {}, {}
    # Plain, kernel, kernel, plain: the mean of each pair.
    for kernel, plain, lib, name in (
        (lambda: ldl.tree_ldl_factor(tables, H),
         lambda: linalg.tree_ldl_factor(tables, H),
         lambda: torch.linalg.ldl_factor(H), "tree_ldl_factor"),
        (lambda: ldl.tree_ldl_solve(tables, L, d, b),
         lambda: linalg.tree_ldl_solve(tables, L, d, b),
         lambda: torch.linalg.ldl_solve(LD, pivots, b[..., None]), "tree_ldl_solve"),
    ):
        p1, k1 = time_ms(plain, TIMED_LAUNCHES), time_ms(kernel, TIMED_LAUNCHES)
        k2, p2 = time_ms(kernel, TIMED_LAUNCHES), time_ms(plain, TIMED_LAUNCHES)
        times[name] = (0.5 * (k1 + k2), 0.5 * (p1 + p2))
        library[name] = time_ms(lib, 3)
        print(f"[kernels] {name} at B={N_WORLDS}: kernel {times[name][0]:.4f} ms, "
              f"plain {times[name][1]:.4f} ms (runs {k1:.4f}/{k2:.4f} and {p1:.4f}/{p2:.4f}), "
              f"torch.linalg {library[name]:.4f} ms")
    bounds = {}
    for name, (ops, nbytes) in ldl_work(tables, N_WORLDS).items():
        bounds[name] = bound_ms(ops, nbytes)
        print(f"[kernels] {name} bound at B={N_WORLDS}: {bounds[name][0]:.4f} ms "
              f"({bounds[name][1]}: {ops:.3e} ops, {nbytes:.3e} bytes)")
    return {"err": err, "times": times, "library": library, "bounds": bounds}


def megastep_ops(model) -> int:
    """Elementwise operations of one world-step of K2's plain version (the
    JAX emitter's ops, its structural zeros and ones folded), counted on the
    CPU at one world."""
    import torch
    from torch.overrides import TorchFunctionMode

    from flygym_tpu_torch.engine.model import make_initial_state
    from flygym_tpu_torch.ops import megastep

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor) and func not in (torch.zeros_like, torch.ones_like):
                Count.n += 1
            return out

    cpu = model.to("cpu")
    st = megastep._Static(cpu)
    s = make_initial_state(cpu, 1)
    cols = lambda x: [x[:, i] for i in range(x.shape[1])]
    args = [cols(s.qpos), cols(s.qvel), cols(s.ctrl), cols(s.act), cols(s.qacc)]
    with Count():
        megastep.emit_step(st, *args)
    return Count.n


def k2_inputs(compiled, golden, n_worlds: int, k_steps: int):
    """The golden's settled worlds repeated to ``n_worlds`` on the card,
    with the first ``k_steps`` replay targets as a (K, B, nu) control
    sequence; the state carries the first."""
    import torch

    idx = torch.arange(n_worlds) % golden["targets"].shape[0]
    state = golden["state"].map(lambda x: x[idx].clone()).to("cuda")
    ids = torch.tensor(compiled.flies[compiled.fly_names[0]]["act_ids"]["position"], device="cuda")
    targets = torch.as_tensor(golden["targets"][:, :k_steps])[idx].cuda()
    seq = state.ctrl.expand((k_steps,) + state.ctrl.shape).clone()
    seq[:, :, ids] = targets.transpose(0, 1)
    return replace(state, ctrl=seq[0]), seq


def phase_megastep(compiled, model) -> dict:
    """K2 against its plain version; times and bound at N_WORLDS."""
    import torch

    from flygym_tpu_torch.compose.bridge import load_golden
    from flygym_tpu_torch.ops import megastep

    golden = load_golden()
    fns = {k: megastep.make_megastep(model, k) for k in (1, MEGASTEP_K)}
    fields = ("qpos", "qvel", "qacc", "xpos", "xquat", "actuator_force", "contact_sensordata")
    worst = 0.0
    for n in CHECK_WORLDS:
        for k, fn in fns.items():
            state, seq = k2_inputs(compiled, golden, n, k)
            pairs = []
            if k == 1:
                got, want = fn(state), megastep.megastep_plain(fn.static, state)
            else:
                (got, traj), (want, wtraj) = fn(state, seq), megastep.megastep_plain(
                    fn.static, state, seq)
                pairs.append(("qpos rows", traj, wtraj))
            torch.cuda.synchronize()
            pairs += [(f, getattr(got, f), getattr(want, f)) for f in fields]
            gaps = []
            for name, a, b in pairs:
                gap, scale = (a - b).abs().max().item(), b.abs().max().item()
                check(bool(torch.isfinite(a).all()), f"K2 {name} not finite at B={n}, K={k}")
                check(gap <= K2_RTOL * scale,
                      f"K2 {name} at B={n}, K={k}: {gap:.3e} > {K2_RTOL} * {scale:.3e}")
                worst = max(worst, gap)
                gaps.append(f"{name} {gap:.2e}/{scale:.2e}")
            print(f"[megastep] B={n} K={k} max|kernel-plain|/max|plain|: " + ", ".join(gaps))

    times = {}
    for k, fn in fns.items():
        state, seq = k2_inputs(compiled, golden, N_WORLDS, k)
        kernel = (lambda: fn(state)) if k == 1 else (lambda: fn(state, seq))
        plain = (lambda: megastep.megastep_plain(fn.static, state)) if k == 1 else (
            lambda: megastep.megastep_plain(fn.static, state, seq))
        # Kernel, plain, kernel; the plain version was warmed by the check.
        k1 = time_ms(kernel, TIMED_LAUNCHES)
        p = time_ms(plain, 1, warm_up=False)
        k2 = time_ms(kernel, TIMED_LAUNCHES, warm_up=False)
        times[k] = (0.5 * (k1 + k2), p)
        print(f"[megastep] K={k} at B={N_WORLDS}: kernel {times[k][0]:.3f} ms per launch "
              f"(runs {k1:.3f}/{k2:.3f}), plain {p:.1f} ms")

    ops = megastep_ops(model)
    n_in, n_out = megastep._io_rows(fns[MEGASTEP_K].static, MEGASTEP_K)
    total_ops = ops * MEGASTEP_K * N_WORLDS
    nbytes = 4 * (n_in + n_out) * N_WORLDS
    bound = bound_ms(total_ops, nbytes)
    print(f"[megastep] {ops} ops per world-step; K={MEGASTEP_K} launch at B={N_WORLDS}: "
          f"bound {bound[0]:.4f} ms ({bound[1]}: {total_ops:.3e} ops, {nbytes:.3e} bytes), "
          f"{times[MEGASTEP_K][0] / bound[0]:.0f}x the bound")
    return {"err": worst, "times": times, "bound": bound}


def reset_counts() -> None:
    from flygym_tpu_torch.ops import ldl, megastep

    ldl.reset_launches()
    megastep.reset_launches()


def read_counts() -> dict:
    from flygym_tpu_torch.ops import ldl, megastep

    return {**ldl.launches, **megastep.launches}


def phase_slice(compiled, *, label: str, megastep, settle: int, steps: int, want: dict):
    """The replay benchmark at N_WORLDS through one path; returns the
    launch counts and the replay's walltime."""
    import torch

    from flygym_tpu_torch.demo.benchmark import ReplayTargetData, run_simulation

    fly = compiled.fly_names[0]
    dof_order = [tuple(d) for d in compiled.flies[fly]["actuated_dofs"]["position"]]
    targets = ReplayTargetData(compiled.model.timestep, dof_order).make_target_angles_all_worlds(
        N_WORLDS, steps
    )
    reset_counts()
    t0 = time.perf_counter()
    walltime, sim = run_simulation(
        compiled, targets, device="cuda", warmup_steps=settle, megastep=megastep
    )
    total = time.perf_counter() - t0
    counts = read_counts()
    print(f"[{label}] {N_WORLDS} worlds: settle {settle} + replay {steps} steps in "
          f"{total:.2f} s; launches {counts}")
    for name, n in want.items():
        check(counts[name] == n, f"{label}: {name} launches {counts[name]} != {n}")
    st = sim.state
    for name in ("qpos", "qvel", "qacc", "xpos", "xquat", "actuator_force", "contact_sensordata"):
        check(bool(torch.isfinite(getattr(st, name)).all()), f"{label}: state.{name} not finite")
    check(abs(sim.time - (settle + steps) * compiled.model.timestep) < 1e-3, f"time {sim.time}")
    found = st.contact_sensordata[..., 0].mean().item()
    z = st.qpos[:, 2]
    print(f"[{label}] root z min/mean/max {z.min().item():.4f}/{z.mean().item():.4f}/"
          f"{z.max().item():.4f} mm, contact found share {found:.3f}, "
          f"max|qvel| {st.qvel.abs().max().item():.2f}")
    rate = steps * N_WORLDS / walltime
    print(f"[{label}] replay {walltime:.3f} s, {walltime / steps * 1e3:.3f} ms per step: "
          f"{rate:.0f} world-steps/s on {card_line()}")
    return counts, walltime


def phase_golden(compiled, *, label: str, golden_path, megastep: bool) -> None:
    """8 worlds from the JAX settled state, 50 replay steps vs a JAX trajectory."""
    from flygym_tpu_torch.compose.bridge import load_golden
    from flygym_tpu_torch.demo.benchmark import GOLDEN_TOLERANCE, track_golden

    golden = load_golden(golden_path)
    worst = track_golden(compiled, golden, device="cuda", megastep=megastep)
    n_worlds, n_steps = golden["targets"].shape[:2]
    print(f"[{label}] {n_worlds} worlds x {n_steps} steps vs JAX: max|dqpos| "
          f"{worst['qpos']:.3e}, max|dqvel| {worst['qvel']:.3e}, share of found flags "
          f"differing {worst['found_share']:.4f}; tolerances {GOLDEN_TOLERANCE}")
    for key, tol in GOLDEN_TOLERANCE.items():
        check(worst[key] <= tol, f"{label} {key}: {worst[key]:.3e} > {tol}")


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
        from flygym_tpu_torch.compose.bridge import BENCHMARK_GOLDEN, ASSETS

        compiled = flygym_tpu_torch.load_compiled()
        phase_build(compiled)
        model = compiled.model.to("cuda")
        kernels = phase_kernels(model)
        k2 = phase_megastep(compiled, model)
        mega_counts, mega_wall = phase_slice(
            compiled, label="megastep", megastep=None, settle=SETTLE_STEPS, steps=N_STEPS,
            want={"megastep": SETTLE_STEPS + N_STEPS // MEGASTEP_K,
                  "tree_ldl_factor": 0, "tree_ldl_solve": 0},
        )
        busy = (N_STEPS // MEGASTEP_K) * k2["times"][MEGASTEP_K][0] / (mega_wall * 1e3)
        print(f"[megastep] device busy share of the replay: {busy:.3f} "
              f"({N_STEPS // MEGASTEP_K} launches x {k2['times'][MEGASTEP_K][0]:.3f} ms "
              f"over {mega_wall:.3f} s)")
        engine_counts, _wall = phase_slice(
            compiled, label="engine", megastep=False, settle=ENGINE_SETTLE_STEPS,
            steps=ENGINE_STEPS,
            want={"megastep": 0, "tree_ldl_factor": ENGINE_SETTLE_STEPS + ENGINE_STEPS,
                  "tree_ldl_solve": 2 * (ENGINE_SETTLE_STEPS + ENGINE_STEPS)},
        )
        phase_golden(compiled, label="golden engine", golden_path=BENCHMARK_GOLDEN,
                     megastep=False)
        phase_golden(compiled, label="golden megastep",
                     golden_path=ASSETS / "benchmark_fly_megastep_golden.npz", megastep=True)
    except (PhaseFailed, ImportError, RuntimeError, ValueError, TypeError,
            NotImplementedError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    entries = [
        {
            "name": name,
            "route": "cuda",
            "source": "flygym_tpu_torch/csrc/tree_ldl.cu",
            "replaces": replaces,
            "launches": engine_counts[name],
            "max_abs_err": kernels["err"][name],
            "ms": kernels["times"][name][0],
            "plain_ms": kernels["times"][name][1],
            "bound_ms": kernels["bounds"][name][0],
            "bound_by": kernels["bounds"][name][1],
            "library_ms": kernels["library"][name],
        }
        for name, replaces in (
            ("tree_ldl_factor", "flygym_tpu/ops/ldl_pallas.py:54"),
            ("tree_ldl_solve", "flygym_tpu/ops/ldl_pallas.py:72"),
        )
    ]
    entries.append({
        "name": "megastep",
        "route": "cuda",
        "source": "flygym_tpu_torch/csrc/megastep.cu",
        "replaces": "flygym_tpu/ops/megastep.py:2477",
        "launches": mega_counts["megastep"],
        "max_abs_err": k2["err"],
        "ms": k2["times"][MEGASTEP_K][0],
        "plain_ms": k2["times"][MEGASTEP_K][1],
        "bound_ms": k2["bound"][0],
        "bound_by": k2["bound"][1],
        "library_ms": None,
    })
    print(json.dumps({"kernels": entries}))
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
