"""The benchmark of ``flygym_tpu_torch`` on NVIDIA cards: one run of one cell.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It needs as many CUDA cards as the cell asks
for and exits with code 3, printing no result, otherwise. Its last line on
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared with its limit; the last lines on standard
error give the same numbers. The process exits with code 4 and prints no
result if it holds JAX or the JAX package once the window has closed.
"""

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def _uptime() -> float:
    with open("/proc/uptime") as f:
        return float(f.read().split()[0])


def _since_start():
    """A clock of the seconds since this process started (from
    ``/proc/self/stat``), or since this module was imported where that
    cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        _uptime()
    except (OSError, ValueError, IndexError):
        return lambda: time.perf_counter() - _T_IMPORT
    return lambda: _uptime() - start


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out.splitlines()[0] if out else "power limit not read (nvidia-smi)"


def main(argv=None) -> int:
    since_start = _since_start()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench.registry import Benchmark

    bench = Benchmark()
    try:
        cell = bench.cell(args.workload)
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2
    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from portbench.counts import PEAK_SOURCE
    from portbench.harness import execute, forbidden_modules

    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    result = execute(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda",
                     since_start=since_start, log=log)
    log(f"[portbench] peaks: {PEAK_SOURCE}; this card: {_card_line()}")
    for name, m in result["metrics"].items():
        log(f"[portbench] {name} = {m['value']!r} {m['unit']}")
    found = forbidden_modules()
    if found:
        log(f"[portbench] the process holds {', '.join(found)}: no result")
        return 4
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
