"""The controls of ``correct``: the program's readings and a lower
precision's, from the same set-up, on several seeds in one process.

    python -m portbench.control --workload <cell> --seeds 1,2,3 [--seconds 2] [--controls bfloat16,tf32]

For each seed it sets the cell up, runs a short window at the cell's own
load, and prints one JSON line with the program's readings (``sound``) and
those of the reference computed in each control's precision (``bfloat16``:
every float32 result rounded to bfloat16; ``tf32``: float32 products in
TF32) in the program's place. A control's readings must fail the cell's
limits (``correct`` false); the limits sit between the two. The benchmark's
own runs never run this.
"""

import argparse
import json
import sys

import torch

from portbench.compare import verdict
from portbench.harness import no_span
from portbench.reference.runner import CONTROLS
from portbench.registry import Benchmark


def readings(bench, cell: dict, seed: int, seconds: float, device, controls,
             overrides=None, driver_kw=None) -> dict:
    """The program's and each control's ``{name: value}`` and verdicts."""
    mix = {**bench.traffic(cell["traffic"]), **(overrides or {})}
    run = bench.driver(mix["driver"]).setup(bench.config(cell["config"]), mix, seed, device,
                                            **(driver_kw or {}))
    run.window(seconds, no_span)
    run.free()
    out = {"workload": cell["name"], "seed": seed}
    for control in (None, *controls):
        checks = run.check(control)
        out[control or "sound"] = {"correct": verdict(checks),
                                   "values": {n: v for n, v, _l in checks},
                                   "limits": {n: lim for n, _v, lim in checks}}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--controls", default=",".join(CONTROLS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    bench = Benchmark()
    cell = bench.cell(args.workload)
    controls = [c for c in args.controls.split(",") if c]
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(bench, cell, seed, args.seconds, "cuda", controls)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
