#!/usr/bin/env python3
"""Time the engine paths of two checkouts of the port in turns, on one card.

The engine path (the eager engine step with the tree-LDL kernels K1 and
K1b) of the benchmark fly and of the strict fly (the exact Newton: 10 K1
and 10 K1b launches per step), at 4096 worlds, with ``chip_smoke.py``'s
protocols (phase 5: 100 settle + 200 replay steps; phase 20: 10 settle + 20
replay steps) and its launch-count checks. Run from the repository root on
a machine with the card:

    python3 scripts/engine_path_turns.py OLD_ROOT NEW_ROOT

where each root holds a checkout (``git archive``) of the repository. Each
measurement runs in a process of its own that imports the package of its
root, in the order old, new, new, old; each prints its world-steps/s, and
the last line is a JSON summary with the card's name and power limit.
``--one ROOT`` makes one measurement.
"""

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
PATHS = {"engine": ("BENCHMARK", 100, 200, 1, 2), "strict engine": ("STRICT_FLY", 10, 20, 10, 10)}


def measure(root: Path) -> dict:
    """world-steps/s of each path of ``root``'s package, and its card."""
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(HERE))
    import flygym_tpu_torch
    from flygym_tpu_torch.compose import bridge

    import chip_smoke

    rates = {}
    for label, (asset, settle, steps, k1, k1b) in PATHS.items():
        compiled = (flygym_tpu_torch.load_compiled() if asset == "BENCHMARK"
                    else flygym_tpu_torch.load_compiled(getattr(bridge, asset)))
        n = settle + steps
        _counts, wall = chip_smoke.phase_slice(
            compiled, label=label, megastep=False, settle=settle, steps=steps,
            want={"megastep": 0, "tree_ldl_factor": k1 * n, "tree_ldl_solve": k1b * n})
        rates[label] = steps * chip_smoke.N_WORLDS / wall
    return {"root": str(root), "rates": rates, "card": chip_smoke.card_line()}


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(measure(Path(sys.argv[2]).resolve())))
        return 0
    old, new = (Path(a).resolve() for a in sys.argv[1:3])
    runs = []
    for root in (old, new, new, old):
        proc = subprocess.run([sys.executable, __file__, "--one", str(root)],
                              capture_output=True, text=True, timeout=900)
        print(proc.stdout, end="")
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    summary = {label: {"old": [r["rates"][label] for r in runs if r["root"] == str(old)],
                       "new": [r["rates"][label] for r in runs if r["root"] == str(new)]}
               for label in PATHS}
    print(json.dumps({"world_steps_per_s": summary, "card": runs[0]["card"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
