#!/usr/bin/env python3
"""Time config 3's closed loop of two checkouts of the port in turns, on one card.

Config 3 is example 08's hybrid controller walking the benchmark fly over
blocks terrain (``demo/hybrid_terrain.py``), at 4096 worlds, with
``chip_smoke.py``'s phase 11 protocol: adhesion on, the roots spread, a
504-step settle through ``rollout``, then 1000 timed closed-loop steps (one
K = 1 K2 launch each, the planes resampled every 8 steps). Run from the
repository root on a machine with the card:

    python3 scripts/config3_turns.py OLD_ROOT NEW_ROOT

where each root holds a checkout (``git archive``) of the repository. Each
measurement runs in a process of its own that imports the package of its
root, in the order old, new, new, old; each prints its world-steps/s and
the closed loop's split (K2 with its packing, the controller with its
readouts, by CUDA events over 50 steps), and the last line is a JSON
summary with the card's name and power limit. ``--one ROOT`` makes one
measurement.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SPLIT_STEPS = 50


def measure(root: Path) -> dict:
    """Config 3's world-steps/s and split with ``root``'s package."""
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(HERE))
    import torch

    import flygym_tpu_torch
    from flygym_tpu_torch.compose.bridge import TERRAIN_FLY
    from flygym_tpu_torch.demo.hybrid_terrain import HybridLoop, place_roots, root_offsets

    import chip_smoke

    n = chip_smoke.N_WORLDS
    compiled = flygym_tpu_torch.load_compiled(TERRAIN_FLY)
    sim = flygym_tpu_torch.BatchSimulation(compiled, n,
                                           terrain_resample=chip_smoke.TERRAIN_RESAMPLE)
    gen = torch.Generator(device="cuda").manual_seed(0)
    place_roots(sim, root_offsets(n, gen))
    sim.set_leg_adhesion_states("rugged", torch.ones(6, device="cuda"))
    loop = HybridLoop(sim)
    cs = loop.init_state(gen)
    sim.rollout(None, chip_smoke.TERRAIN_SETTLE_STEPS, record_trajectory=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs, _rec = loop.run(cs, chip_smoke.TERRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # The split of a closed-loop step at the plane sample's stride.
    state, planes = sim.state, loop.sample_planes(sim.state)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    parts = [0.0, 0.0]
    for _ in range(SPLIT_STEPS):
        ev[0].record()
        state = loop.physics_step(state, planes)
        ev[1].record()
        state, cs = loop.control(state, cs)
        ev[2].record()
        ev[2].synchronize()
        for i in range(2):
            parts[i] += ev[i].elapsed_time(ev[i + 1]) / SPLIT_STEPS
    rate = chip_smoke.TERRAIN_STEPS * n / wall
    print(f"[config 3] {root}: {wall / chip_smoke.TERRAIN_STEPS * 1e3:.4f} ms per step, "
          f"{rate:.0f} world-steps/s; K2 with its packing {parts[0]:.3f} ms, controller with "
          f"its readouts {parts[1]:.3f} ms", file=sys.stderr)
    return {"root": str(root), "rate": rate, "k2_ms": parts[0], "controller_ms": parts[1],
            "card": chip_smoke.card_line()}


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(measure(Path(sys.argv[2]).resolve())))
        return 0
    old, new = (Path(a).resolve() for a in sys.argv[1:3])
    runs = []
    for root in (old, new, new, old):
        proc = subprocess.run([sys.executable, __file__, "--one", str(root)],
                              capture_output=True, text=True, timeout=600)
        print(proc.stderr, end="")
        if proc.returncode != 0:
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    summary = {key: {"old": [r[key] for r in runs if r["root"] == str(old)],
                     "new": [r[key] for r in runs if r["root"] == str(new)]}
               for key in ("rate", "k2_ms", "controller_ms")}
    print(json.dumps({"config3": summary, "card": runs[0]["card"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
