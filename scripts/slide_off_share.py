#!/usr/bin/env python3
"""The default two-fly preset's slid-off share on the port's engine path and on K2.

The default two-fly preset (``twofly_full.npz``: 55 x 55 compressed pair
rows) is dropped in N worlds as ``chip_smoke.py`` phase 17 drops it: the top
fly moved by a seeded +-0.1 mm in xy, adhesion on the bottom fly, 800 steps.
For the engine path (K1/K1b) and for K2 the script counts the worlds whose
top root ends 0.4 mm or less above the bottom one (example 11's check),
with 95% Wilson intervals, beside the JAX engine's 5 of 512
(``scripts/export_compressed_golden.py --slide-off 512``). Run from the
repository root on a machine with the card:

    python3 scripts/slide_off_share.py 512

Each path prints one line; the last line is a JSON summary with the card's
name and power limit.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

JAX_ENGINE = (5, 512)


def wilson(k: int, n: int, z: float = 1.96) -> tuple:
    """The Wilson score interval of k successes in n trials (95%)."""
    p = k / n
    centre = (p + z * z / (2 * n)) / (1 + z * z / n)
    half = z * (p * (1 - p) / n + z * z / (4 * n * n)) ** 0.5 / (1 + z * z / n)
    return centre - half, centre + half


def slid_off(n_worlds: int, megastep: bool) -> dict:
    """The drop on one path: the worlds whose top root ends REST_GAP_MM or
    less above the bottom one, their xy distances, and the launches."""
    import torch

    import chip_smoke
    import flygym_tpu_torch
    from flygym_tpu_torch import BatchSimulation
    from flygym_tpu_torch.compose.bridge import TWOFLY_FULL
    from flygym_tpu_torch.demo.hybrid_terrain import place_roots

    sim = BatchSimulation(flygym_tpu_torch.load_compiled(TWOFLY_FULL), n_worlds,
                          megastep=megastep)
    gen = torch.Generator(device="cuda").manual_seed(0)
    offsets = (2.0 * torch.rand((n_worlds, 2), generator=gen, device="cuda") - 1.0) \
        * chip_smoke.TOP_OFFSET_MM
    place_roots(sim, offsets, root=1)
    sim.set_leg_adhesion_states("bottom", torch.ones(6, device="cuda"))
    chip_smoke.reset_counts()
    t0 = time.perf_counter()
    sim.rollout(None, chip_smoke.TWOFLY_STEPS, record_trajectory=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = sim.state
    (_b0, q_bottom, _v0), (_b1, q_top, _v1) = sim.model.free_joints
    lift = st.qpos[:, q_top + 2] - st.qpos[:, q_bottom + 2]
    sep = (st.qpos[:, q_top:q_top + 2] - st.qpos[:, q_bottom:q_bottom + 2]).norm(dim=1)
    low = lift <= chip_smoke.REST_GAP_MM
    return {"low": int(low.sum().item()), "xy_mm": [round(x, 3) for x in sep[low].tolist()],
            "seconds": wall, "launches": chip_smoke.read_counts(),
            "finite": bool(torch.isfinite(st.qpos).all())}


def main() -> int:
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("slide_off_share: no CUDA device", file=sys.stderr)
        return 1
    n_worlds = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    card = chip_smoke.card_line()
    print(card)
    out = {}
    for path in ("engine", "K2"):
        r = slid_off(n_worlds, megastep=path == "K2")
        lo, hi = wilson(r["low"], n_worlds)
        print(f"[slide-off] {path} path, {n_worlds} worlds, {chip_smoke.TWOFLY_STEPS} steps in "
              f"{r['seconds']:.1f} s (launches {r['launches']}): top root "
              f"{chip_smoke.REST_GAP_MM} mm or less above the bottom one in {r['low']} worlds "
              f"({r['low'] / n_worlds:.4f}, 95% interval {lo:.4f}-{hi:.4f}); their xy distances "
              f"{r['xy_mm']} mm; finite {r['finite']}")
        out[path] = {"slid_off": r["low"], "worlds": n_worlds, "interval": [lo, hi]}
    k, n = JAX_ENGINE
    lo, hi = wilson(k, n)
    print(f"[slide-off] the JAX engine: {k} of {n} ({k / n:.4f}, 95% interval {lo:.4f}-{hi:.4f})")
    out["jax_engine"] = {"slid_off": k, "worlds": n, "interval": [lo, hi]}
    print(json.dumps({"slide_off": out, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
