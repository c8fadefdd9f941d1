"""Frozen operation counts, the card's peaks, and the script that writes
each configuration's counts.

Copies of ``chip_smoke.py``'s ``megastep_ops``, ``retina_ops`` and
``bound_ms``'s peaks, run on the reference's frozen plain versions
(``portbench/reference``), so that a later edit of the port moves no
count. ``contributing_pairs`` is in :mod:`portbench.reference.vision`.

Run ``python -m portbench.counts`` to recount and write the counts into
``configs/<name>.json`` (each world at one world, on the CPU, ~10 s).
"""

import copy
import json
from pathlib import Path

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["PEAK_BYTES", "PEAK_FP32", "PEAK_SOURCE", "bound_s", "megastep_ops", "retina_ops"]

# One NVIDIA H100 SXM (the data sheet, dense, at its 700 W limit): float32
# outside the tensor cores, and HBM3 bandwidth. An FMA counts as two
# operations; K2 and K3 are built with -fmad=false and issue none.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_SOURCE = "NVIDIA H100 SXM data sheet: 67 TFLOP/s float32, 3.35 TB/s HBM3, at 700 W"


def bound_s(ops: float, nbytes: float) -> tuple:
    """The least time for ``ops`` float32 operations moving ``nbytes``, and
    which of the two bounds it: ``(seconds, "operations" | "bytes")``."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def megastep_ops(static, state) -> int:
    """Elementwise operations of one world-step of K2's plain version (the
    JAX emitter's ops, its structural zeros and ones folded), counted on the
    CPU at one world from ``state`` (B = 1)."""
    from portbench.reference import emitter

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor) and func not in (torch.zeros_like, torch.ones_like):
                Count.n += 1
            return out

    cols = lambda x: [x[:, i] for i in range(x.shape[1])]
    args = [cols(state.qpos), cols(state.qvel), cols(state.ctrl), cols(state.act),
            cols(state.qacc)]
    z, one = torch.zeros(1), torch.ones(1)
    terrain = [(z, z, z, one)] * static.ncand if static.has_hfield else None
    widx = [z] * len(static.pair_comp_groups) if static.pair_comp_groups else None
    with Count():
        emitter.emit_step(static, *args, terrain, widx)
    return Count.n


def retina_ops(tables, packed) -> tuple:
    """Elementwise operations of K3's plain version on CPU rows ``packed``,
    each weighted by its output's element count (arithmetic, comparisons and
    selects; views, copies and constants not counted), and those of the
    rays' own work (the same rows with no geoms)."""
    from portbench.reference import vision

    counted = {"add", "sub", "mul", "truediv", "div", "neg", "abs", "sqrt", "floor",
               "remainder", "clamp", "minimum", "maximum", "where", "lt", "gt", "le", "ge",
               "eq", "and", "or", "rsub", "radd", "rmul", "rtruediv", "reciprocal"}

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = getattr(func, "__name__", "").strip("_")
            if isinstance(out, torch.Tensor) and name in counted:
                Count.n += out.numel()
            return out

    with Count():
        vision.retina_plain(tables, packed)
    ops = Count.n
    bare = copy.copy(tables)
    bare.G, bare.radius, bare.rgb = 0, tables.radius[:0], tables.rgb[:0]
    Count.n = 0
    with Count():
        vision.retina_plain(bare, packed[:, :14].contiguous())
    return ops, Count.n


def count_config(cfg: dict) -> dict:
    """The counts of one configuration (its JSON as read, with ``dir``)."""
    from portbench.reference import emitter, vision
    from portbench.reference.model import load_world

    model, state, meta = load_world(Path(cfg["dir"]) / cfg["world"])
    static = emitter._Static(model)
    out = {"k2_ops_per_world_step": megastep_ops(static, state),
           "dims": {"nq": static.nq, "nv": static.nv, "nu": static.nu, "na": static.na,
                    "nbody": static.nbody, "nsite": static.nsite, "nsensor": static.nsensor}}
    if "env" in meta:
        left, right = meta["env"]["eye_bodies"]
        retina = vision.build_retina(model, left_eye_body=left, right_eye_body=right)
        tables = vision.RetinaTables(model, retina, "cpu")
        packed = vision.pack_rows(tables, state.xpos, state.xquat)
        ops, ray_ops = retina_ops(tables, packed)
        out["k3_ops_per_world_all_pairs"] = ops
        out["k3_ray_ops_per_world"] = ray_ops
        out["blur_nonzeros"] = int((retina.blur_weights != 0).sum())
        out["k3_table_floats"] = sum(t.numel() for t in (tables.dirs, tables.weights,
                                                        tables.radius, tables.rgb))
        out["k3_geoms"], out["k3_rays"] = tables.G, tables.R
    return out


def main() -> None:
    from portbench.registry import Benchmark

    bench = Benchmark()
    for entry in bench.spec["configs"]:
        path = bench.root / entry["file"]
        cfg = bench.config(entry["name"])
        counts = count_config(cfg)
        raw = json.loads(path.read_text())
        raw["counts"] = counts
        path.write_text(json.dumps(raw, indent=1) + "\n")
        print(entry["name"], counts)


if __name__ == "__main__":
    main()
