"""Where config 3's closed loop rounds otherwise on the card than on the CPU.

Runs the closed loop of ``flygym_tpu_torch/demo/hybrid_terrain.py`` from the
settled state of ``flygym_tpu_torch/assets/terrain_fly_golden.npz`` (its 8
worlds and controller state) twice, once on CPU tensors and once on a
second device, one stage at a time: the plane sample (every 8 steps), the
controller with its readouts (tip heights, contact forces, heading; the CPG
state, the hybrid correction, the joint targets and adhesion) and the
physics step (the mega-step kernel's plain version, ``megastep_plain``,
which the kernel equals to the last bit). Every torch call of a stage is
recorded on the CPU; on the device each call's outputs are held against the
CPU's bit for bit. A call whose outputs differ is reported with the torch
function, the line of the port that made it and the largest difference, and
its CPU outputs are put in its place, so that the run goes on from equal
values and every such call is found, not only the first. Each stage starts
from the CPU's state.

Run from the repository root on a machine with a CUDA card::

    python3 scripts/probe_terrain_device.py [n_steps] [device]

``n_steps`` defaults to 9 (two plane samples); ``device`` to ``cuda``
(``cpu`` rehearses the probe, which must then find nothing).
"""

import sys
import time
from pathlib import Path

import torch
from torch.overrides import TorchFunctionMode

REPO = Path(__file__).resolve().parents[1]
PKG = str(REPO / "flygym_tpu_torch")


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in _tensors(x)]
    return []


def _where() -> str:
    """The innermost line of the port on the stack."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_filename.startswith(PKG):
            return f"{Path(frame.f_code.co_filename).relative_to(REPO)}:{frame.f_lineno}"
        frame = frame.f_back
    return "?"


class Record(TorchFunctionMode):
    """Every call's tensor outputs, copied, in call order."""

    def __init__(self):
        super().__init__()
        self.outs = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.outs.append([t.detach().clone() for t in _tensors(out)])
        return out


class Compare(TorchFunctionMode):
    """Each call's outputs against the recorded ones; a differing output is
    reported and replaced by the recorded value."""

    def __init__(self, outs, stage: str, found: dict):
        super().__init__()
        self.outs, self.i, self.stage, self.found = outs, 0, stage, found

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        got = _tensors(out)
        want = self.outs[self.i] if self.i < len(self.outs) else None
        self.i += 1
        if want is None or len(want) != len(got):
            raise RuntimeError(f"{self.stage}: call {self.i} ({func}) does not match the CPU's")
        for k, (g, w) in enumerate(zip(got, want)):
            gc = g.detach().cpu()
            if gc.shape == w.shape and torch.equal(gc, w):
                continue
            gap = ((gc.double() - w.double()).abs().max().item()
                   if gc.shape == w.shape and gc.numel() else float("nan"))
            key = (self.stage.split(" ", 2)[2], getattr(func, "__name__", str(func)), _where())
            rec = self.found.setdefault(key, {"calls": 0, "gap": 0.0, "first": self.stage})
            rec["calls"] += 1
            rec["gap"] = max(rec["gap"], gap)
            with torch.no_grad():
                g.copy_(w.to(g.device))
        return out


def main() -> int:
    n_steps = int(sys.argv[1]) if len(sys.argv) > 1 else 9
    device = torch.device(sys.argv[2] if len(sys.argv) > 2 else "cuda")
    sys.path.insert(0, str(REPO))
    from flygym_tpu_torch import BatchSimulation, load_compiled
    from flygym_tpu_torch.compose.bridge import TERRAIN_FLY, load_terrain_golden
    from flygym_tpu_torch.control import HybridState
    from flygym_tpu_torch.demo.hybrid_terrain import HybridLoop
    from flygym_tpu_torch.ops.megastep import megastep_plain

    compiled = load_compiled(TERRAIN_FLY)
    golden = load_terrain_golden()
    n_worlds = golden["state"].qpos.shape[0]
    loops, states = {}, {}
    for dev in ("cpu", device):
        sim = BatchSimulation(compiled, n_worlds, device=dev, megastep=True)
        loops[dev] = HybridLoop(sim)
        states[dev] = (golden["state"].to(dev),
                       HybridState.from_numpy(golden["controller"], device=dev))
    static = loops["cpu"].batched_step.static
    resample = golden["meta"]["terrain_resample"]
    found = {}
    t0 = time.perf_counter()

    def stage(name, fn, args_cpu):
        """``fn`` on the CPU, recorded, then on the device from the CPU's
        inputs, compared; returns the CPU's result."""
        rec = Record()
        with rec:
            out_cpu = fn("cpu", *args_cpu)
        moved = [a.to(device) if hasattr(a, "to") else a for a in args_cpu]
        with Compare(rec.outs, name, found):
            fn(device, *moved)
        print(f"[probe] {name}: {len(rec.outs)} torch calls compared, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return out_cpu

    def to(x, dev):
        return x.to(dev) if isinstance(x, torch.Tensor) else _state_to(x, dev)

    def _state_to(obj, dev):
        fields = {k: to(v, dev) for k, v in vars(obj).items()}
        return type(obj)(**fields)

    state, cs = states["cpu"]
    planes = None
    for t in range(n_steps):
        if t % resample == 0:
            planes = stage(f"step {t} plane sample",
                           lambda dev, s: loops[dev].sample_planes(s), [state])
        state, cs = stage(f"step {t} controller",
                          lambda dev, s, c: loops[dev].control(s, _state_to(c, dev)),
                          [state, cs])
        state = stage(f"step {t} physics (plain K2)",
                      lambda dev, s, p: megastep_plain(static, s, None, p), [state, planes])
    print(f"[probe] {n_steps} closed-loop steps of {n_worlds} worlds on cpu and {device}: "
          f"{len(found)} calls round otherwise")
    for (name, func, where), rec in found.items():
        print(f"[probe] {name}: {func} at {where}: {rec['calls']} calls differ (first in "
              f"{rec['first']}), largest gap {rec['gap']:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
