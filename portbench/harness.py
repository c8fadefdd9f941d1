"""One run of one cell: set-up, the measured window, the reference's check,
and the metrics, as a dict that ``run.py`` prints as its last line.

:func:`execute` takes the device and optional overrides of the mix's
parameters, so that the CPU tests drive every step of a run at a small size
on the CPU, where the program's kernels run their plain versions.
"""

import contextlib
import math
import os
import sys
import tempfile
from time import perf_counter

import torch

from portbench.compare import verdict
from portbench.counts import PEAK_BYTES, PEAK_FP32
from portbench.digest import digest_file

__all__ = ["FORBIDDEN", "Reading", "execute", "forbidden_modules", "no_span",
           "seeded_generator"]

# Top-level modules the benchmark's process may not hold once the window has
# closed: JAX, its libraries and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "flygym_tpu")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names in ``modules`` (``sys.modules``),
    compared whole: ``flygym_tpu_torch`` is not ``flygym_tpu``."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


class Reading:
    """What a per-layer metric's reader reads: the trace's ``digest``
    (:func:`portbench.digest.digest_events`), the window's ``work``, the
    cell's ``config`` (its ``counts``) and ``mix``, the traffic driver's ``run``,
    and the peaks."""

    peak_fp32 = PEAK_FP32
    peak_bytes = PEAK_BYTES

    def __init__(self, digest, work, config, mix, run):
        self.digest, self.work, self.config, self.mix, self.run = digest, work, config, mix, run


def no_span(_name):
    """The window's span factory when nothing traces."""
    return contextlib.nullcontext()


def seeded_generator(device, seed: int) -> torch.Generator:
    """A generator on ``device`` seeded from a run's ``--seed`` (any whole
    number; taken modulo 2**63)."""
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def _traced_window(run, seconds: float):
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        work = run.window(seconds, record_function)
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        del prof
        digest = digest_file(path)
    finally:
        os.unlink(path)
    return work, digest


def execute(bench, cell: dict, seed: int, seconds: float, trace: bool, device,
            since_start=None, overrides=None, driver_kw=None, log=print) -> dict:
    """Run ``cell`` once; returns ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (without its kind and memory on the CPU),
    ``breakdown`` (traced), and ``checks`` (``{name: {"value", "limit"}}``).

    ``since_start()`` gives the seconds since the process started
    (``setup_s``); ``overrides`` replace the mix's parameters and
    ``driver_kw`` go to the traffic driver's ``setup``. The controls, a lower
    precision in the reference's place, run through
    :func:`portbench.control.readings` instead."""
    device = torch.device(device)
    config = bench.config(cell["config"])
    mix = {**bench.traffic(cell["traffic"]), **(overrides or {})}
    driver = bench.driver(mix["driver"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run = driver.setup(config, mix, seed, device, **(driver_kw or {}))
    setup_s = since_start() if since_start is not None else None
    if trace:
        work, digest = _traced_window(run, seconds)
    else:
        work, digest = run.window(seconds, no_span), None
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "count": int(cell["chips"])}
    if device.type == "cuda":
        dev["kind"] = torch.cuda.get_device_name(device)
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    e2e = run.end_to_end(work)
    run.free()
    t_check = perf_counter()
    checks = run.check()
    check_s = perf_counter() - t_check

    metrics = {}
    if trace:
        dev["busy_s"] = digest["busy_s"]
        dev["window_s"] = digest["window_s"]
        reading = Reading(digest, work, config, mix, run)
        for m in bench.per_layer(cell["name"]):
            value = bench.reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench.end_to_end(cell["name"]):
            value = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": verdict(checks), "attempted": int(work["attempted"]), "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = digest["breakdown"]
    # A gap with a NaN on one side is infinite, which JSON has no number for.
    result["checks"] = {name: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                        for name, v, lim in checks}
    log(f"[portbench] {cell['name']} seed {seed}: set-up {setup_s} s, window "
        f"{work['seconds']} s, check {check_s} s; "
        f"{ {k: v for k, v in work.items() if not isinstance(v, list)} }")
    ends = list(getattr(run, "episode_ends", ()))
    log(f"[portbench] episode seconds: {[b - a for a, b in zip([0.0] + ends, ends)]}")
    return result
