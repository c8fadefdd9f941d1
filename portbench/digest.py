"""The digest of a traced run: device busy time, operations and idle gaps
inside the measured window.

A copy of ``flygym_tpu_torch/utils/profiling.py:summarize_trace``,
corrected. That digest summed device event durations over the span from
the first event of any kind to the last: overlapping device events counted
twice (busy shares of 1.001) and host-only stretches lengthened the span.
Here the window is the ``WINDOW`` span the harness records around the
measured loop; device busy time is the union of the device intervals
(kernels, copies, memsets) clipped to it, and its complement within the
window is idle. Each idle gap is labelled with the innermost host event
under its middle (what the host was doing while the card waited).
"""

import bisect
import json

__all__ = ["DEVICE_CATEGORIES", "WINDOW", "digest_events", "digest_file", "union"]

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "portbench.window"
TOP = 10
NAME_CHARS = 120


def union(intervals: list) -> list:
    """Merged ``[start, end]`` intervals, sorted."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[: NAME_CHARS - 3] + "..."


def _host_label(host: list, starts: list, spans: list, t: float) -> str:
    """The innermost host event (latest start) that holds time ``t``, with
    the innermost harness span (``portbench.*``) around it; or the last
    host event that ended before ``t``."""
    i = bisect.bisect_right(starts, t)
    inner, last = None, None
    for lo, hi, name in reversed(host[max(0, i - 4000):i]):
        if hi >= t:
            inner = name
            break
        if last is None or hi > last[0]:
            last = (hi, name)
    around = [s for s in spans if s[0] <= t <= s[1] and s[2] != inner]
    span = max(around)[2] if around else None
    label = inner if inner is not None else (f"after {last[1]}" if last else "no host event")
    return _short(f"{label} in {span}" if span else label)


def digest_events(events: list, window: str = WINDOW) -> dict:
    """The digest of chrome-trace ``events`` (microsecond timestamps):

    - ``window_s``: the length of the ``window`` span;
    - ``busy_s``: the union of device intervals inside it;
    - ``device_ops``: the device events that start inside it;
    - ``op_seconds``: device seconds by event name (clipped to the window),
      and ``op_counts``: events by name;
    - ``breakdown``: ``device_ops`` (the ``TOP`` names by device seconds) and
      ``idle_gaps`` (the ``TOP`` longest gaps, labelled), each a list of
      ``[name, seconds]``.
    """
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == window]
    if not spans:
        raise ValueError(f"the trace holds no {window!r} span")
    w = max(spans, key=lambda e: float(e["dur"]))
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    device, host = [], []
    op_seconds, op_counts = {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        lo = float(e.get("ts", 0.0))
        hi = lo + float(e.get("dur", 0.0))
        cat = e.get("cat")
        if cat in DEVICE_CATEGORIES:
            if hi <= w0 or lo >= w1:
                continue
            lo, hi = max(lo, w0), min(hi, w1)
            device.append((lo, hi))
            name = e.get("name", "?")
            op_seconds[name] = op_seconds.get(name, 0.0) + (hi - lo) * 1e-6
            op_counts[name] = op_counts.get(name, 0) + 1
        elif cat in HOST_CATEGORIES and hi > w0 and lo < w1 and e is not w:
            host.append((lo, hi, e.get("name", "?")))
    busy = union(device)
    busy_us = sum(hi - lo for lo, hi in busy)
    gaps, edge = [], w0
    for lo, hi in busy:
        if lo > edge:
            gaps.append((edge, lo))
        edge = max(edge, hi)
    if w1 > edge:
        gaps.append((edge, w1))
    host.sort()
    starts = [h[0] for h in host]
    spans = [h for h in host if h[2].startswith("portbench.")]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    idle = [[_host_label(host, starts, spans, 0.5 * (lo + hi)), (hi - lo) * 1e-6]
            for lo, hi in longest]
    top = sorted(op_seconds.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "device_ops": len(device),
        "op_seconds": op_seconds,
        "op_counts": op_counts,
        "breakdown": {"device_ops": [[_short(n), s] for n, s in top], "idle_gaps": idle},
    }


def digest_file(path: str, window: str = WINDOW) -> dict:
    with open(path) as f:
        return digest_events(json.load(f)["traceEvents"], window)
