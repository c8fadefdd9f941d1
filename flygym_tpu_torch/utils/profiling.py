"""Performance reports, the port's spans and counters, and a profiler
trace of the card.

Port of ``flygym_tpu/utils/profiling.py``: the single-world and parallel
reports (time per step, percent, throughput, realtime factor, and the
parallel aggregate columns) from the runtime's counters, with the same rows
and numbers, and the execution-environment check. The table is formatted
here: the port depends on neither ``tabulate`` nor ``pandas``.

The recorder. :class:`span` marks a layer of the program (``flygym.*``
names); every span adds its calls, host time and self time (its time less
its child spans') to a per-name total, always, at two clock reads and a
dict update. While a ``torch.profiler`` session records, a span also enters
``record_function`` (a ``user_annotation`` on the trace's timeline, beside
the card's kernels), keeps an :class:`Occurrence` (parent, the env step's or
chunk's id, host start and end, CUDA events at entry and exit on the current
stream) and counts the host's synchronisations with the card inside it
(PyTorch's sync debug mode, from the outermost span's entry to its exit).
:func:`count` and the kernels' ``launches`` dicts are the counters.
:func:`spans`, :func:`counters` and :func:`report` read them back;
:func:`reset_spans` starts the spans again.

:func:`trace` records the enclosed block with ``torch.profiler`` (CPU and,
where there is a card, CUDA activity) inside a ``flygym.trace`` span, writes
a chrome trace under its ``logdir`` and prints :func:`summarize_trace`'s
digest of the block: its length, the card's busy time and share, the device
ops that took the most time, the longest idle gaps and the spans' report.
"""

import contextlib
import functools
import glob
import gzip
import html
import json
import os
import tempfile
import textwrap
import threading
import warnings
from time import perf_counter_ns
from typing import Literal

import torch

__all__ = [
    "print_perf_report",
    "print_perf_report_parallel",
    "check_environment",
    "trace",
    "summarize_trace",
    "Occurrence",
    "elapsed_ms",
    "span",
    "count",
    "counters",
    "register_launches",
    "spans",
    "reset_spans",
    "report",
]

# The device activity of torch.profiler's chrome trace, by event category.
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_NAME_WIDTH = 72


def _stage_rows(total_physics_ns, total_render_ns, n_steps, n_frames, timestep):
    total_ns = total_physics_ns + total_render_ns
    physics = _stage_stats(total_physics_ns, total_ns, n_steps, timestep)
    total = _stage_stats(total_ns, total_ns, n_steps, timestep)
    if n_frames == 0:
        render = (float("nan"),) * 4
        per_frame_us = float("nan")
    else:
        render = _stage_stats(total_render_ns, total_ns, n_steps, timestep)
        per_frame_us = 1e-3 * total_render_ns / n_frames
    return physics, render, total, per_frame_us


def _stage_stats(stage_ns, total_ns, n_steps, timestep):
    per_iter_us = 1e-3 * stage_ns / n_steps
    percent = 100 * stage_ns / total_ns if total_ns else float("nan")
    throughput = 1e9 * n_steps / stage_ns if stage_ns else float("inf")
    realtime_x = throughput * timestep
    return per_iter_us, percent, throughput, realtime_x


def _cells(table, floatfmt) -> list:
    """Each cell as text: numbers by their column's format."""
    return [[format(v, fmt) if isinstance(v, (int, float)) else str(v)
             for v, fmt in zip(row, floatfmt)] for row in table]


def _grid(headers, rows) -> str:
    """A box-drawn table (tabulate's ``simple_grid``): headers of several
    lines, the first column left-aligned, the others right-aligned."""
    head = [h.split("\n") for h in headers]
    n_head = max(len(h) for h in head)
    head = [[""] * (n_head - len(h)) + h for h in head]
    widths = [max(len(x) for x in col + [r[i] for r in rows]) for i, col in enumerate(head)]

    def line(cells):
        parts = [c.ljust(w) if i == 0 else c.rjust(w) for i, (c, w) in enumerate(zip(cells, widths))]
        return "│ " + " │ ".join(parts) + " │"

    def rule(left, mid, right):
        return left + mid.join("─" * (w + 2) for w in widths) + right

    out = [rule("┌", "┬", "┐")]
    out += [line([h[k] for h in head]) for k in range(n_head)]
    for row in rows:
        out.append(rule("├", "┼", "┤"))
        out.append(line(row))
    out.append(rule("└", "┴", "┘"))
    return "\n".join(out)


def _html(headers, rows) -> str:
    head = "".join(f"<th>{html.escape(h).replace(chr(10), '<br>')}</th>" for h in headers)
    body = "".join("<tr>" + "".join(f"<td>{html.escape(c)}</td>" for c in row) + "</tr>"
                   for row in rows)
    return f"<table><thead><tr>{head}</tr></thead><tbody>{body}</tbody></table>"


def _emit(table, headers, floatfmt, rendering_note, show_in_notebook):
    rows = _cells(table, floatfmt)
    if show_in_notebook:
        from IPython.display import HTML, display

        print("PERFORMANCE PROFILE")
        display(HTML(_html(headers, rows)))
        print(rendering_note)
    else:
        tab_str = _grid(headers, rows)
        tab_width = max(len(line) for line in tab_str.splitlines())
        print()
        print("PERFORMANCE PROFILE".center(tab_width))
        print(tab_str)
        print(textwrap.fill(rendering_note, width=tab_width))
        print()


def _render_note(n_frames, n_steps, per_frame_us):
    if n_frames == 0:
        return "* Note: No frames were rendered."
    return (
        f"* Note: {n_frames} frames were rendered out of {n_steps} steps. "
        f"Therefore, rendering time per image is {per_frame_us:.0f} us."
    )


def print_perf_report(
    total_physics_time_ns: int,
    total_render_time_ns: int,
    n_steps: int,
    n_frames_rendered: int,
    timestep: float,
    show_in_notebook: bool | Literal["auto"] = "auto",
) -> None:
    """Print a single-world performance report.

    Args:
        total_physics_time_ns: Wall-clock spent in physics steps (ns).
        total_render_time_ns: Wall-clock spent rendering (ns).
        n_steps: Number of physics steps taken.
        n_frames_rendered: Number of frames rendered.
        timestep: Simulation timestep (s).
        show_in_notebook: Render as an HTML table ("auto" = detect Jupyter).
    """
    if show_in_notebook == "auto":
        show_in_notebook = check_environment() == "notebook"
    if n_steps == 0:
        raise ValueError("n_steps must be > 0 to print performance report.")

    physics, render, total, per_frame_us = _stage_rows(
        total_physics_time_ns, total_render_time_ns, n_steps, n_frames_rendered, timestep,
    )
    table = [
        ["Physics simulation advancement", *physics],
        ["Rendering*", *render],
        ["TOTAL", *total],
    ]
    headers = [
        "\nStage",
        "Time/step\n(us)",
        "Percent\n(%)",
        "Throughput\n(iters/s)",
        "Throughput\nx realtime",
    ]
    _emit(table, headers, ("s", ".0f", ".0f", ".0f", ".2f"),
          _render_note(n_frames_rendered, n_steps, per_frame_us), show_in_notebook)


def print_perf_report_parallel(
    total_physics_time_ns: int,
    total_render_time_ns: int,
    n_steps: int,
    n_frames_rendered: int,
    timestep: float,
    n_worlds: int,
    n_worlds_rendered: int,
    show_in_notebook: bool | Literal["auto"] = "auto",
) -> None:
    """Print a multi-world performance report with aggregate columns.

    A whole ``rollout`` has no per-step split: time it instead (the
    reference's hint that profiling and CUDA-graph capture exclude each
    other, ``profiling.py:145-151``).
    """
    if show_in_notebook == "auto":
        show_in_notebook = check_environment() == "notebook"
    if n_steps == 0:
        raise ValueError(
            "n_steps must be > 0 to print performance report. "
            "Hint: Did you run the whole episode inside a single "
            "rollout? If so, per-stage profiling cannot be meaningfully done; "
            "time the rollout call instead."
        )

    physics, render, total, per_frame_us = _stage_rows(
        total_physics_time_ns, total_render_time_ns, n_steps, n_frames_rendered, timestep,
    )
    table = [
        ["Physics simulation advancement", *physics, physics[2] * n_worlds,
         physics[3] * n_worlds],
        ["Rendering*", *render, render[2] * n_worlds_rendered, render[3] * n_worlds_rendered],
        ["TOTAL", *total, total[2] * n_worlds, total[3] * n_worlds],
    ]
    headers = [
        "\nStage",
        "Time/step\n(us)",
        "Percent\n(%)",
        "Throughput\n(iters/s)",
        "Throughput\nx realtime",
        "Throughput\n(iters/s)\n(parallelized)",
        "Throughput\nx realtime\n(parallelized)",
    ]
    _emit(table, headers, ("s", ".0f", ".0f", ".0f", ".2f", ".0f", ".2f"),
          _render_note(n_frames_rendered, n_steps, per_frame_us), show_in_notebook)


# -- the recorder ------------------------------------------------------------

# What PyTorch's sync debug mode warns at each synchronising CUDA call.
_SYNC_WARNING = "called a synchronizing CUDA operation"

_totals: dict = {}  # name -> [calls, host ns, self ns, host syncs]
_recorded: list = []  # the Occurrences kept while a profiler recorded
_counts: dict = {}
_launches: list = []  # the kernels' launch counters, dicts their modules keep


class _Local(threading.local):
    def __init__(self):
        self.stack = []  # the open spans of this thread


_local = _Local()
_watch = None  # (catch_warnings, the sync debug mode before) while syncs are counted
_profiler_enabled = torch._C._autograd._profiler_enabled


class Occurrence:
    """One span recorded while a profiler recorded: ``name``, ``parent``
    (the enclosing recorded Occurrence or None), ``id`` (the env step's or
    chunk's index: given to the span, else its parent's, else the span's
    calls before it), ``start_ns`` and ``end_ns`` (``perf_counter_ns``; None
    while open), ``self_ns``, ``syncs`` (synchronising CUDA calls made while
    it was the innermost recorded span) and ``start_event``/``end_event``
    (CUDA events on the current stream, None without CUDA)."""

    __slots__ = ("name", "parent", "id", "start_ns", "end_ns", "self_ns", "syncs",
                 "start_event", "end_event")

    def __init__(self, name: str, parent, id_: int):
        self.name, self.parent, self.id = name, parent, id_
        self.start_ns = self.end_ns = self.self_ns = None
        self.syncs = 0
        self.start_event = self.end_event = None

    @property
    def host_ms(self):
        return None if self.end_ns is None else (self.end_ns - self.start_ns) * 1e-6

    def device_ms(self):
        """The stream's time from entry to exit (ms), or None without
        events or before the exit's event has completed."""
        return elapsed_ms(self.start_event, self.end_event)


def elapsed_ms(a, b):
    """Milliseconds from CUDA event ``a`` to ``b``, or None where either is
    missing or ``b`` has not completed."""
    if a is None or b is None or not b.query():
        return None
    return a.elapsed_time(b)


class span:
    """A span of the program named ``name`` (``flygym.<layer>[.<part>]``),
    as a context manager, or as a decorator that opens one per call.

    ``id`` names the env step or chunk the span belongs to; without it a
    recorded span takes its parent's, or at the top its calls before it.
    Off (no profiler recording) a span costs two clock reads and the update
    of its name's totals; it never enters ``record_function`` then and keeps
    no Occurrence.
    """

    __slots__ = ("name", "id", "_start", "_child", "_occ", "_rf", "_watching")

    def __init__(self, name: str, id: int | None = None):
        self.name, self.id = name, id

    def __call__(self, fn):
        name, id_ = self.name, self.id

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name, id_):
                return fn(*args, **kwargs)

        return spanned

    def __enter__(self):
        self._child = 0
        self._occ = None
        if _profiler_enabled():
            self._record(_local.stack)
        _local.stack.append(self)
        self._start = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = perf_counter_ns()
        stack = _local.stack
        stack.pop()
        host = end - self._start
        if stack:
            stack[-1]._child += host
        totals = _totals.get(self.name)
        if totals is None:
            totals = _totals[self.name] = [0, 0, 0, 0]
        totals[0] += 1
        totals[1] += host
        totals[2] += host - self._child
        if self._occ is not None:
            self._finish(end, host - self._child, totals)
        return False

    def _record(self, stack) -> None:
        parent = next((s._occ for s in reversed(stack) if s._occ is not None), None)
        if self.id is not None:
            id_ = self.id
        elif parent is not None:
            id_ = parent.id
        else:
            id_ = _totals.get(self.name, (0,))[0]
        occ = self._occ = Occurrence(self.name, parent, id_)
        _recorded.append(occ)
        self._rf = torch.autograd.profiler.record_function(self.name)
        self._rf.__enter__()
        self._watching = parent is None and _watch is None and _watch_syncs()
        if torch.cuda.is_initialized():
            occ.start_event = torch.cuda.Event(enable_timing=True)
            occ.start_event.record()

    def _finish(self, end: int, own: int, totals: list) -> None:
        occ = self._occ
        if occ.start_event is not None:
            occ.end_event = torch.cuda.Event(enable_timing=True)
            occ.end_event.record()
        if self._watching:
            _unwatch_syncs()
        self._rf.__exit__(None, None, None)
        occ.start_ns, occ.end_ns, occ.self_ns = self._start, end, own
        totals[3] += occ.syncs


def _count_sync() -> bool:
    """Add a synchronisation to the innermost recorded span of this
    thread; False where it has none."""
    for s in reversed(_local.stack):
        if s._occ is not None:
            s._occ.syncs += 1
            return True
    return False


def _watch_syncs() -> bool:
    """Turn on PyTorch's sync debug mode (``"warn"``) and count each of its
    warnings, every one, not the first per call site. False without CUDA."""
    global _watch
    if not torch.cuda.is_initialized():
        return False
    mode = torch.cuda.get_sync_debug_mode()
    guard = warnings.catch_warnings()
    guard.__enter__()
    warnings.filterwarnings("always", message=".*" + _SYNC_WARNING)
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        counted = _SYNC_WARNING in str(message) and _count_sync()
        if not counted or mode != 0:  # a mode set before is the caller's to see
            shown(message, category, filename, lineno, file, line)

    warnings.showwarning = show
    if mode == 0:
        torch.cuda.set_sync_debug_mode("warn")
    _watch = (guard, mode)
    return True


def _unwatch_syncs() -> None:
    global _watch
    guard, mode = _watch
    _watch = None
    torch.cuda.set_sync_debug_mode(mode)
    guard.__exit__(None, None, None)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def register_launches(launches: dict) -> None:
    """Report a kernel module's ``launches`` dict, which the module keeps
    and resets, in :func:`counters` as ``launches.<key>``."""
    _launches.append(launches)


def counters() -> dict:
    """Every counter: :func:`count`'s (``kernel_builds.<kernel>``,
    ``kernel_loads.<kernel>``) and the kernels' launches
    (``launches.<kernel>``)."""
    out = dict(_counts)
    for launches in _launches:
        out.update((f"launches.{k}", v) for k, v in launches.items())
    return out


def spans() -> dict:
    """Per span name since :func:`reset_spans`: ``calls``, ``host_ns``,
    ``self_ns`` and ``syncs`` over every call, and ``recorded``, its
    Occurrences kept while a profiler recorded, in the order they began."""
    out = {name: {"calls": c, "host_ns": h, "self_ns": o, "syncs": y, "recorded": []}
           for name, (c, h, o, y) in _totals.items()}
    for occ in _recorded:
        out.setdefault(occ.name, {"calls": 0, "host_ns": 0, "self_ns": 0, "syncs": 0,
                                  "recorded": []})["recorded"].append(occ)
    return out


def reset_spans() -> None:
    """Forget every span's totals and Occurrences (not the counters)."""
    _totals.clear()
    _recorded.clear()


def report() -> str:
    """A table of the spans by name: calls, host ms, host self ms (every
    call), device ms (the recorded calls' CUDA events: synchronise the card
    first) and host syncs (counted while a profiler recorded)."""
    device = {}
    for occ in _recorded:
        ms = occ.device_ms()
        if ms is not None:
            device[occ.name] = device.get(occ.name, 0.0) + ms
    rows = [[name, str(c), f"{h * 1e-6:.3f}", f"{o * 1e-6:.3f}",
             f"{device[name]:.3f}" if name in device else "-", str(y)]
            for name, (c, h, o, y) in sorted(_totals.items())]
    return _grid(["span", "calls", "host ms", "self ms", "device ms", "syncs"], rows)


# -- the profiler's trace --------------------------------------------------------

_TRACE_SPAN = "flygym.trace"
_HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
                    "python_function")


@contextlib.contextmanager
def trace(logdir: str | None = None, *, summarize: bool = True):
    """Record the enclosed block with ``torch.profiler`` (CPU activity, and
    the card's where there is one), inside a ``flygym.trace`` span, and
    write its chrome trace under ``logdir`` (by default
    ``flygym_tpu_torch_trace`` in the temporary directory). On exit, unless
    ``summarize`` is False, print :func:`summarize_trace`'s digest of it.
    Yields ``logdir``.

    The card runs asynchronously: end the block with
    ``torch.cuda.synchronize()``, or the work it queued escapes the trace::

        with trace() as logdir:
            sim.rollout(None, 1000)
            torch.cuda.synchronize()
    """
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "flygym_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with span(_TRACE_SPAN):
            yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    if summarize:
        summarize_trace(logdir)


def _load_trace_events(logdir: str) -> list:
    pats = [os.path.join(logdir, "**", "*.json.gz"), os.path.join(logdir, "**", "*.json")]
    paths = [p for pat in pats for p in glob.glob(pat, recursive=True)]
    if not paths:
        return []
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def _union(intervals: list) -> list:
    """Merged ``[start, end]`` intervals, sorted."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _innermost(spans_: list, t: float) -> str:
    """The name of the innermost (latest started) ``flygym.*`` span that
    holds time ``t``."""
    around = [(lo, name) for lo, hi, name in spans_ if lo <= t <= hi]
    return max(around)[1] if around else "outside every flygym span"


def summarize_trace(logdir: str, top: int = 12) -> dict | None:
    """Digest the newest chrome trace under ``logdir`` and print it.

    The block is the trace's ``flygym.trace`` span (:func:`trace`), else
    the first event to the last; every interval is clipped to it. Complete
    events (``"ph" == "X"``) in the device categories (kernels, copies,
    memsets) are the card's, those in the host categories (ops, spans, CUDA
    runtime and driver calls) the host's. Returns ``span_ms`` (the block),
    ``device_busy_ms`` and ``device_busy_frac`` (the union of device
    intervals, and its share of the block: at most 1), ``device_events``
    (how many), ``host_event_ms`` (the union of host intervals, the block's
    own span left out), ``top_device_ops`` as (name, ms, % of busy) by
    the union of each name's device intervals, ``idle_gaps``, the ``top`` longest stretches of the
    block with no device interval as (the innermost ``flygym.*`` span around
    each one's middle, ms), and ``report``, :func:`report` of the recorder
    now; None when no trace file is found.
    """
    events = [e for e in _load_trace_events(logdir) if e.get("ph") == "X"]
    if not events:
        print(f"[trace] no trace file found under {logdir}")
        return None
    edges = lambda e: (float(e.get("ts", 0.0)), float(e.get("ts", 0.0)) + float(e.get("dur", 0.0)))
    blocks = [e for e in events
              if e.get("name") == _TRACE_SPAN and e.get("cat") == "user_annotation"]
    if blocks:
        block = max(blocks, key=lambda e: float(e.get("dur", 0.0)))
        lo, hi = edges(block)
    else:
        block = None
        lo = min(edges(e)[0] for e in events)
        hi = max(edges(e)[1] for e in events)
    dev_ops: dict = {}
    device, host, flygym_spans = [], [], []
    for e in events:
        a, b = edges(e)
        if b < lo or a > hi:
            continue
        a, b = max(a, lo), min(b, hi)
        cat, name = e.get("cat"), e.get("name", "?")
        if cat in _DEVICE_CATEGORIES:
            device.append((a, b))
            dev_ops.setdefault(name, []).append((a, b))
        elif cat in _HOST_CATEGORIES:
            if cat == "user_annotation" and name.startswith("flygym."):
                flygym_spans.append((a, b, name))
            if e is not block:
                host.append((a, b))
    busy = _union(device)
    busy_us = sum(b - a for a, b in busy)
    gaps, edge = [], lo
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if hi > edge:
        gaps.append((edge, hi))
    span_us = max(hi - lo, 1e-9)
    op_us = {name: sum(b - a for a, b in _union(iv)) for name, iv in dev_ops.items()}
    rows = sorted(op_us.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    digest = {
        "span_ms": span_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_frac": busy_us / span_us,
        "device_events": len(device),
        "host_event_ms": sum(b - a for a, b in _union(host)) / 1e3,
        "top_device_ops": [(n, d / 1e3, 100.0 * d / max(busy_us, 1e-9)) for n, d in rows],
        "idle_gaps": [(_innermost(flygym_spans, 0.5 * (a + b)), (b - a) / 1e3)
                      for a, b in longest],
        "report": report(),
    }
    print(f"[trace] span {digest['span_ms']:.1f} ms — device busy "
          f"{digest['device_busy_ms']:.1f} ms ({100 * digest['device_busy_frac']:.0f}%), "
          f"host-side events {digest['host_event_ms']:.1f} ms")
    if rows:
        # CUDA kernel names are whole C++ signatures: the table shows their heads.
        print(_grid(["device op", "ms", "% busy"],
                    [[n[:_NAME_WIDTH], f"{ms:.2f}", f"{pc:.1f}"]
                     for n, ms, pc in digest["top_device_ops"]]))
    if device:
        print(_grid(["idle gap in", "ms"], [[n, f"{ms:.3f}"] for n, ms in digest["idle_gaps"]]))
    print(digest["report"])
    return digest


def check_environment() -> str:
    """Detect the execution environment: "notebook", "terminal", "other", or
    "standard_python"."""
    try:
        from IPython import get_ipython

        shell = get_ipython().__class__.__name__
        if shell == "ZMQInteractiveShell":
            return "notebook"
        if shell == "TerminalInteractiveShell":
            return "terminal"
        return "other"
    except (NameError, ImportError, AttributeError):
        return "standard_python"
