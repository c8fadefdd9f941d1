"""Performance reports, and a profiler trace of the card.

Port of ``flygym_tpu/utils/profiling.py``: the single-world and parallel
reports (time per step, percent, throughput, realtime factor, and the
parallel aggregate columns) from the runtime's counters, with the same rows
and numbers, and the execution-environment check. The table is formatted
here: the port depends on neither ``tabulate`` nor ``pandas``.

:func:`trace` records the enclosed block with ``torch.profiler`` (CPU and,
where there is a card, CUDA activity), writes a chrome trace under its
``logdir`` and prints :func:`summarize_trace`'s digest: the span, the card's
busy time and share, and the device ops that took the most time.
"""

import contextlib
import glob
import gzip
import html
import json
import os
import tempfile
import textwrap
from typing import Literal

__all__ = [
    "print_perf_report",
    "print_perf_report_parallel",
    "check_environment",
    "trace",
    "summarize_trace",
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


@contextlib.contextmanager
def trace(logdir: str | None = None, *, summarize: bool = True):
    """Record the enclosed block with ``torch.profiler`` (CPU activity, and
    the card's where there is one) and write its chrome trace under
    ``logdir`` (by default ``flygym_tpu_torch_trace`` in the temporary
    directory). On exit, unless ``summarize`` is False, print
    :func:`summarize_trace`'s digest of it. Yields ``logdir``.

    The card runs asynchronously: end the block with
    ``torch.cuda.synchronize()``, or the work it queued escapes the trace::

        with trace() as logdir:
            sim.rollout(None, 1000)
            torch.cuda.synchronize()
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "flygym_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
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


def summarize_trace(logdir: str, top: int = 12) -> dict | None:
    """Digest the newest chrome trace under ``logdir`` and print it.

    Complete events (``"ph" == "X"``) in the device categories (kernels,
    copies, memsets) are the card's; the rest the host's. Returns
    ``span_ms`` (first event to last), ``device_busy_ms`` and
    ``device_busy_frac`` (their sum over the span), ``host_event_ms`` and
    ``top_device_ops`` as (name, ms, % of busy) by summed device time; None
    when no trace file is found.
    """
    events = _load_trace_events(logdir)
    if not events:
        print(f"[trace] no trace file found under {logdir}")
        return None
    dev_ops: dict = {}
    dev_total = host_total = 0.0
    span_lo, span_hi = float("inf"), 0.0
    for e in events:
        if e.get("ph") != "X":
            continue
        dur = float(e.get("dur", 0.0))  # microseconds
        ts = float(e.get("ts", 0.0))
        span_lo, span_hi = min(span_lo, ts), max(span_hi, ts + dur)
        if e.get("cat") in _DEVICE_CATEGORIES:
            dev_total += dur
            name = e.get("name", "?")
            dev_ops[name] = dev_ops.get(name, 0.0) + dur
        else:
            host_total += dur
    span = max(span_hi - span_lo, 1e-9)
    rows = sorted(dev_ops.items(), key=lambda kv: -kv[1])[:top]
    digest = {
        "span_ms": span / 1e3,
        "device_busy_ms": dev_total / 1e3,
        "device_busy_frac": dev_total / span,
        "host_event_ms": host_total / 1e3,
        "top_device_ops": [(n, d / 1e3, 100.0 * d / max(dev_total, 1e-9)) for n, d in rows],
    }
    print(f"[trace] span {digest['span_ms']:.1f} ms — device busy "
          f"{digest['device_busy_ms']:.1f} ms ({100 * digest['device_busy_frac']:.0f}%), "
          f"host-side events {digest['host_event_ms']:.1f} ms")
    if rows:
        # CUDA kernel names are whole C++ signatures: the table shows their heads.
        print(_grid(["device op", "ms", "% busy"],
                    [[n[:_NAME_WIDTH], f"{ms:.2f}", f"{pc:.1f}"]
                     for n, ms, pc in digest["top_device_ops"]]))
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
