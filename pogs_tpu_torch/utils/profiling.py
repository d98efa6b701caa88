"""Tracing and timing: a profiler trace, program spans, a phase timer and a
device timer.

Counterpart of ``pogs_tpu/utils/profiling.py``:

  * :func:`trace` — a context manager around ``torch.profiler`` that writes
    a Chrome / Perfetto trace of everything inside it;
  * :func:`span` — a named range of the program (``SPANS``) in whatever
    ``torch.profiler`` session is recording, and nothing when none is;
  * :func:`busy_time` — the union of the CUDA kernels' time inside a named
    window of such a trace, and so the card's idle share there;
  * :class:`PhaseTimer` — host wall-clock time per named phase, with the
    reference's per-phase / percentage summary;
  * :func:`device_time` — the mean time per call of ``reps`` back-to-back
    calls: CUDA events when the arguments lie on a CUDA device, the host
    clock when they lie on the CPU.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Dict

import torch
import torch.profiler

# The program's spans, each opened by :func:`span` in the function that does
# the work.  ``pogs.call``: a public entry, from its start to its return (a
# nested entry opens its own; the outermost holds the request).
# ``pogs.functions``: an objective's parameters made into tensors
# (``FunctionVector``).  ``pogs.init``: the work paid once per matrix, and
# inside it, in this order, ``pogs.init.equilibrate``, ``pogs.init.norm_est``
# and ``pogs.init.factor``.  ``pogs.prepare``: the solve's host work before
# its loop: the scaled prox parameters, the starting point and the solve
# kernel's wrapper up to its launch.
SPANS = ("pogs.call", "pogs.functions", "pogs.init", "pogs.init.equilibrate",
         "pogs.init.norm_est", "pogs.init.factor", "pogs.prepare")

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager for the program's span ``name`` (one of ``SPANS``):
    while a ``torch.profiler`` session records (``trace`` among them), a
    ``record_function`` range on the profiler's clock, the clock of the
    device's operations and the host's launches; otherwise a shared null
    context, so a span costs one flag check when nothing records."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Profile the block with ``torch.profiler`` and write its trace, in
    the Chrome trace format that Perfetto and ``chrome://tracing`` open,
    into ``log_dir`` (created if missing).  CPU activity is always traced,
    CUDA activity (kernels, copies) when torch sees a CUDA device, and the
    program's spans (``SPANS``) with them.  Yields the profiler; its
    ``trace_path`` is the file written on exit.
    ``create_perfetto_link`` is accepted for the JAX package's signature
    and ignored: open the file in Perfetto instead."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json")
    prof = profile(activities=activities)
    prof.trace_path = path
    with prof:
        yield prof
    prof.export_chrome_trace(path)


def _union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def busy_time(trace_path: str, window: str) -> dict:
    """The device's busy and idle time inside the first event named
    ``window`` (a ``torch.profiler.record_function`` block) of a Chrome
    trace written by :func:`trace`: the window's length, the union of the
    CUDA kernels' intervals clipped to it, the idle share 1 − busy/window,
    and the kernels' summed time by name (ms)."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    win = next((ev for ev in events if ev.get("name") == window and "dur" in ev), None)
    if win is None:
        raise ValueError(f"no event named {window!r} in {trace_path}")
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    spans, by_name = [], {}
    for ev in events:
        if ev.get("cat") != "kernel" or "dur" not in ev:
            continue
        s = max(float(ev["ts"]), w0)
        e = min(float(ev["ts"]) + float(ev["dur"]), w1)
        if e > s:
            spans.append((s, e))
            by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + (e - s) / 1e3
    window_ms = (w1 - w0) / 1e3
    busy_ms = _union_us(spans) / 1e3
    return {"window_ms": window_ms, "kernel_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / window_ms if window_ms > 0 else 1.0,
            "kernels": len(spans), "kernel_ms_by_name": by_name}


class PhaseTimer:
    """Accumulate wall-clock time per named phase.

    Mirrors the reference's verbose>3 phase report (prox/project/residual
    averages per iteration, pogs.cpp:501-506) at solve granularity:
    init / solve / transfer / overhead.  Host clock only: a phase that
    enqueues work on a card ends when the host returns, so synchronise
    inside the phase where its device work must count.
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = ["phase                 total_ms   calls   avg_ms   share"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            c = self.counts[name]
            lines.append(
                f"{name:<20} {t * 1e3:9.3f} {c:7d} {t / c * 1e3:8.3f} "
                f"{t / total * 100:6.1f}%"
            )
        return "\n".join(lines)

    def report(self):
        print(self.summary())


def _device_of(args):
    """The device of the first argument that has one (a tensor, or one of
    the port's matrix operators), else the CPU."""
    for a in args:
        dev = getattr(a, "device", None)
        if isinstance(dev, torch.device):
            return dev
    return torch.device("cpu")


def device_time(fn: Callable, *args, reps: int = 30, warmup: int = 10) -> float:
    """Mean seconds per call of ``fn(*args)`` over ``reps`` calls made back
    to back, after ``warmup`` calls.  Where the arguments lie on a CUDA
    device the time is the device's, between two CUDA events around the
    calls; where they lie on the CPU it is the host clock's."""
    dev = _device_of(args)
    for _ in range(warmup + 1):
        fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        stream = torch.cuda.current_stream(dev)
        start.record(stream)
        for _ in range(reps):
            fn(*args)
        stop.record(stream)
        torch.cuda.synchronize(dev)
        return start.elapsed_time(stop) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return (time.perf_counter() - t0) / reps
