"""Reductions of the traced window that several per-layer readers share.

Times are on the profiler's clock (µs); a reader that finds nothing to
read returns None and the harness leaves its metric out of the line.
"""

from __future__ import annotations

import bisect

from perfbench.trace import union_us


def device_busy_us(tr, w0: float, w1: float) -> float:
    """Time in [w0, w1] in which an operation ran on the device: the union
    of the device operations' intervals clipped to it (µs)."""
    return union_us((max(op.start, w0), min(op.end, w1)) for op in tr.device_ops
                    if min(op.end, w1) > max(op.start, w0))


def solve_launches(ctx, kernel: str):
    """(call start, host launch of the call's first ``kernel``) per call
    span in which the kernel's launch was found."""
    launches = sorted(ts for ts in (ctx.trace.launch_ts(op) for op in ctx.trace.kernels(kernel))
                      if ts is not None)
    out = []
    for s, e in ctx.trace.span_list("perfbench.call"):
        first = next((ts for ts in launches if s <= ts <= e), None)
        if first is not None:
            out.append((s, first))
    return out


def mean_prelaunch_ms(ctx, kernel: str):
    """Mean milliseconds from a call's start to its solve kernel's launch."""
    pairs = solve_launches(ctx, kernel)
    return sum(t - s for s, t in pairs) / len(pairs) / 1e3 if pairs else None


def mean_launches_before(ctx, kernel: str):
    """Mean count of kernels a call launches before its solve kernel."""
    pairs = solve_launches(ctx, kernel)
    if not pairs:
        return None
    starts = sorted(ts for ts in (ctx.trace.launch_ts(op) for op in ctx.trace.kernels())
                    if ts is not None)
    return sum(bisect.bisect_left(starts, t) - bisect.bisect_left(starts, s)
               for s, t in pairs) / len(pairs)


def kernel_ms(ctx, kernel: str) -> float:
    """Summed device time of ``kernel`` inside the window (ms)."""
    w0, w1 = ctx.window
    return sum(max(0.0, min(op.end, w1) - max(op.start, w0))
               for op in ctx.trace.kernels(kernel)) / 1e3


def roofline_share(ctx, kernel: str, bound_ms_of):
    """100 × the summed least time of the window's calls (``bound_ms_of``
    of each record) over the kernel's summed device time."""
    t = kernel_ms(ctx, kernel)
    if t <= 0:
        return None
    return 100.0 * sum(bound_ms_of(r) for r in ctx.records) / t
