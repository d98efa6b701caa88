"""Reductions of the program's own spans in the traced window.

The program opens ``torch.profiler.record_function`` ranges named ``pogs.*``
(``pogs_tpu_torch/utils/profiling.py``'s ``SPANS``) on the host thread, on
the profiler's clock; ``perfbench/trace.py`` files them under
``Trace.host_ops``.  A program without them gives every reader here None.

A span's *extended end* is the later of its host end and the time the
device had finished the kernels the host launched by then: the card may
run what the span launched after the host has left it (``DeviceProgress``).
Copies and fills are issued through calls ``Trace.launches`` does not hold,
so only kernels extend a span.  Times are µs on the profiler's clock; the
readers return ms.
"""

from __future__ import annotations

import bisect

from perfbench.trace import merged

PREFIX = "pogs."
CALL = "pogs.call"
INIT = "pogs.init"
# The children of pogs.init, in the order the program opens them.
INIT_PARTS = ("pogs.init.equilibrate", "pogs.init.norm_est", "pogs.init.factor")


def program_spans(tr, name: str = None) -> list:
    """(start, end, name) of the program's spans, or of those named
    ``name``, by start; an enclosing span before the spans it holds."""
    return sorted(((s, e, n) for n, s, e in tr.host_ops
                   if n.startswith(PREFIX) and (name is None or n == name)),
                  key=lambda t: (t[0], -t[1]))


def outermost(spans: list) -> list:
    """The spans of a ``program_spans`` list that no other of them holds."""
    out = []
    for s, e, n in spans:
        if not out or s >= out[-1][1]:
            out.append((s, e, n))
    return out


def inside(spans: list, s: float, e: float) -> list:
    """The spans of a ``program_spans`` list that lie within [s, e]."""
    lo = bisect.bisect_left(spans, (s,))
    hi = bisect.bisect_right(spans, (e, float("inf")))
    return [t for t in spans[lo:hi] if t[1] <= e]


class DeviceProgress:
    """How far the device had got with the kernels the host launched.

    ``extended_end(t)``: the later of t and the device end of as many
    kernels as the host had launched by t, taken in the order they started
    on the device (the running maximum of their ends).  On one stream, which
    starts kernels in the order the host launched them, that is the end of
    the last kernel launched by t.  Correlation ids do not pair kernels with
    their launches: a kernel launched from inside a PyTorch operator
    carries the operator's id, not its launch call's."""

    def __init__(self, tr):
        self.ts = sorted(tr.launches.values())
        self.ends, top = [], float("-inf")
        for op in sorted(tr.kernels(), key=lambda op: op.start):
            top = max(top, op.end)
            self.ends.append(top)

    def extended_end(self, t: float) -> float:
        k = min(bisect.bisect_right(self.ts, t), len(self.ends))
        return max(t, self.ends[k - 1]) if k else t


def _mean_ms(values):
    return sum(values) / len(values) / 1e3 if values else None


def mean_total_ms(ctx, name: str):
    """Mean per call (``perfbench.call``) of the summed durations of the
    spans named ``name`` inside it."""
    spans = program_spans(ctx.trace, name)
    calls = ctx.trace.span_list("perfbench.call")
    if not spans or not calls:
        return None
    return _mean_ms([sum(e - s for s, e, _ in inside(spans, c0, c1)) for c0, c1 in calls])


def finish_ms(ctx):
    """Mean per outermost ``pogs.call`` from the device end of its last
    solve kernel (``ctx.entry.kernel``, started between the call's start
    and its extended end) to the call's extended end: the unscale, the wait
    for the status and the result."""
    progress = DeviceProgress(ctx.trace)
    solves = sorted((op.start, op.end) for op in ctx.trace.kernels(ctx.entry.kernel))
    values = []
    for s, e, _ in outermost(program_spans(ctx.trace, CALL)):
        end = progress.extended_end(e)
        ran = solves[bisect.bisect_left(solves, (s,)):bisect.bisect_right(solves, (end,))]
        if ran:
            values.append(end - ran[-1][1])
    return _mean_ms(values)


def init_span_ms(ctx):
    """Mean per ``pogs.init`` (the calls that init) from its start to its
    extended end."""
    progress = DeviceProgress(ctx.trace)
    return _mean_ms([progress.extended_end(e) - s
                     for s, e, _ in outermost(program_spans(ctx.trace, INIT))])


def init_parts(ctx) -> list:
    """Per ``pogs.init`` that holds its three children, each child's
    critical-path share (µs) by name: from the later of its start and the
    previous child's extended end to its own extended end.  The shares tile
    the init: device work that runs on under the next child's host work
    counts once, in the child that launched it."""
    progress = DeviceProgress(ctx.trace)
    spans = program_spans(ctx.trace)
    out = []
    for s, e, _ in outermost(program_spans(ctx.trace, INIT)):
        held = inside(spans, s, e)
        kids = [next((t for t in held if t[2] == part), None) for part in INIT_PARTS]
        if None in kids:
            continue
        shares, prev = {}, float("-inf")
        for cs, ce, name in kids:
            end = progress.extended_end(ce)
            shares[name] = end - max(cs, prev)
            prev = end
        out.append(shares)
    return out


def init_part_ms(ctx, part: str):
    """Mean over the calls that init of ``part``'s share (``init_parts``)."""
    return _mean_ms([shares[part] for shares in init_parts(ctx)])


def idle_gaps(tr, w0: float, w1: float) -> list:
    """The intervals of [w0, w1] in which no operation ran on the device."""
    busy = merged((max(op.start, w0), min(op.end, w1)) for op in tr.device_ops
                  if min(op.end, w1) > max(op.start, w0))
    gaps, last = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    return gaps


def idle_by_span(ctx):
    """The window's device-idle time inside the program's spans, in ms per
    call (``perfbench.call``), by the innermost span around each idle
    instant; None where the trace holds no program span or no device
    operation."""
    tr = ctx.trace
    spans = program_spans(tr)
    calls = tr.span_list("perfbench.call")
    if not spans or not calls or not tr.device_ops:
        return None
    groups = []                    # top-level spans, each with the spans it holds
    for t in spans:
        if groups and t[0] < groups[-1][1]:
            groups[-1][2].append(t)
        else:
            groups.append([t[0], t[1], [t]])
    starts = [g[0] for g in groups]
    idle = {}
    for g0, g1 in idle_gaps(tr, *ctx.window):
        i = max(0, bisect.bisect_right(starts, g0) - 1)
        while i < len(groups) and groups[i][0] < g1:
            s, e, held = groups[i]
            i += 1
            a, b = max(g0, s), min(g1, e)
            if b <= a:
                continue
            cuts = sorted({a, b} | {x for t in held for x in t[:2] if a < x < b})
            for p0, p1 in zip(cuts, cuts[1:]):
                mid = 0.5 * (p0 + p1)
                around = [t for t in held if t[0] <= mid <= t[1]]
                if around:
                    name = max(around, key=lambda t: (t[0], -t[1]))[2]
                    idle[name] = idle.get(name, 0.0) + p1 - p0
    return {name: v / len(calls) / 1e3 for name, v in idle.items()}


def program_idle_ms(ctx):
    """Mean per call of the window's device-idle time inside any program
    span."""
    by_span = idle_by_span(ctx)
    return None if by_span is None else sum(by_span.values())
