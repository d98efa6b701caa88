"""The traced run's events, read from ``torch.profiler`` in memory.

``Trace`` holds what the per-layer readers need and nothing else: the
device operations (kernels, copies, fills) with their launch's correlation
id, the host's launch calls by correlation id, the benchmark's own spans
(``perfbench.*``) and the host's operators (for naming idle gaps), all on
the profiler's clock in microseconds.  ``union_us`` is the interval
arithmetic of ``pogs_tpu_torch/utils/profiling.py``'s ``busy_time``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

SPAN_PREFIX = "perfbench."


def union_us(intervals) -> float:
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


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclass
class DeviceOp:
    name: str
    start: float
    end: float
    corr: int
    kind: str                     # "kernel", "memcpy" or "memset"


@dataclass
class Trace:
    device_ops: list = field(default_factory=list)     # DeviceOp
    launches: dict = field(default_factory=dict)       # correlation id -> host ts
    spans: list = field(default_factory=list)          # (name, start, end)
    host_ops: list = field(default_factory=list)       # (name, start, end)

    def kernels(self, name_part=None):
        return [op for op in self.device_ops if op.kind == "kernel"
                and (name_part is None or name_part in op.name)]

    def span_list(self, name):
        return sorted((s, e) for n, s, e in self.spans if n == name)

    def launch_ts(self, op):
        return self.launches.get(op.corr)


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def _is_launch(name: str) -> bool:
    return name.startswith(("cuda", "cu")) and "Launch" in name


def collect(prof) -> Trace:
    """The events of a finished ``torch.profiler.profile`` session."""
    tr = Trace()
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns() / 1e3
        end = start + ev.duration_ns() / 1e3
        if "CUDA" in str(ev.device_type()):
            if name.startswith(SPAN_PREFIX) or ev.is_user_annotation():
                continue    # a record_function range mirrored on the device's timeline
            corr = ev.linked_correlation_id() or ev.correlation_id()
            tr.device_ops.append(DeviceOp(name, start, end, corr, _kind(name)))
        elif name.startswith(SPAN_PREFIX):
            tr.spans.append((name, start, end))
        elif _is_launch(name):
            tr.launches[ev.correlation_id()] = start
        else:
            tr.host_ops.append((name, start, end))
    return tr
