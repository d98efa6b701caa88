"""The readers of the program's spans (``perfbench/spans.py`` and the
metrics over it) on hand-built traces whose answers are known, and on a
traced CPU run of each cell.

The trace (µs): two calls in a window [0, 300].  The first inits: its
equilibration's kernel runs on [13, 24], past the child's host end at 20 and
under the norm estimate's host work, which starts at 21; the solve kernel
runs [61, 90], an unscale [90, 91], and the call's host span waits to 95.  A
nested ``pogs.call`` (a builder around ``solve_graph_form``) sits inside the
first.  The second call re-solves without init, and its ``pogs.call``
returns at 230, before its kernels end at 255."""

from types import SimpleNamespace

import pytest

from perfbench import harness, spans
from perfbench.trace import DeviceOp, Trace

KERNEL = "fused_admm_kernel"

PROGRAM = [
    ("pogs.call", 1, 95), ("pogs.functions", 2, 4), ("pogs.functions", 4.5, 6),
    ("pogs.call", 8, 94),
    ("pogs.init", 10, 50), ("pogs.init.equilibrate", 11, 20),
    ("pogs.init.norm_est", 21, 30), ("pogs.init.factor", 31, 45),
    ("pogs.prepare", 52, 60),
    ("pogs.functions", 201, 203), ("pogs.call", 205, 230), ("pogs.prepare", 206, 210),
]
# (name, device start, device end, correlation id, host launch)
OPS = [
    ("gemv", 13, 24, 1, 12), ("gemv", 24, 33, 2, 22), ("sgemm", 33, 40, 3, 32),
    (KERNEL, 61, 90, 4, 58), ("mul", 90, 91, 5, 62),
    (KERNEL, 212, 250, 6, 209), ("mul", 250, 255, 7, 211),
]


def _trace(program=PROGRAM, ops=OPS, calls=((0, 100), (200, 300))):
    tr = Trace()
    tr.spans = [("perfbench.window", 0, 300)] + [("perfbench.call", s, e) for s, e in calls]
    tr.host_ops = list(program) + [("aten::mul", 62, 62.5)]
    for name, s, e, corr, ts in ops:
        tr.device_ops.append(DeviceOp(name, s, e, corr, "kernel"))
        tr.launches[corr] = ts
    return tr


def _ctx(tr):
    return harness.Context(None, SimpleNamespace(kernel=KERNEL), tr, [], (0.0, 300.0))


# µs per call (or per init) → ms.
EXPECTED = {
    "functions_ms": (3.5 + 2) / 2,
    "prepare_ms": (8 + 4) / 2,
    "finish_ms": ((95 - 90) + (255 - 250)) / 2,
    "init_span_ms.oneshot": 50 - 10,
    "init_span_ms.path": 50 - 10,
    "equil_ms.oneshot": 24 - 11,
    "norm_est_ms.oneshot": 33 - 24,
    "factor_ms.oneshot": 45 - 33,
    # Idle [0, 13], [40, 61], [91, 212], [255, 300] inside program spans:
    # 12 + 21 + (4 + 2 + 7) + 0.
    "program_idle_ms": 46 / 2,
    "program_idle_ms.oneshot": 46 / 2,
}
NEW = sorted(EXPECTED)


@pytest.mark.parametrize("metric", NEW)
def test_reader_on_a_known_trace(metric):
    assert harness.reader(metric)(_ctx(_trace())) == pytest.approx(EXPECTED[metric] / 1e3)


def test_correlation_ids_change_nothing():
    """A kernel launched from inside a PyTorch operator carries the
    operator's correlation id, which may name another launch: the readers
    count launches and kernels instead, so such ids change nothing."""
    tr = _trace()
    for op, corr in zip(tr.device_ops, (7, 6, 5, 4, 3, 2, 1)):
        op.corr = corr
    for metric in NEW:
        assert harness.reader(metric)(_ctx(tr)) == pytest.approx(EXPECTED[metric] / 1e3)


def test_init_parts_tile_the_init():
    """The equilibration's device tail under the norm estimate's host work
    counts once: each child from the later of its start and the previous
    child's extended end, so no interval counts twice."""
    (shares,) = spans.init_parts(_ctx(_trace()))
    assert shares == {"pogs.init.equilibrate": 13, "pogs.init.norm_est": 9,
                      "pogs.init.factor": 12}
    each_from_its_start = (24 - 11) + (33 - 21) + (45 - 31)
    overlaps = (24 - 21) + (33 - 31)
    assert sum(shares.values()) == each_from_its_start - overlaps <= 50 - 10


def test_idle_by_innermost_span():
    by_span = spans.idle_by_span(_ctx(_trace()))
    expected = {"pogs.call": 15.5, "pogs.functions": 5.5, "pogs.init": 6,
                "pogs.init.equilibrate": 2, "pogs.init.factor": 5, "pogs.prepare": 12}
    assert by_span == pytest.approx({k: v / 2 / 1e3 for k, v in expected.items()})


def test_a_call_without_init():
    """A window of re-solves: the init readers find nothing, the others read
    the one call."""
    second = [t for t in PROGRAM if t[1] >= 200]
    ctx = _ctx(_trace(second, OPS[5:], calls=((200, 300),)))
    for metric in ("init_span_ms.oneshot", "equil_ms.oneshot", "norm_est_ms.oneshot",
                   "factor_ms.oneshot"):
        assert harness.reader(metric)(ctx) is None
    assert harness.reader("prepare_ms")(ctx) == pytest.approx(4 / 1e3)
    assert harness.reader("finish_ms")(ctx) == pytest.approx(5 / 1e3)


@pytest.mark.parametrize("metric", NEW)
def test_no_program_spans_reads_none(metric):
    """A program without spans (the parent of the spans) prints nothing."""
    assert harness.reader(metric)(_ctx(_trace(program=[]))) is None


def test_names_are_the_programs():
    from pogs_tpu_torch.utils.profiling import SPANS

    assert {spans.CALL, spans.INIT, *spans.INIT_PARTS} <= set(SPANS)
    assert {"pogs.functions", "pogs.prepare"} <= set(SPANS)
    assert all(n.startswith(spans.PREFIX) for n in SPANS)


# The new metrics a traced CPU run can read: no device operation there, so
# neither the idle time nor a kernel's end.
ON_THE_CPU = {"lasso-10000x5000.refit": {"functions_ms", "prepare_ms"},
              "lasso-10000x5000.oneshot": {"init_span_ms.oneshot", "equil_ms.oneshot",
                                           "norm_est_ms.oneshot", "factor_ms.oneshot"},
              "lasso-10000x5000.path100": {"prepare_ms", "init_span_ms.path"}}
SMALL = {"lasso-10000x5000.refit": dict(m=400, n=200),
         "lasso-10000x5000.oneshot": dict(m=400, n=200),
         "lasso-10000x5000.path100": dict(m=300, n=150)}


@pytest.mark.parametrize("cell", sorted(ON_THE_CPU))
def test_traced_cpu_run_reads_the_spans(cell):
    out = harness.run_cell(cell, 2 ** 32 + 7, 0.2, True, device="cpu", overrides=SMALL[cell],
                           traffic_overrides={"nlambda": 8} if "path" in cell else None)
    got = out["result"]["metrics"]
    assert ON_THE_CPU[cell] <= set(got)
    assert all(got[m]["value"] > 0 and got[m]["unit"] == "ms" for m in ON_THE_CPU[cell])
    if "oneshot" in cell:
        parts = sum(got[m]["value"] for m in ("equil_ms.oneshot", "norm_est_ms.oneshot",
                                              "factor_ms.oneshot"))
        assert parts <= got["init_span_ms.oneshot"]["value"]
