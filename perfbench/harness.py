"""One run of one cell: set-up, the measured window, the check, the result.

The cell's entry in ``BENCHMARK.json`` names a configuration and a traffic
mix; ``perfbench/workloads/<cell>.json`` repeats both and holds the cell's
own data (how many answers the reference judges, and the limit of each
number it compares).  The configuration (``configs/<config>.json``) names
its problem family, whose module (``problems/<problem>.py``) makes the
inputs and calls the program for the entry that the traffic mix
(``traffic/<traffic>.json``) names.  Per-layer metrics are read from the
traced window by ``metrics/<metric>.py``.  Nothing here names a cell.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from perfbench import data
from perfbench import trace as trace_mod
from perfbench.layers import device_busy_us

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
COUNTERS = ("fused_admm_loop", "fused_batched_lasso_sweep.resident",
            "fused_batched_lasso_sweep.stream", "fused_hsde_solve")


def load_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    sample: int

    @property
    def end_to_end(self):
        return [m for m in self.bench["end_to_end"] if self.name in m.get("workloads", [self.name])]

    @property
    def per_layer(self):
        return [m for m in self.bench["per_layer"] if self.name in m.get("workloads", [self.name])]


def load_cell(name: str, root: Path = ROOT, overrides: dict = None,
              traffic_overrides: dict = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files; ``overrides``
    and ``traffic_overrides`` replace configuration and traffic keys (the
    CPU tests' small sizes)."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = load_json(HERE / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if wl[key] != entry[key]:
            raise ValueError(f"{name}: workloads/{name}.json names {key} {wl[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    cfg = dict(load_json(HERE / "configs" / f"{entry['config']}.json"))
    cfg.update(overrides or {})
    traffic = dict(load_json(HERE / "traffic" / f"{entry['traffic']}.json"))
    traffic.update(traffic_overrides or {})
    return Cell(name, bench, wl, cfg, traffic, wl["limits"], wl["sample"])


def make_entry(cell: Cell, P, seed: int, device):
    problem = importlib.import_module(f"perfbench.problems.{cell.config['problem']}")
    return problem.ENTRIES[cell.traffic["entry"]](P, cell.config, cell.traffic, seed, device)


def launch_counts(P) -> dict:
    from pogs_tpu_torch.ops.fused_admm import fused_admm_loop
    from pogs_tpu_torch.ops.fused_admm_batch import fused_batched_lasso_sweep
    from pogs_tpu_torch.ops.fused_hsde import fused_hsde_solve

    by_route = fused_batched_lasso_sweep.launches_by_route
    return {"fused_admm_loop": fused_admm_loop.launches,
            "fused_batched_lasso_sweep.resident": by_route["resident"],
            "fused_batched_lasso_sweep.stream": by_route["stream"],
            "fused_hsde_solve": fused_hsde_solve.launches}


def route_misses(route: dict, before: dict, after: dict, calls: int) -> int:
    """Counters that moved otherwise than ``route`` (launches per call) says."""
    return sum(int(after[c] - before[c] != route.get(c, 0) * calls) for c in COUNTERS)


def p95(values):
    """The 95th percentile by nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


@dataclass
class Window:
    records: list = field(default_factory=list)   # per call: ms, status, iters, kept
    seconds: float = 0.0
    trace: object = None


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_window(entry, seconds: float, device, traced: bool, call=None,
               max_calls: int = None) -> Window:
    """Closed loop, one client: make a request (span ``perfbench.request``),
    call the program (span ``perfbench.call``) and wait for its result,
    until ``seconds`` have passed (or ``max_calls`` calls are done); the
    last call started finishes inside the window.  ``call`` replaces the
    program's call (the control), and returns what ``keep`` would."""
    from torch.profiler import ProfilerActivity, profile, record_function

    call = call or entry.call
    keep = entry.keep if call == entry.call else (lambda req, out: out)
    win = Window()
    prof = None
    if traced:
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        with record_function("perfbench.window"):
            t_start = time.perf_counter()
            deadline = t_start + seconds
            i = 0
            while time.perf_counter() < deadline and (max_calls is None or i < max_calls):
                with record_function("perfbench.request"):
                    req = entry.request(i)
                    _sync(device)
                t0 = time.perf_counter()
                with record_function("perfbench.call"):
                    out = call(req)
                    _sync(device)
                ms = (time.perf_counter() - t0) * 1e3
                kept = keep(req, out)
                win.records.append({"ms": ms, "status": kept["status"], "iters": kept["iters"],
                                    "kept": kept})
                i += 1
            win.seconds = time.perf_counter() - t_start
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    if prof is not None:
        win.trace = trace_mod.collect(prof)
    return win


def judge(cell: Cell, entry, win: Window, seed: int, route_miss: int) -> dict:
    """Every number the check compares, each with its limit: the window's
    unsolved answers and route, and the reference's numbers on a sample of
    answers drawn from the seed, the call with the most iterations in it."""
    recs = win.records
    unsolved = sum(int(s != 0) for r in recs for s in r["status"])
    longest = max(range(len(recs)), key=lambda i: sum(recs[i]["iters"])) if recs else None
    idx = data.sample(seed, len(recs), cell.sample, [] if longest is None else [longest])
    numbers = entry.judge([recs[i]["kept"] for i in idx]) if idx else {}
    checks = {"unsolved": (unsolved, 0), "route": (route_miss, 0)}
    for key, limit in cell.limits.items():
        checks[key] = (numbers.get(key, math.inf), limit)
    info = {k: v for k, v in numbers.items() if k not in cell.limits}
    info["judged"] = len(idx)
    return {"checks": checks, "info": info}


def reader(metric: str):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Context:
    """What a per-layer reader reads: the traced window and the records."""
    cell: Cell
    entry: object
    trace: object
    records: list
    window: tuple            # (start, end) of the traced window, µs


def breakdown(tr, w0, w1, top=10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the innermost host operation or span around their middle."""
    by_name = {}
    busy = []
    for op in tr.device_ops:
        s, e = max(op.start, w0), min(op.end, w1)
        if e > s:
            by_name[op.name] = by_name.get(op.name, 0.0) + (e - s) / 1e6
            busy.append((s, e))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, last = [], w0
    for s, e in trace_mod.merged(busy) + [[w1, w1]]:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    host = tr.host_ops + tr.spans
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        around = [(e - s, n) for n, s, e in host if s <= mid <= e]
        name = min(around)[1] if around else "idle"
        named.append([name, (g1 - g0) / 1e6])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}


def run_cell(name: str, seed: int, seconds: float, traced: bool, device="cuda",
             t_process: float = None, overrides: dict = None, root: Path = ROOT,
             P=None, traffic_overrides: dict = None, early=()) -> dict:
    """One run of the cell; returns the result line's object and the lines
    of the check for standard error.  ``early`` holds the (phase, end time)
    of set-up's phases before this call."""
    t_process = time.perf_counter() if t_process is None else t_process
    marks = [("process", t_process), *early, ("harness", time.perf_counter())]
    cell = load_cell(name, root, overrides, traffic_overrides)
    if P is None:
        import pogs_tpu_torch as P
    if torch.device(device).type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
    marks.append(("program_and_context", time.perf_counter()))
    entry = make_entry(cell, P, seed, device)
    entry.setup()
    _sync(device)
    marks.append(("inputs_and_init", time.perf_counter()))
    warm = entry.request(None)
    entry.keep(warm, entry.call(warm))
    del warm
    _sync(device)
    marks.append(("warm_up", time.perf_counter()))
    setup_s = time.perf_counter() - t_process

    before = launch_counts(P)
    win = run_window(entry, seconds, device, traced)
    after = launch_counts(P)
    on_card = torch.device(device).type == "cuda"
    # The counters count kernel launches; on the CPU the plain versions run.
    miss = route_misses(entry.route, before, after, len(win.records)) if on_card else 0
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if on_card else 0}
    metrics, extra = {}, {}
    solves = sum(len(r["status"]) for r in win.records)
    calls_ms = [r["ms"] for r in win.records]
    lines = ["setup_s " + ", ".join(f"{n} {t - marks[k][1]:.3f}"
                                    for k, (n, t) in enumerate(marks[1:]))
             + f", total {setup_s:.3f}",
             f"calls {len(calls_ms)}, solves {solves}, window {win.seconds:.3f} s, call_ms "
             f"median {statistics.median(calls_ms):.4f} p95 {p95(calls_ms):.4f}"]
    if traced:
        spans = win.trace.span_list("perfbench.window")
        w0, w1 = spans[0] if spans else (0.0, 0.0)
        busy = device_busy_us(win.trace, w0, w1) / 1e6
        dev.update(busy_s=busy, window_s=(w1 - w0) / 1e6)
        ctx = Context(cell, entry, win.trace, win.records, (w0, w1))
        for m in cell.per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra["breakdown"] = breakdown(win.trace, w0, w1)
    else:
        e2e = {"solves_per_s": solves / win.seconds, "call_ms_p95": p95(calls_ms),
               "setup_s": setup_s}
        # "<quantity>.<cells>" is the quantity, under a bound of its own in
        # those cells (BENCHMARK.json splits a metric whose cells spread
        # differently).
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]}

    # The check, once the window has closed, the peak read and the
    # program's state let go.
    entry.release()
    verdict = judge(cell, entry, win, seed, miss)
    checks = verdict["checks"]
    correct = all(v <= lim for v, lim in checks.values())
    failed = sum(int(s != 0) for r in win.records for s in r["status"])
    for key, value in verdict["info"].items():
        lines.append(f"reference {key} {value}")
    lines += [f"check {key} {v} limit {lim}" for key, (v, lim) in checks.items()]
    result = {"correct": correct, "attempted": solves, "failed": failed,
              "metrics": metrics, "device": dev, **extra,
              "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}}
    return {"result": result, "lines": lines}


def foreign_modules() -> list:
    """Top-level names in sys.modules that the run must not hold."""
    banned = {"jax", "jaxlib", "flax", "pogs_tpu"}
    return sorted({k.split(".")[0] for k in list(sys.modules)} & banned)
