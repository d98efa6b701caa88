"""The program's spans (``pogs_tpu_torch.utils.profiling``'s ``span`` and
``SPANS``) under a CPU ``torch.profiler`` session: the tree that each entry
the benchmark drives opens, nothing entered when no session records, and
the same answers either way."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import pogs_tpu_torch as P
from pogs_tpu_torch.parallel import solve_lasso_path
from pogs_tpu_torch.utils.profiling import SPANS, span

INIT = ["pogs.init", "pogs.init.equilibrate", "pogs.init.norm_est", "pogs.init.factor"]
MARK = "test.call"


def _problem():
    rng = np.random.default_rng(18)
    A = rng.standard_normal((60, 40))
    b = rng.standard_normal(60)
    return A, b, 0.2 * float(np.abs(A.T @ b).max())


# Each case makes its calls afresh: a list of (call, FunctionVectors the
# call builds, whether it inits); a call returns (x, iterations, status).

def _lasso():
    A, b, lam = _problem()

    def call():
        out = P.solve_lasso(A, b, lam, device="cpu")
        return out["x"], out["iterations"], out["status"]

    return [(call, 2, True)]


def _refit():
    A, b, lam = _problem()
    solver = P.GraphFormSolver(A, device="cpu")

    def call(scale):
        def run():
            f = P.FunctionVector(P.Function.SQUARE, 60, b=scale * b)
            g = P.FunctionVector(P.Function.ABS, 40, c=lam)
            solver.reset_warm_start()
            res = solver.solve(f, g)
            return res.x.numpy(), int(res.final_iter), int(res.status)
        return run

    return [(call(1.0), 2, True), (call(0.5), 2, False)]


def _path():
    A, b, lam = _problem()
    lams = torch.tensor([1.0, 0.5, 0.25, 0.125], dtype=torch.float64) * lam
    # The batched kernel's plain version: the branch a float32 path takes on
    # the card.
    settings = P.SolverSettings(use_fused=True)

    def call():
        out = solve_lasso_path(torch.as_tensor(A), torch.as_tensor(b), lams,
                               settings=settings, device="cpu")
        return out["x"].numpy(), out["iterations"].numpy(), out["status"].numpy()

    return [(call, 2, True)]


CASES = {"solve_lasso": _lasso, "refit": _refit, "solve_lasso_path": _path}


def _run(calls, traced: bool):
    """Each call's result and, traced, its spans (start, end, name) by start."""
    if not traced:
        return [run() for run, _, _ in calls], None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        results = []
        for run, _, _ in calls:
            with record_function(MARK):
                results.append(run())
    events = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.name() == MARK or e.name().startswith("pogs.")),
                    key=lambda t: (t[0], -t[1]))
    marks = [(s, e) for s, e, n in events if n == MARK]
    per_call = [[t for t in events if t[2] != MARK and s <= t[0] and t[1] <= e]
                for s, e in marks]
    assert sum(map(len, per_call)) == len(events) - len(marks)
    return results, per_call


@pytest.mark.parametrize("case", sorted(CASES))
def test_span_tree(case):
    calls = CASES[case]()
    _, per_call = _run(calls, traced=True)
    assert len(per_call) == len(calls)
    for (_, built, inits), spans in zip(calls, per_call):
        names = [n for _, _, n in spans]
        assert set(names) <= set(SPANS)
        top = []
        for s, e, n in spans:
            if n == "pogs.call" and not (top and s < top[-1][1]):
                top.append((s, e))
        assert len(top) == 1
        init = [t for t in spans if t[2] in INIT]
        if inits:
            assert [n for _, _, n in init] == INIT
            s0, e0, _ = init[0]
            assert all(s0 <= s and e <= e0 for s, e, _ in init[1:])
            assert top[0][0] <= s0 and e0 <= top[0][1]
        else:
            assert init == []
        assert names.count("pogs.prepare") == 1
        assert names.count("pogs.functions") == built


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_session_enters_no_range(case, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with span("pogs.call"):
        pass
    for run, _, _ in CASES[case]():
        run()


@pytest.mark.parametrize("case", sorted(CASES))
def test_answers_do_not_depend_on_tracing(case):
    off, _ = _run(CASES[case](), traced=False)
    on, _ = _run(CASES[case](), traced=True)
    for a, b in zip(off, on):
        for u, v in zip(a, b):
            assert np.array_equal(np.asarray(u), np.asarray(v))
