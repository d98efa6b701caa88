"""The port's QP and LP front ends against pogs_tpu's, on the same inputs.

``solve_qp``, ``solve_lp`` and ``solve_qps`` of both packages on the CPU in
float64, from the same seeded numpy data, through each route of
``ConeSolver``'s QP path:

* ``ipm``: the host IPM certifies the point (the default with polish on).
  Both packages run the same numpy code: the same status and iterations,
  optval within 1e-12 relative and x within 1e-12;
* ``hsde``: the epigraph-SOC HSDE solve (``polish=False``: one unstaged
  solve; or with the IPM patched out of both packages: the staged solve,
  500-iteration segments with the PDAS polish after each), and
  ``qp_via="admm"``: the same status and iterations, optval within 1e-8
  relative and x within 1e-7;
* ``closed``: presolve and the separable / unconstrained closed forms
  (numpy in both): within 1e-12.

The warm re-solve is held to the JAX package's x on the same inputs (its
SciPy SLSQP reference fails on the perturbed QP, ROADMAP.md §3).
"""

import contextlib
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pogs_tpu.solver.cone as j_cone
from pogs_tpu import solve_lp as j_solve_lp, solve_qp as j_solve_qp, solve_qps as j_solve_qps

import pogs_tpu_torch as P
import pogs_tpu_torch.solver.cone as p_cone

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
TOL = dict(abs_tol=1e-7, rel_tol=1e-7, max_iter=20000, dtype=np.float64)
LIMITS = {"ipm": (1e-12, 1e-12), "closed": (1e-12, 1e-12), "hsde": (1e-8, 1e-7)}


def _rand_qp(seed=42, n=12, n_eq=3, n_in=8, cond=100.0):
    """tests/test_qp_api.py's random QP: some inequalities active."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    Pm = Q @ np.diag(np.geomspace(1.0, cond, n)) @ Q.T
    q = rng.standard_normal(n)
    A = rng.standard_normal((n_eq, n))
    b = rng.standard_normal(n_eq)
    G = rng.standard_normal((n_in, n))
    x0 = rng.standard_normal(n) * 0.1
    h = G @ x0 + np.where(rng.random(n_in) < 0.5, 0.0, 0.8)
    return Pm, q, G, h, A, b


@contextlib.contextmanager
def _no_ipm():
    """Both packages with the host IPM patched out: the staged HSDE route."""
    saved = (j_cone.ConeSolver._try_qp_ipm, p_cone.ConeSolver._try_qp_ipm)
    j_cone.ConeSolver._try_qp_ipm = lambda self, *a: None
    p_cone.ConeSolver._try_qp_ipm = lambda self, *a: None
    try:
        yield
    finally:
        j_cone.ConeSolver._try_qp_ipm, p_cone.ConeSolver._try_qp_ipm = saved


def _assert_same(rj, rp, route):
    rel, atol = LIMITS[route]
    assert rp["status"] == rj["status"]
    assert rp["iterations"] == rj["iterations"]
    if np.isnan(rj["optval"]):
        assert np.isnan(rp["optval"])
    else:
        assert abs(rp["optval"] - rj["optval"]) <= rel * max(1.0, abs(rj["optval"]))
    np.testing.assert_allclose(rp["x"], np.asarray(rj["x"]), atol=atol)
    for key in ("y_eq", "z_ineq", "z_lb", "z_ub"):
        if key in rj:
            scale = max(1.0, float(np.abs(rj[key]).max(initial=0.0)))
            np.testing.assert_allclose(rp[key], np.asarray(rj[key]), atol=atol * 100 * scale)


def _box(seed=3, n=10):
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    Pm = Q @ np.diag(np.geomspace(1.0, 50.0, n)) @ Q.T
    return dict(P=Pm, q=3 * rng.standard_normal(n), lb=-0.4 * np.ones(n), ub=0.3 * np.ones(n))


def _partial_bounds(n=8):
    lb = np.full(n, -np.inf)
    lb[::2] = 0.5
    ub = np.full(n, np.inf)
    ub[1] = 1.0
    return dict(P=np.eye(n), q=-np.arange(1.0, n + 1.0), lb=lb, ub=ub)


def _eq_ineq(sparse=False):
    Pm, q, G, h, A, b = _rand_qp()
    if sparse:
        G, A = sp.csr_matrix(G), sp.csr_matrix(A)
    return dict(P=Pm, q=q, G=G, h=h, A=A, b=b)


def _infeasible():
    return dict(P=np.eye(2), q=np.zeros(2), A=np.array([[1.0, 0.0], [1.0, 0.0]]),
                b=np.array([0.0, 1.0]), max_iter=5000)


def _fixed(seed=11, n=8):
    """Two fixed variables and a row only they touch (dropped by presolve)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    lb, ub = np.full(n, -2.0), np.full(n, 2.0)
    lb[2] = ub[2] = 0.7
    lb[5] = ub[5] = -1.3
    G = rng.standard_normal((4, n))
    h = G @ (0.1 * np.ones(n)) + 0.5
    G = np.vstack([G, np.zeros(n)])
    G[-1, 2], G[-1, 5] = 1.0, 2.0
    h = np.concatenate([h, [0.7 - 2.6 + 1.0]])
    return dict(P=M @ M.T + 0.5 * np.eye(n), q=rng.standard_normal(n), G=G, h=h, lb=lb, ub=ub)


def _diag(seed=5, n=10, dense=False):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.5, 3.0, n)
    G = rng.standard_normal((6, n))
    return dict(P=np.diag(p) if dense else p, q=rng.standard_normal(n), G=G,
                h=G @ (0.1 * np.ones(n)) + 0.5)


def _staged_hs21():
    """tests/test_qp_api.py's staged early exit: HS21-shaped, the DR tail
    stalls, the active set is identified within a segment."""
    return dict(P=np.diag([0.02, 2.0]), q=np.zeros(2), G=np.array([[-10.0, 1.0]]),
                h=np.array([-10.0]), lb=np.array([2.0, -50.0]), ub=np.array([50.0, 50.0]),
                abs_tol=1e-6, rel_tol=1e-6, max_iter=40000)


def _separable(seed=9, n=50):
    rng = np.random.default_rng(seed)
    return dict(P=rng.uniform(0.5, 2.0, n), q=rng.standard_normal(n), lb=np.full(n, -0.5),
                ub=np.full(n, 0.5))


def _unconstrained(seed=13, n=9):
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return dict(P=Q @ np.diag(np.geomspace(1.0, 30.0, n)) @ Q.T, q=rng.standard_normal(n))


# name: (problem kwargs, extra solve kwargs, route, patch the IPM out)
CASES = {
    "eq_ineq": (_eq_ineq, {}, "ipm", False),
    "eq_ineq_no_polish": (_eq_ineq, {"polish": False}, "hsde", False),
    "eq_ineq_staged": (_eq_ineq, {}, "hsde", True),
    "eq_ineq_admm": (_eq_ineq, {"qp_via": "admm"}, "hsde", False),
    "box": (_box, {}, "ipm", False),
    "box_no_polish": (_box, {"polish": False, "max_iter": 3000}, "hsde", False),
    "partial_bounds": (_partial_bounds, {}, "ipm", False),
    "partial_bounds_staged": (_partial_bounds, {}, "hsde", True),
    "sparse_inputs": (lambda: _eq_ineq(sparse=True), {}, "ipm", False),
    "sparse_inputs_no_polish": (lambda: _eq_ineq(sparse=True), {"polish": False, "max_iter": 100},
                                "hsde", False),
    "infeasible": (_infeasible, {}, "hsde", False),
    "presolve_on": (_fixed, {"abs_tol": 1e-8, "rel_tol": 1e-8}, "ipm", False),
    "presolve_off": (_fixed, {"abs_tol": 1e-8, "rel_tol": 1e-8, "presolve": False}, "ipm",
                     False),
    "presolve_staged": (_fixed, {"abs_tol": 1e-8, "rel_tol": 1e-8}, "hsde", True),
    "diag_P": (_diag, {"abs_tol": 1e-8, "rel_tol": 1e-8}, "ipm", False),
    "diag_P_as_dense": (lambda: _diag(dense=True), {"abs_tol": 1e-8, "rel_tol": 1e-8}, "ipm",
                        False),
    "diag_P_staged": (_diag, {"abs_tol": 1e-8, "rel_tol": 1e-8}, "hsde", True),
    "diag_P_admm": (_diag, {"qp_via": "admm"}, "hsde", False),
    "staged_early_exit": (_staged_hs21, {}, "hsde", True),
    "separable_closed_form": (_separable, {}, "closed", False),
    "unconstrained_closed_form": (_unconstrained, {}, "closed", False),
}


def _solve_both(make, extra, patch):
    prob = make()
    kw = {**TOL, **{k: v for k, v in prob.items() if k not in ("P", "q")}, **extra}
    Pm, q = prob["P"], prob["q"]
    ctx = _no_ipm() if patch else contextlib.nullcontext()
    with ctx:
        rj = j_solve_qp(Pm, q, **kw)
        rp = P.solve_qp(Pm, q, device="cpu", **kw)
    return rj, rp


@pytest.mark.parametrize("name", list(CASES))
def test_solve_qp_matches_jax(name):
    make, extra, route, patch = CASES[name]
    rj, rp = _solve_both(make, extra, patch)
    _assert_same(rj, rp, route)
    if name == "infeasible":
        assert rp["status"] == int(P.Status.INFEASIBLE)
    elif name == "sparse_inputs_no_polish":
        # The sparse extension's matrix-free cg strategy, cut short.
        assert rp["status"] == int(P.Status.MAX_ITER) and rp["iterations"] == 100
    else:
        assert rp["status"] == int(P.Status.SUCCESS)
    if name in ("presolve_on", "presolve_staged"):
        assert rp["presolve"] == rj["presolve"] == {
            "fixed_variables": 2, "dropped_ineq_rows": 1, "dropped_eq_rows": 0}
    if name == "presolve_off":
        assert "presolve" not in rp and "presolve" not in rj
    if name == "staged_early_exit":
        # The first segments' polish certifies the optimum: no full run.
        assert rp["iterations"] <= 2 * p_cone.K_QP_SEGMENT_ITERS
        np.testing.assert_allclose(rp["x"], [2.0, 0.0], atol=1e-6)


def test_presolve_off_agrees_with_on():
    prob = _fixed()
    kw = {k: v for k, v in prob.items() if k not in ("P", "q")}
    on = P.solve_qp(prob["P"], prob["q"], abs_tol=1e-8, rel_tol=1e-8, dtype=np.float64,
                    device="cpu", **kw)
    off = P.solve_qp(prob["P"], prob["q"], abs_tol=1e-8, rel_tol=1e-8, dtype=np.float64,
                     device="cpu", presolve=False, **kw)
    assert abs(on["optval"] - off["optval"]) < 1e-6
    np.testing.assert_allclose(on["x"], off["x"], atol=1e-5)


def test_diag_P_agrees_with_dense():
    kw = dict(abs_tol=1e-8, rel_tol=1e-8, dtype=np.float64, device="cpu")
    d, g = _diag(), _diag(dense=True)
    rest = {k: v for k, v in d.items() if k not in ("P", "q")}
    diag = P.solve_qp(d["P"], d["q"], **kw, **rest)
    dense = P.solve_qp(g["P"], g["q"], **kw, **rest)
    spdiag = P.solve_qp(sp.diags(d["P"]).tocsr(), d["q"], **kw, **rest)
    for out in (diag, spdiag):
        assert out["status"] == 0
        assert abs(out["optval"] - dense["optval"]) < 1e-7
        np.testing.assert_allclose(out["x"], dense["x"], atol=1e-6)


@pytest.mark.parametrize("staged", [False, True], ids=["ipm", "staged"])
def test_warm_resolve_matches_jax(staged):
    """The MPC pattern: perturb h and b, re-solve on result['solver'] with
    warm_start=True; x held to the JAX package's on the same inputs."""
    Pm, q, G, h, A, b = _rand_qp()
    rng = np.random.default_rng(1)
    h2 = h + 1e-3 * rng.standard_normal(h.shape)
    b2 = b + 1e-3 * rng.standard_normal(b.shape)
    kw = dict(TOL, max_iter=4000) if staged else TOL
    ctx = _no_ipm() if staged else contextlib.nullcontext()
    with ctx:
        oj = j_solve_qp(Pm, q, G=G, h=h, A=A, b=b, **kw)
        op = P.solve_qp(Pm, q, G=G, h=h, A=A, b=b, device="cpu", **kw)
        wj = j_solve_qp(Pm, q, G=G, h=h2, A=A, b=b2, solver=oj["solver"], warm_start=True, **kw)
        wp = P.solve_qp(Pm, q, G=G, h=h2, A=A, b=b2, solver=op["solver"], warm_start=True,
                        device="cpu", **kw)
    route = "hsde" if staged else "ipm"
    _assert_same(oj, op, route)
    _assert_same(wj, wp, route)
    assert wp["status"] == 0
    if staged:
        assert wp["iterations"] <= op["iterations"]


def test_solve_lp_matches_jax():
    rng = np.random.default_rng(21)
    n = 12
    c = rng.standard_normal(n)
    G = rng.standard_normal((20, n))
    h = G @ (0.1 * np.ones(n)) + 1.0
    A = rng.standard_normal((3, n))
    b = A @ (0.1 * np.ones(n))
    kw = dict(lb=np.full(n, -2.0), ub=np.full(n, 2.0), abs_tol=1e-7, rel_tol=1e-7,
              max_iter=20000, dtype=np.float64)
    rj = j_solve_lp(c, G, h, A, b, **kw)
    rp = P.solve_lp(c, G, h, A, b, device="cpu", **kw)
    assert rp["status"] == 0
    _assert_same(rj, rp, "hsde")


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_solve_qps_hs21_matches_jax(sparse):
    path = os.path.join(DATA, "HS21.QPS")
    kw = dict(abs_tol=1e-8, rel_tol=1e-8, dtype=np.float64, sparse=sparse)
    rj = j_solve_qps(path, **kw)
    rp = P.solve_qps(path, device="cpu", **kw)
    _assert_same(rj, rp, "ipm")
    assert rp["name"] == "HS21"
    assert abs(rp["objective"] - (-99.96)) < 1e-6
    assert rp["objective"] == pytest.approx(rj["objective"], rel=1e-12)


def test_front_end_errors_match_jax():
    for fn in (j_solve_qp, lambda *a, **k: P.solve_qp(*a, device="cpu", **k)):
        with pytest.raises(ValueError, match="G and h"):
            fn(np.eye(2), np.zeros(2), G=np.eye(2))
        with pytest.raises(ValueError, match="A and b"):
            fn(np.eye(2), np.zeros(2), b=np.zeros(1))
        with pytest.raises(ValueError, match="unbounded"):
            fn(np.diag([1.0, 0.0]), np.array([0.0, 1.0]))
    out = P.solve_qp(np.eye(2), np.zeros(2), lb=np.array([3.0, 0.0]), ub=np.array([2.0, 1.0]),
                     device="cpu")
    assert out["status"] == int(P.Status.INFEASIBLE) and "lb > ub" in out["presolve"]
    with pytest.raises(ValueError, match="qp_via"):
        P.ConeSolver(np.eye(2), device="cpu", qp_via="nope")
