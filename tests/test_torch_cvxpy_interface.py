"""CVXPY integration tests of the port (skipped when cvxpy is not
installed), mirroring tests/test_cvxpy_interface.py: graph-form detection
for lasso/ridge, value agreement with the conic path, and the registered
ConicSolver plugin on LP/SOCP/QP/exp, every solve on the CPU
(``device="cpu"``, passed on as a solver option).
"""

import numpy as np
import pytest

cp = pytest.importorskip("cvxpy")

import torch  # noqa: E402

from pogs_tpu_torch.api.cvxpy_interface import (  # noqa: E402
    detect_graph_form, pogs_solve, register_solver,
)

torch.set_num_threads(1)
CPU = {"device": "cpu"}


@pytest.fixture(scope="module", autouse=True)
def _register():
    assert register_solver()


def test_detect_lasso(rng):
    A = rng.normal(size=(30, 10))
    b = rng.normal(size=30)
    x = cp.Variable(10)
    prob = cp.Problem(cp.Minimize(0.5 * cp.sum_squares(A @ x - b)
                                  + 0.3 * cp.norm(x, 1)))
    det = detect_graph_form(prob)
    assert det is not None and det["type"] == "lasso"
    np.testing.assert_allclose(det["params"]["lambd"], 0.3)


def test_detect_ridge(rng):
    A = rng.normal(size=(30, 10))
    b = rng.normal(size=30)
    x = cp.Variable(10)
    prob = cp.Problem(cp.Minimize(0.5 * cp.sum_squares(A @ x - b)
                                  + 0.2 * cp.sum_squares(x)))
    det = detect_graph_form(prob)
    assert det is not None and det["type"] == "ridge"


def test_detect_nonneg_ls(rng):
    A = rng.normal(size=(30, 10))
    b = rng.normal(size=30)
    x = cp.Variable(10)
    prob = cp.Problem(cp.Minimize(0.5 * cp.sum_squares(A @ x - b)), [x >= 0])
    det = detect_graph_form(prob)
    assert det is not None and det["type"] == "nonneg_ls"


def test_pogs_solve_lasso_matches_cvxpy(rng):
    A = rng.normal(size=(40, 15))
    b = rng.normal(size=40)
    lam = 0.2 * np.max(np.abs(A.T @ b))
    x = cp.Variable(15)
    prob = cp.Problem(cp.Minimize(0.5 * cp.sum_squares(A @ x - b)
                                  + lam * cp.norm(x, 1)))
    val = pogs_solve(prob, abs_tol=1e-7, rel_tol=1e-7, **CPU)
    ref = cp.Problem(cp.Minimize(0.5 * cp.sum_squares(A @ x - b)
                                 + lam * cp.norm(x, 1))).solve()
    np.testing.assert_allclose(val, ref, rtol=1e-3)


def test_plugin_lp(rng):
    n = 8
    x = cp.Variable(n)
    c = rng.normal(size=n)
    prob = cp.Problem(cp.Minimize(c @ x), [x >= -1, x <= 1])
    val = prob.solve(solver="POGS_TPU", abs_tol=1e-6, rel_tol=1e-6,
                     max_iter=20000, **CPU)
    np.testing.assert_allclose(val, -np.sum(np.abs(c)), atol=1e-3)
    np.testing.assert_allclose(np.asarray(x.value), -np.sign(c), atol=1e-3)


def test_plugin_socp(rng):
    n = 6
    x = cp.Variable(n)
    c = rng.normal(size=n)
    prob = cp.Problem(cp.Minimize(c @ x), [cp.norm(x, 2) <= 1])
    val = prob.solve(solver="POGS_TPU", abs_tol=1e-6, rel_tol=1e-6,
                     max_iter=20000, **CPU)
    np.testing.assert_allclose(val, -np.linalg.norm(c), atol=1e-3)


def test_detect_elastic_net_logistic_huber_svm(rng):
    """The remaining graph-form patterns (pogs_cvxpy.py:650-1186)."""
    m, n = 30, 12
    A = rng.normal(size=(m, n))
    b = rng.normal(size=m)
    y = np.sign(rng.normal(size=m))
    x = cp.Variable(n)

    probs = {
        "elastic_net": cp.Problem(cp.Minimize(
            0.5 * cp.sum_squares(A @ x - b) + 0.3 * cp.norm1(x)
            + 0.2 * cp.sum_squares(x))),
        "huber": cp.Problem(cp.Minimize(cp.sum(cp.huber(A @ x - b)))),
        "logistic": cp.Problem(cp.Minimize(
            cp.sum(cp.logistic(cp.multiply(-y, A @ x))))),
    }
    for name, prob in probs.items():
        det = detect_graph_form(prob)
        assert det is not None, f"{name} not detected"


def test_plugin_qp(rng):
    n = 6
    P = rng.normal(size=(n, n))
    P = P.T @ P + np.eye(n)
    q = rng.normal(size=n)
    x = cp.Variable(n)
    prob = cp.Problem(cp.Minimize(0.5 * cp.quad_form(x, cp.psd_wrap(P)) + q @ x),
                      [x >= -2, x <= 2])
    prob.solve(solver="POGS_TPU", **CPU)
    assert prob.status == "optimal"
    ref = cp.Problem(cp.Minimize(0.5 * cp.quad_form(x, cp.psd_wrap(P)) + q @ x),
                     [x >= -2, x <= 2])
    ref.solve(solver="SCS")
    assert prob.value == pytest.approx(ref.value, rel=1e-2, abs=1e-3)


def test_plugin_exp_cone(rng):
    # min sum(exp(x)) s.t. sum(x) = 3  →  x_i = 1 each (n=3).
    x = cp.Variable(3)
    prob = cp.Problem(cp.Minimize(cp.sum(cp.exp(x))), [cp.sum(x) == 3])
    prob.solve(solver="POGS_TPU", **CPU)
    assert prob.status == "optimal"
    np.testing.assert_allclose(np.asarray(x.value), 1.0, atol=1e-2)


def test_plugin_infeasible(rng):
    x = cp.Variable(2)
    prob = cp.Problem(cp.Minimize(cp.sum(x)), [x >= 1, x <= 0])
    prob.solve(solver="POGS_TPU", **CPU)
    assert prob.status in ("infeasible", "infeasible_inaccurate")
