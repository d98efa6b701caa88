"""The port's copies of the host QP modules against pogs_tpu's.

``solver/qp_ipm.py::ipm_solve``, ``solver/qp_polish.py::kkt_residuals``,
``active_set_polish`` and ``row_kinds`` of both packages are the same
numpy code.  On the CVXQP S instances (variants 1 to 3 and the duplicated-
row one), a dense DUAL-style QP and the HS family of
``benchmarks/maros_meszaros.py``, lowered to cone form by its
``to_cone_form``, the outputs agree within 1e-12.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "benchmarks"))

from maros_meszaros import cvxqp_problem, dual_style, problems, to_cone_form  # noqa: E402

from pogs_tpu.types import Cone as JC, ConeConstraint as JCC  # noqa: E402
from pogs_tpu.solver import qp_ipm as j_ipm, qp_polish as j_pol  # noqa: E402

import pogs_tpu_torch as P  # noqa: E402
from pogs_tpu_torch.solver import qp_ipm as p_ipm, qp_polish as p_pol  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-12


def _problems():
    out = {p["name"]: p for p in problems()}
    for variant, optval in ((1, 1.1590718e4), (2, 8.1209405e3), (3, 1.1943432e4)):
        p = cvxqp_problem(variant, 100, optval)
        out[p["name"]] = p
    p = cvxqp_problem(1, 100, 1.1590718e4, name="CVXQP1_S_DEGEN", duplicate_rows=10)
    out[p["name"]] = p
    p = dual_style(n=60)
    out[p["name"]] = p
    return out


PROBLEMS = _problems()


def _cone_form(name):
    Pm, c, A, b, n_eq = to_cone_form(PROBLEMS[name])
    m = A.shape[0]
    j_cones, p_cones = [], []
    if n_eq:
        j_cones.append(JCC(JC.ZERO, range(n_eq)))
        p_cones.append(P.ConeConstraint(P.Cone.ZERO, range(n_eq)))
    if m > n_eq:
        j_cones.append(JCC(JC.NON_NEG, range(n_eq, m)))
        p_cones.append(P.ConeConstraint(P.Cone.NON_NEG, range(n_eq, m)))
    kind = j_pol.row_kinds(m, j_cones)
    np.testing.assert_array_equal(p_pol.row_kinds(m, p_cones), kind)
    return Pm, c, A, b, kind


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_ipm_solve_matches_reference(name):
    Pm, c, A, b, kind = _cone_form(name)
    rj = j_ipm.ipm_solve(Pm, c, A, b, kind, tol=1e-9)
    rp = p_ipm.ipm_solve(Pm, c, A, b, kind, tol=1e-9)
    assert (rj is None) == (rp is None)
    assert rp is not None, name
    assert rp["iters"] == rj["iters"]
    _close(rp["x"], rj["x"])
    _close(rp["lam"], rj["lam"])
    res_j = j_pol.kkt_residuals(Pm, c, A, b, kind, rj["x"], rj["lam"])
    res_p = p_pol.kkt_residuals(Pm, c, A, b, kind, rp["x"], rp["lam"])
    assert res_p.keys() == res_j.keys()
    for key in res_j:
        assert abs(res_p[key] - res_j[key]) <= ATOL
    assert max(res_p.values()) < 1e-8


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_active_set_polish_matches_reference(name):
    """The PDAS polish from a perturbed IPM point (an ADMM-accuracy seed)."""
    Pm, c, A, b, kind = _cone_form(name)
    seed = j_ipm.ipm_solve(Pm, c, A, b, kind, tol=1e-9)
    rng = np.random.default_rng(7)
    x0 = seed["x"] + 1e-5 * rng.standard_normal(seed["x"].shape)
    lam0 = seed["lam"] + 1e-5 * rng.standard_normal(seed["lam"].shape)
    pj = j_pol.active_set_polish(Pm, c, A, b, kind, x0, lam0, 1e-7)
    pp = p_pol.active_set_polish(Pm, c, A, b, kind, x0, lam0, 1e-7)
    assert (pj is None) == (pp is None)
    if pj is not None:
        _close(pp["x"], pj["x"])
        _close(pp["lam"], pj["lam"])
        assert abs(pp["score"] - pj["score"]) <= ATOL
    res_j = j_pol.kkt_residuals(Pm, c, A, b, kind, x0, lam0)
    res_p = p_pol.kkt_residuals(Pm, c, A, b, kind, x0, lam0)
    for key in res_j:
        assert abs(res_p[key] - res_j[key]) <= ATOL


@pytest.mark.parametrize("case", ["bounds", "equalities"])
def test_ipm_on_infeasible_matches_reference(case):
    """An infeasible QP: both copies return the same (None, or a point the
    KKT residuals reject), which leaves the certificate to the HSDE path."""
    if case == "bounds":  # x <= 0 and -x <= -1
        n = 8
        Pm, c = np.eye(n), np.zeros(n)
        A = np.vstack([np.eye(n), -np.eye(n)])
        b = np.concatenate([np.zeros(n), -np.ones(n)])
        kind = np.ones(2 * n, np.int8)
    else:  # x0 = 0 and x0 = 1
        Pm, c = np.eye(2), np.zeros(2)
        A = np.array([[1.0, 0.0], [1.0, 0.0]])
        b = np.array([0.0, 1.0])
        kind = np.zeros(2, np.int8)
    rj = j_ipm.ipm_solve(Pm, c, A, b, kind, tol=1e-9, max_iter=30)
    rp = p_ipm.ipm_solve(Pm, c, A, b, kind, tol=1e-9, max_iter=30)
    assert (rj is None) == (rp is None)
    if rp is not None:
        assert rp["iters"] == rj["iters"]
        _close(rp["x"], rj["x"])
        np.testing.assert_allclose(rp["lam"], rj["lam"], rtol=1e-12)
        res = p_pol.kkt_residuals(Pm, c, A, b, kind, rp["x"], rp["lam"])
        assert max(res.values()) > 1e-6
