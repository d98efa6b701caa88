"""The port's ConicSolver-plugin solve contract without cvxpy, mirroring
tests/test_cvxpy_plugin_contract.py.

``pogs_tpu_torch.api.cvxpy_interface.solve_via_scs_data`` (to which the
plugin method is a one-line delegate) is driven on the CPU
(``device="cpu"`` in the solver options) with SCS-convention data dicts
for every cone mix the plugin advertises (LP, QP-with-P, SOCP, SDP-svec,
EXP, mixed, infeasible, unbounded) and its output is checked against the
SCS 3.x result-dict schema that cvxpy's ``SCS.invert()`` consumes, and
against the problem's own optimum.  Each result is also held to the JAX
package's ``solve_via_scs_data`` on the same data: the same ``status_val``,
and ``pobj`` within 1e-4 relative.

The data dicts mirror what cvxpy's SCS reduction produces: ``dims`` may
be a plain dict (SCS convention) or a ConeDims-like object — both are
exercised.
"""

import numpy as np
import pytest

from tests.conic_fixtures import (
    exp_primal_fixture, lp_fixture, mixed_fixture, qp_fixture, sdp_fixture,
    socp_fixture, socp_ls_fixture,
)

import torch

import pogs_tpu.api.cvxpy_interface as jci
from pogs_tpu_torch.api.cvxpy_interface import _scs_dims_to_dict, solve_via_scs_data

torch.set_num_threads(1)


def _held_to_jax(res, data, solver_opts):
    """The port's result against the JAX package's on the same data."""
    ref = jci.solve_via_scs_data(data, dict(solver_opts))
    assert res["info"]["status_val"] == ref["info"]["status_val"]
    if res["info"]["status_val"] in (1, 2):
        assert res["info"]["pobj"] == pytest.approx(ref["info"]["pobj"], rel=1e-4)
    return res


def _solve_data(data, solver_opts):
    res = solve_via_scs_data(data, {**solver_opts, "device": "cpu"})
    return _held_to_jax(res, data, solver_opts)


def _solve(fx, **opts):
    data = {"c": fx["c"], "A": fx["A"], "b": fx["b"], "dims": fx["dims"]}
    if "P" in fx:
        data["P"] = fx["P"]
    solver_opts = {"abs_tol": 1e-6, "rel_tol": 1e-6, "max_iter": 20000}
    solver_opts.update(opts)
    return _solve_data(data, solver_opts)


def _check_schema(res, m, n):
    assert set(res) == {"x", "y", "s", "info"}
    assert res["x"].shape == (n,)
    assert res["y"].shape == (m,)
    assert res["s"].shape == (m,)
    info = res["info"]
    for key in ("status", "status_val", "iter", "pobj", "dobj",
                "solve_time", "setup_time"):
        assert key in info, f"missing info key {key}"
    assert info["status_val"] in (1, 2, -1, -2, -4)


def test_contract_lp():
    from scipy.optimize import linprog

    fx = lp_fixture()
    res = _solve(fx)
    m, n = fx["A"].shape
    _check_schema(res, m, n)
    assert res["info"]["status_val"] == 1
    c, G, h, A_eq, b_eq = fx["lp_data"]
    ref = linprog(c, A_ub=G, b_ub=h, A_eq=A_eq, b_eq=b_eq,
                  bounds=(None, None), method="highs")
    assert res["info"]["pobj"] == pytest.approx(ref.fun, rel=1e-4, abs=1e-4)
    # slack consistency: s = b - Ax
    assert res["s"] == pytest.approx(
        fx["b"] - fx["A"] @ res["x"], abs=1e-5)


def test_contract_qp_with_P():
    from scipy.optimize import minimize

    fx = qp_fixture()
    res = _solve(fx)
    m, n = fx["A"].shape
    _check_schema(res, m, n)
    assert res["info"]["status_val"] == 1
    P, c = fx["P"], fx["c"]
    ref = minimize(
        lambda x: 0.5 * x @ P @ x + c @ x,
        np.zeros(n) + 1.0 / n,
        jac=lambda x: P @ x + c,
        constraints=[{"type": "eq", "fun": lambda x: x.sum() - 1.0,
                      "jac": lambda x: np.ones(n)}],
        bounds=[(-1.0, 1.0)] * n, method="SLSQP",
        options={"maxiter": 500, "ftol": 1e-12},
    )
    assert res["info"]["pobj"] == pytest.approx(ref.fun, rel=1e-5, abs=1e-5)


def test_contract_socp_closed_form():
    fx = socp_fixture()
    res = _solve(fx)
    m, n = fx["A"].shape
    _check_schema(res, m, n)
    assert res["info"]["status_val"] == 1
    assert res["info"]["pobj"] == pytest.approx(fx["optval"], rel=1e-4)


def test_contract_socp_ls():
    fx = socp_ls_fixture()
    res = _solve(fx)
    assert res["info"]["status_val"] == 1
    assert res["info"]["pobj"] == pytest.approx(fx["optval"],
                                                rel=1e-4, abs=1e-4)


def test_contract_sdp_svec():
    """SDP block in svec convention — assume_svec=True is the plugin's
    contract with cvxpy's SCS reduction."""
    fx = sdp_fixture()
    res = _solve(fx)
    assert res["info"]["status_val"] == 1
    assert res["info"]["pobj"] == pytest.approx(fx["optval"],
                                                rel=1e-3, abs=1e-3)


def test_contract_exp():
    fx = exp_primal_fixture()
    res = _solve(fx)
    assert res["info"]["status_val"] == 1
    assert res["info"]["pobj"] == pytest.approx(fx["optval"],
                                                rel=1e-3, abs=1e-3)


def test_contract_mixed_cones():
    fx = mixed_fixture()
    res = _solve(fx)
    assert res["info"]["status_val"] == 1
    if np.isfinite(fx.get("optval", np.nan)):
        assert res["info"]["pobj"] == pytest.approx(fx["optval"],
                                                    rel=1e-3, abs=1e-3)


def test_contract_infeasible_maps_to_scs_minus_one():
    """x >= 1 and x <= 0 — the plugin must report SCS status_val -1 so
    cvxpy's STATUS_MAP produces INFEASIBLE."""
    n = 4
    A = np.vstack([np.eye(n), -np.eye(n)])
    b = np.concatenate([np.zeros(n), -np.ones(n)])
    data = {"c": np.ones(n), "A": A, "b": b, "dims": {"l": 2 * n}}
    res = _solve_data(data, {"max_iter": 20000})
    assert res["info"]["status_val"] == -1
    assert res["info"]["status"] == "infeasible"


def test_contract_unbounded_maps_to_scs_minus_two():
    """min -x s.t. x >= 0 (free above) — SCS status_val -2 (unbounded)."""
    A = -np.eye(2)
    b = np.zeros(2)
    data = {"c": -np.ones(2), "A": A, "b": b, "dims": {"l": 2}}
    res = _solve_data(data, {"max_iter": 20000})
    assert res["info"]["status_val"] == -2
    assert res["info"]["status"] == "unbounded"


def test_conedims_object_accepted():
    """dims may arrive as a cvxpy ConeDims-like object; the converter
    must translate it (zero/nonneg/soc/psd/exp attributes)."""
    class FakeConeDims:
        zero = 2
        nonneg = 3
        soc = [4]
        psd = []
        exp = 0

    d = _scs_dims_to_dict(FakeConeDims())
    assert d == {"f": 2, "l": 3, "q": [4], "s": [], "ep": 0, "ed": 0}
