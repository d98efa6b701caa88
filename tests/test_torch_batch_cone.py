"""The port's batched cone and QP solves against pogs_tpu's, on the CPU.

``batched_cone_solve``, ``warm_path_cone_solve`` and ``batched_qp_solve``
of both packages on the same seeded float64 inputs, K = 4 lanes: a small
SOCP (socp_ball 63×20), a small LP (lp_ineq 64×12) and a small QP (CVXQP1
n = 20 lowered to cone form).  The port runs the eager HSDE loop lane
after lane from one init (the cone kernel's plain version), the JAX
package a vmapped loop.  Pass: the same statuses and iterations, x within
1e-8.  A lane does not depend on K: lane k alone gives the same result.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "benchmarks"))

import problems as bench  # noqa: E402
from maros_meszaros import cvxqp_problem, to_cone_form  # noqa: E402

from pogs_tpu.types import Cone as JC, ConeConstraint as JCC, SolverSettings as JSettings  # noqa: E402,E501
from pogs_tpu.api.cone import dims_to_cones as j_dims  # noqa: E402
from pogs_tpu.parallel.batch import (  # noqa: E402
    batched_cone_solve as j_batched, batched_qp_solve as j_batched_qp,
    warm_path_cone_solve as j_warm,
)

import pogs_tpu_torch as P  # noqa: E402

torch.set_num_threads(1)

K = 4
ATOL = 1e-8
KW = {"socp": dict(abs_tol=1e-6, rel_tol=1e-6, max_iter=3000),
      "lp": dict(abs_tol=1e-4, rel_tol=1e-4, max_iter=3000)}


def _problem(name):
    """(A, b_batch (K, m), c, dims) with b perturbed per lane."""
    if name == "socp":
        p = bench.socp_ball(n=20, n_balls=3, seed=4)
    else:
        p = bench.lp_ineq(m=40, n=12, seed=4)
    rng = np.random.default_rng(8)
    b = p["b"][None, :] * (1.0 + 0.02 * rng.standard_normal((K, 1)))
    return p["A"], b, p["c"], p["dims"]


def _settings(name):
    return JSettings(**KW[name]), P.SolverSettings(**KW[name])


def _assert_lanes(oj, op, keys=("x",)):
    np.testing.assert_array_equal(op["status"].numpy(), np.asarray(oj["status"]))
    np.testing.assert_array_equal(op["iterations"].numpy(), np.asarray(oj["iterations"]))
    for key in keys:
        np.testing.assert_allclose(op[key].numpy(), np.asarray(oj[key]), atol=ATOL)
    np.testing.assert_allclose(op["optval"].numpy(), np.asarray(oj["optval"]),
                               atol=ATOL * max(1.0, float(np.abs(oj["optval"]).max())))


@pytest.mark.parametrize("c_kind", ["shared", "per_lane"])
@pytest.mark.parametrize("name", ["socp", "lp"])
def test_batched_cone_solve_matches_jax(name, c_kind):
    A, b, c, dims = _problem(name)
    if c_kind == "per_lane":
        c = c[None, :] + 0.1 * np.random.default_rng(2).standard_normal((K, c.shape[0]))
    js, ps = _settings(name)
    oj = j_batched(A, b, c, j_dims(dims), settings=js)
    op = P.batched_cone_solve(A, b, c, P.dims_to_cones(dims), settings=ps, device="cpu")
    _assert_lanes(oj, op, keys=("x", "y", "nu"))
    assert (op["status"] == 0).all()
    assert op["x"].dtype == torch.float64 and op["x"].shape == (K, A.shape[1])


def test_batched_cone_lane_does_not_depend_on_K():
    A, b, c, dims = _problem("socp")
    _, ps = _settings("socp")
    cones = P.dims_to_cones(dims)
    full = P.batched_cone_solve(A, b, c, cones, settings=ps, device="cpu")
    one = P.batched_cone_solve(A, b[2:3], c, cones, settings=ps, device="cpu")
    assert int(one["iterations"][0]) == int(full["iterations"][2])
    assert torch.equal(one["x"][0], full["x"][2])


@pytest.mark.parametrize("name", ["socp", "lp"])
def test_warm_path_cone_solve_matches_jax(name):
    A, b, c, dims = _problem(name)
    b = np.sort(b, axis=0) if name == "lp" else b  # a drifting sequence
    js, ps = _settings(name)
    oj = j_warm(A, b, c, j_dims(dims), settings=js)
    op = P.warm_path_cone_solve(A, b, c, P.dims_to_cones(dims), settings=ps, device="cpu")
    _assert_lanes(oj, op)
    # Later steps start on the previous ray: fewer iterations than cold.
    cold = P.batched_cone_solve(A, b, c, P.dims_to_cones(dims), settings=ps, device="cpu")
    assert int(op["iterations"][1:].sum()) < int(cold["iterations"][1:].sum())


def _qp_batch():
    p = cvxqp_problem(1, 20, float("nan"))
    Pm, c, A, b, n_eq = to_cone_form(p)
    m = A.shape[0]
    rng = np.random.default_rng(6)
    cs = c[None, :] + rng.standard_normal((K, c.shape[0]))
    bs = np.broadcast_to(b, (K, m)).copy()
    return Pm, A, bs, cs, n_eq, m


@pytest.mark.parametrize("polish", [True, False], ids=["polish", "no_polish"])
def test_batched_qp_solve_matches_jax(polish):
    Pm, A, bs, cs, n_eq, m = _qp_batch()
    j_ky = [JCC(JC.ZERO, range(n_eq)), JCC(JC.NON_NEG, range(n_eq, m))]
    p_ky = [P.ConeConstraint(P.Cone.ZERO, range(n_eq)),
            P.ConeConstraint(P.Cone.NON_NEG, range(n_eq, m))]
    kw = dict(abs_tol=1e-5, rel_tol=1e-5, max_iter=600)
    oj = j_batched_qp(A, Pm, bs, cs, j_ky, settings=JSettings(**kw), polish=polish)
    op = P.batched_qp_solve(A, Pm, bs, cs, p_ky, settings=P.SolverSettings(**kw),
                            polish=polish, device="cpu")
    np.testing.assert_array_equal(op["status"], np.asarray(oj["status"]))
    np.testing.assert_array_equal(op["iterations"], np.asarray(oj["iterations"]))
    np.testing.assert_array_equal(op["polished"], np.asarray(oj["polished"]))
    np.testing.assert_allclose(op["x"], np.asarray(oj["x"]), atol=ATOL)
    np.testing.assert_allclose(op["optval"], np.asarray(oj["optval"]),
                               rtol=1e-10, atol=ATOL)
    if polish:
        assert op["polished"].all() and (op["status"] == 0).all()


@pytest.mark.parametrize("form", ["dense", "diag", "sparse"])
def test_epigraph_extension_is_the_single_routes(form):
    """The epigraph extension batched_qp_solve and ConeSolver's QP route
    share: A's rows with a zero t column, the two t-rows, then −√2·Lt with
    LtᵀLt = P (P dense or diagonal; a sparse A gives the same matrix in
    CSR), and it is the QP sub-solver's own matrix."""
    import scipy.sparse as sp
    from pogs_tpu_torch.solver.cone import epigraph_extension, epigraph_factor

    p = cvxqp_problem(1, 20, float("nan"))
    A = p["A"]
    m, n = A.shape
    Pm = np.abs(np.diag(p["Q"])) if form == "diag" else p["Q"]
    A_in = sp.csr_matrix(A) if form == "sparse" else A
    A_ext, r = epigraph_extension(A_in, epigraph_factor(Pm)[0], sparse=form == "sparse")
    assert sp.issparse(A_ext) == (form == "sparse")
    D = A_ext.toarray() if form == "sparse" else A_ext
    assert D.shape == (m + r + 2, n + 1)
    np.testing.assert_array_equal(D[:m, :n], A)
    np.testing.assert_array_equal(D[:m, n], 0.0)
    t_rows = np.zeros((2, n + 1))
    t_rows[:, n] = -1.0
    np.testing.assert_array_equal(D[m:m + 2], t_rows)
    np.testing.assert_array_equal(D[m + 2:, n], 0.0)
    L = D[m + 2:, :n]
    P_full = np.diag(Pm) if form == "diag" else Pm
    np.testing.assert_allclose(L.T @ L / 2, P_full, rtol=0, atol=1e-12 * np.abs(P_full).max())
    solver = P.ConeSolver(A_in, Ky=[P.ConeConstraint(P.Cone.ZERO, range(m))],
                          dtype=torch.float64, device="cpu")
    solver.solve(p["rhs"], p["c"], P=Pm, settings=P.SolverSettings(polish=False, max_iter=1))
    sub_A = solver._qp_sub._A_raw
    np.testing.assert_array_equal(sub_A.toarray() if sp.issparse(sub_A) else sub_A, D)


def test_batched_cone_refuses_a_mesh():
    """A mesh without the batch axis is refused: the cone batches split
    their lanes over ``batch_axis`` (tests/test_torch_sharding.py runs them
    over a mesh of gloo ranks)."""
    from pogs_tpu_torch.parallel.mesh import Mesh

    rows_only = Mesh.__new__(Mesh)
    rows_only.shape, rows_only.axis_names = {"rows": 2}, ("rows",)
    rows_only.device = torch.device("cpu")
    A, b, c, dims = _problem("lp")
    with pytest.raises(ValueError, match="'batch'"):
        P.batched_cone_solve(A, b, c, P.dims_to_cones(dims), mesh=rows_only, device="cpu")
    with pytest.raises(ValueError, match="'batch'"):
        P.batched_qp_solve(np.eye(2), np.eye(2), np.ones((1, 2)), np.zeros(2),
                           [P.ConeConstraint(P.Cone.NON_NEG, range(2))], mesh=rows_only,
                           device="cpu")
