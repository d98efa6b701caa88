"""Slice 3, sparse and indirect: the port against pogs_tpu on the CPU.

The sparse operator, sparse equilibration, CGLS, the CGLS projector, the
sparse graph-form solve (from the JAX package's init state carried across),
the builders with a sparse A, the cone solver's matrix-free ``cg`` strategy,
the sparse-LP tail polish and the matrix-free polish.  Both packages run on
the same numpy-seeded inputs in float64 unless a test says otherwise.

Tolerances: the operator contract atol 1e-12; equilibration rtol 1e-10
(the same products summed in another order); CGLS the same iteration count
and x within 1e-10; a solve from the carried init state the same status and
iterations, optval within 1e-4 relative, x and z within 2e-5; the cone
``cg`` strategy the same status and iterations as the JAX package's, optval
within 1e-4 relative and x within 2e-5·max(1, ‖x‖∞); the f32 noise floor
and the polish against the port's own dense solve as the JAX package's
tests/test_sparse.py holds them.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import pogs_tpu.api.graph as Japi
import pogs_tpu.solver.hsde as j_hsde
from pogs_tpu.linalg.cgls import cgls_solve as j_cgls_solve
from pogs_tpu.linalg.equil import equilibrate as j_equilibrate
from pogs_tpu.linalg.matrix import as_matrix_op as j_as_matrix_op
from pogs_tpu.projector.indirect import CglsProjector as JCgls
from pogs_tpu.solver.cone import ConeSolver as JConeSolver
from pogs_tpu.solver.graph import GraphFormSolver as JSolver
from pogs_tpu.types import (Cone as JC, ConeConstraint as JCC, Function as JF,
                            FunctionVector as JFV, SolverSettings as JSet)

import pogs_tpu_torch as P
import pogs_tpu_torch.api.graph as Papi
import pogs_tpu_torch.solver.hsde as p_hsde
from pogs_tpu_torch.linalg.cgls import cgls_solve
from pogs_tpu_torch.linalg.equil import equilibrate
from pogs_tpu_torch.linalg.matrix import SparseMatrix, as_matrix_op
from pogs_tpu_torch.projector.indirect import CglsProjector
from pogs_tpu_torch.solver.graph import DENSIFY_BYTES, densify_sparse

torch.set_num_threads(1)


def _sparse(m, n, density, seed, zero_row=None, zero_col=None):
    rng = np.random.default_rng(seed)
    S = sp.random(m, n, density=density, random_state=seed, format="csr")
    S.data[:] = rng.standard_normal(S.nnz)
    if zero_row is not None or zero_col is not None:
        S = S.tolil()
        if zero_row is not None:
            S[zero_row, :] = 0.0
        if zero_col is not None:
            S[:, zero_col] = 0.0
        S = S.tocsr()
        S.eliminate_zeros()
    return S


def _t(v):
    return torch.as_tensor(np.asarray(v, np.float64))


# -- the operator -------------------------------------------------------------

def _inputs(S):
    coo = S.tocoo()
    dup = sp.coo_matrix((np.concatenate([coo.data / 2, coo.data / 2]),
                         (np.concatenate([coo.row, coo.row]), np.concatenate([coo.col, coo.col]))),
                        shape=S.shape)
    dense = torch.tensor(S.toarray())
    with warnings.catch_warnings():  # torch's notice that sparse CSR is in beta
        warnings.simplefilter("ignore", UserWarning)
        csr = dense.to_sparse_csr()
    return {"scipy_csr": S, "scipy_coo_duplicates": dup,
            "torch_coo": dense.to_sparse(), "torch_csr": csr}


@pytest.mark.parametrize("kind", ["scipy_csr", "scipy_coo_duplicates", "torch_coo", "torch_csr"])
def test_operator_contract_matches_jax(kind):
    S = _sparse(30, 20, 0.3, 1)
    op = as_matrix_op(_inputs(S)[kind], torch.float64)
    J = j_as_matrix_op(S, jnp.float64)
    assert isinstance(op, SparseMatrix) and op.is_sparse and op.shape == (30, 20)
    assert op.dtype == torch.float64 and op.M.crow_indices().dtype == torch.int32
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal(20), rng.standard_normal(30)
    d, e = rng.random(30) + 0.5, rng.random(20) + 0.5
    pairs = [(op.mv(_t(x)), J.mv(jnp.asarray(x))), (op.rmv(_t(y)), J.rmv(jnp.asarray(y))),
             (op.sq_mv(_t(x)), J.sq_mv(jnp.asarray(x))),
             (op.sq_rmv(_t(y)), J.sq_rmv(jnp.asarray(y)))]
    ps, js = op.scale(_t(d), _t(e)).scalar_mul(3.0), J.scale(jnp.asarray(d), jnp.asarray(e)).scalar_mul(3.0)
    pairs += [(ps.mv(_t(x)), js.mv(jnp.asarray(x))), (ps.rmv(_t(y)), js.rmv(jnp.asarray(y))),
              (ps.sq_rmv(_t(y)), js.sq_rmv(jnp.asarray(y)))]
    for pv, jv in pairs:
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-12)
    assert float(op.frob2()) == pytest.approx(float(J.frob2()), abs=1e-12)
    np.testing.assert_allclose(op.to_dense().numpy(), S.toarray(), atol=0)
    assert op.to(dtype=torch.float32).mv(_t(x).float()).dtype == torch.float32
    with pytest.raises(TypeError):
        op.dense()


def test_wide_and_empty_operator():
    for S in (_sparse(8, 30, 0.2, 2, zero_row=3, zero_col=29),
              sp.csr_matrix((5, 4))):
        op = as_matrix_op(S, torch.float64)
        x, y = np.arange(S.shape[1], dtype=float), np.arange(S.shape[0], dtype=float)
        np.testing.assert_allclose(op.mv(_t(x)).numpy(), S @ x, atol=1e-12)
        np.testing.assert_allclose(op.rmv(_t(y)).numpy(), S.T @ y, atol=1e-12)


# -- equilibration, norm estimate ---------------------------------------------

@pytest.mark.parametrize("shape,zero_row,zero_col", [
    ((25, 15), None, None),
    ((40, 25), 3, 7),      # empty rows and columns: the effective-count rule
    ((20, 45), 0, 44),
])
def test_sparse_equilibration_matches(shape, zero_row, zero_col):
    S = _sparse(*shape, 0.3, 5, zero_row, zero_col)
    ep = equilibrate(as_matrix_op(S, torch.float64))
    ej = j_equilibrate(j_as_matrix_op(S, jnp.float64))
    ed = j_equilibrate(jnp.asarray(S.toarray()))
    for ref in (ej, ed):
        np.testing.assert_allclose(ep.d.numpy(), np.asarray(ref.d), rtol=1e-10)
        np.testing.assert_allclose(ep.e.numpy(), np.asarray(ref.e), rtol=1e-10)
    assert isinstance(ep.A, SparseMatrix)
    x = np.linspace(-1, 1, shape[1])
    np.testing.assert_allclose(ep.A.mv(_t(x)).numpy(), np.asarray(ed.A) @ x, atol=1e-12)
    # The norm estimate through the operator's products equals the dense one.
    x0 = torch.rand(shape[1], generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    assert float(P.linalg.norm2_est(ep.A, x0=x0)) == pytest.approx(
        float(P.linalg.norm2_est(torch.tensor(np.asarray(ed.A)), x0=x0)), rel=1e-12)


# -- CGLS and the projector ---------------------------------------------------

@pytest.mark.parametrize("shape,shift,tol,warm", [
    ((60, 30), 1.0, 1e-10, False),
    ((30, 60), 1.0, 1e-8, True),
    ((60, 30), 0.0, 1e-12, False),   # shift 0: plain least squares
    ((60, 30), 1.0, 1e-30, False),   # unreachable tol: the stall / divergence exits
])
def test_cgls_matches_jax(shape, shift, tol, warm):
    """The same iterations and x; at an unreachable tolerance both exit on
    a guard, at an iteration the roundoff at the noise floor picks, well
    before the budget and with the same best iterate."""
    S = _sparse(*shape, 0.3, 7)
    rng = np.random.default_rng(1)
    b = rng.standard_normal(shape[0])
    x0 = rng.standard_normal(shape[1]) if warm else np.zeros(shape[1])
    op, J = as_matrix_op(S, torch.float64), j_as_matrix_op(S, jnp.float64)
    xp, kp = cgls_solve(op.mv, op.rmv, _t(b), _t(x0), shift, tol, 200)
    xj, kj = j_cgls_solve(J.mv, J.rmv, jnp.asarray(b), jnp.asarray(x0), shift, tol, 200)
    if tol > 1e-20:
        assert int(kp) == int(kj)
    else:
        assert int(kp) < 200 and int(kj) < 200
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-10)


def test_cgls_counts_frozen_steps():
    S = _sparse(60, 30, 0.3, 7)
    op = as_matrix_op(S, torch.float64)
    b = _t(np.ones(60))
    it0, st0 = cgls_solve.iterations, cgls_solve.steps
    _, k = cgls_solve(op.mv, op.rmv, b, torch.zeros(30, dtype=torch.float64), 1.0, 1e-10, 500)
    assert cgls_solve.iterations - it0 == int(k)
    steps = cgls_solve.steps - st0
    assert int(k) <= steps < int(k) + P.linalg.cgls.CHECK_EVERY


def _exit_case(case):
    """(matvec, rmatvec, b, shift, tol, max_iter) ending on one guard: a real
    solve that converges or runs out of steps; a zero operator whose gradient
    never shrinks (a stall); an Aᵀ that grows 5x per call (a divergence)."""
    if case in ("converged", "max_iter"):
        op = as_matrix_op(_sparse(60, 30, 0.3, 7), torch.float64)
        return op.mv, op.rmv, _t(np.ones(60)), 1.0, 1e-10, 500 if case == "converged" else 3
    if case == "stalled":
        return lambda p: torch.zeros(60, dtype=p.dtype), lambda r: r[:30], _t(np.ones(60)), \
            0.0, 0.0, 500
    calls = []

    def growing(r):
        calls.append(None)
        return r[:30] * 5.0 ** len(calls)
    return lambda p: torch.zeros(60, dtype=p.dtype), growing, _t(np.ones(60)), 0.0, 0.0, 500


@pytest.mark.parametrize("case", ["converged", "max_iter", "stalled", "diverged"])
def test_cgls_counts_exits(case):
    mv, rmv, b, shift, tol, max_iter = _exit_case(case)
    before = dict(cgls_solve.exits)
    _, k = cgls_solve(mv, rmv, b, torch.zeros(30, dtype=torch.float64), shift, tol, max_iter)
    delta = {key: cgls_solve.exits[key] - before[key] for key in before}
    assert delta == {key: int(key == case) for key in before}
    want = {"max_iter": 3, "stalled": P.linalg.cgls.STALL_WINDOW + 1, "diverged": 1}
    if case in want:
        assert int(k) == want[case]


@pytest.mark.parametrize("shape", [(50, 30), (30, 50)], ids=["tall", "wide"])
def test_cgls_projector_matches_jax(shape):
    S = _sparse(*shape, 0.3, 9)
    rng = np.random.default_rng(2)
    x0, y0, xw = rng.standard_normal(shape[1]), rng.standard_normal(shape[0]), \
        rng.standard_normal(shape[1])
    op, J = as_matrix_op(S, torch.float64), j_as_matrix_op(S, jnp.float64)
    fp, fj = CglsProjector().init(op, s=1.0), JCgls().init(J, s=1.0)
    xp, yp = CglsProjector().project(op, fp, _t(x0), _t(y0), 1e-10, _t(xw))
    xj, yj = JCgls().project(J, fj, jnp.asarray(x0), jnp.asarray(y0), 1e-10, jnp.asarray(xw))
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-10)
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), atol=1e-10)
    np.testing.assert_allclose(yp.numpy(), S @ xp.numpy(), atol=1e-12)


# -- the graph-form solve -----------------------------------------------------

_RNG = np.random.default_rng(3)
S0 = _sparse(80, 40, 0.3, 11)
B0 = _RNG.standard_normal(80)
LAB = np.sign(_RNG.standard_normal(80))
LAM = 0.2 * float(np.max(np.abs(S0.T @ B0)))


def _export_sparse(js):
    init = js._init_state
    M = init["A"].M
    return P.init_state_from_numpy({
        "A": {"data": np.asarray(M.data), "indices": np.asarray(M.indices), "shape": M.shape},
        "d": np.asarray(init["d"]), "e": np.asarray(init["e"]),
        "norm_A": np.asarray(init["norm_A"]),
        "factor": {"s": np.asarray(init["factor"]["s"])},
    }, device="cpu")


@pytest.mark.parametrize("wide", [False, True], ids=["tall", "wide"])
def test_sparse_lasso_from_the_jax_init_state(wide):
    st = dict(abs_tol=1e-7, rel_tol=1e-7)
    S = S0[:30] if wide else S0
    m, n = S.shape
    b = B0[:m]
    lam = 0.2 * float(np.max(np.abs(S.T @ b)))
    js = JSolver(S, dtype=jnp.float64, sparse_policy="keep").init()
    ps = P.GraphFormSolver(S, device="cpu", sparse_policy="keep")
    assert js.projector == ps.projector == "cgls" and ps.A.is_sparse
    ps.load_init_state(_export_sparse(js))
    f_j, g_j = JFV(JF.SQUARE, m, b=b), JFV(JF.ABS, n, c=lam)
    f_p = P.FunctionVector(P.Function.SQUARE, m, b=b)
    g_p = P.FunctionVector(P.Function.ABS, n, c=lam)
    for kw in ({}, {"rho": 2.0}):  # cold, then warm from the first solve
        rj = js.solve(f_j, g_j, settings=JSet(**st), **kw)
        rp = ps.solve(f_p, g_p, settings=P.SolverSettings(**st), **kw)
        assert rp.status == P.Status(int(rj.status)) == P.Status.SUCCESS
        assert int(rp.final_iter) == int(rj.final_iter)
        assert float(rp.optval) == pytest.approx(float(rj.optval), rel=1e-4)
        np.testing.assert_allclose(rp.x.numpy(), np.asarray(rj.x), atol=2e-5)
        np.testing.assert_allclose(ps._z.numpy(), np.asarray(js._z), atol=2e-5)


def test_dense_cgls_projector_matches_jax():
    A = S0.toarray()
    js = JSolver(A, dtype=jnp.float64, projector="cgls")
    ps = P.GraphFormSolver(A, device="cpu", projector="cgls")
    rj = js.solve(JFV(JF.SQUARE, 80, b=B0), JFV(JF.ABS, 40, c=LAM))
    rp = ps.solve(P.FunctionVector(P.Function.SQUARE, 80, b=B0),
                  P.FunctionVector(P.Function.ABS, 40, c=LAM))
    assert rp.status == P.Status(int(rj.status)) == P.Status.SUCCESS
    assert abs(int(rp.final_iter) - int(rj.final_iter)) <= 2
    np.testing.assert_allclose(rp.x.numpy(), np.asarray(rj.x), atol=2e-5)


BUILDERS = {
    "lasso": lambda api, A, **k: api.solve_lasso(A, B0, LAM, **k),
    "ridge": lambda api, A, **k: api.solve_ridge(A, B0, 1.0, **k),
    "logistic": lambda api, A, **k: api.solve_logistic(A, LAB, 0.3, **k),
    "svm": lambda api, A, **k: api.solve_svm(A, LAB, 1.0, **k),
}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builders_take_sparse_input(name):
    """A sparse A reaches the solver through every builder and stays sparse
    on the CPU (sparse_policy="auto"); the result is the JAX package's."""
    rj = BUILDERS[name](Japi, S0, dtype=np.float64)
    rp = BUILDERS[name](Papi, S0, dtype=np.float64, device="cpu")
    assert rp["status"] == rj["status"] == int(P.Status.SUCCESS)
    assert abs(rp["iterations"] - rj["iterations"]) <= 2
    assert rp["optval"] == pytest.approx(rj["optval"], rel=1e-4)
    np.testing.assert_allclose(rp["x"], np.asarray(rj["x"]), atol=2e-5)


def test_torch_sparse_input_and_densify_policy():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.tensor(S0.toarray()).to_sparse_csr()
    kept = Papi.solve_lasso(csr, B0, LAM)
    dense = Papi.solve_lasso(S0, B0, LAM, device="cpu", sparse_policy="densify")
    assert kept["status"] == dense["status"] == 0
    assert kept["optval"] == pytest.approx(dense["optval"], rel=1e-4)
    s = P.GraphFormSolver(S0, device="cpu", sparse_policy="densify")
    assert not s.A.is_sparse and s.projector == "direct"


def test_sparse_policy_and_the_auto_rule():
    for cls in (P.GraphFormSolver, lambda A, **k: P.ConeSolver(A, **k)):
        with pytest.raises(ValueError, match="sparse_policy"):
            cls(S0, device="cpu", sparse_policy="bogus")
        assert cls(S0, device="cpu").A.is_sparse                       # auto on the CPU
        assert cls(S0, device="cpu", sparse_policy="keep").A.is_sparse
        assert not cls(S0, device="cpu", sparse_policy="densify").A.is_sparse
    # The rule itself, for a CUDA device (nothing launched): dense within the
    # 1 GiB budget, kept beyond it; never dense on the CPU under "auto".
    assert densify_sparse("auto", (10000, 5000), 4, "cuda")
    assert not densify_sparse("auto", (20242, 47236), 4, "cuda")      # 3.8 GB dense
    assert densify_sparse("auto", (1 << 15, 1 << 13), 4, "cuda")       # exactly 1 GiB
    assert not densify_sparse("auto", (1 << 15, 1 << 13), 8, "cuda")
    assert not densify_sparse("auto", (100, 50), 4, "cpu")
    assert densify_sparse("densify", (20242, 47236), 4, "cpu")
    assert not densify_sparse("keep", (100, 50), 4, "cuda")
    assert DENSIFY_BYTES == 1 << 30
    with pytest.raises(ValueError):
        densify_sparse("sometimes", (1, 1), 4, "cpu")
    # A sparse A never reaches the kernel, and forcing it raises.
    with pytest.raises(ValueError, match="dense A"):
        P.GraphFormSolver(S0, device="cpu").solve(
            P.FunctionVector(P.Function.SQUARE, 80, b=B0),
            P.FunctionVector(P.Function.ABS, 40, c=LAM),
            settings=P.SolverSettings(use_fused=True))


def test_f32_cgls_noise_floor_regression():
    """The JAX package's round-4 regression: a warm-started f32 CGLS
    projection at the f32 noise floor must not random-walk the outer solve
    away (the best-iterate and divergence / stall guards).  The kept sparse
    solve converges and matches the port's dense solve (rel 1e-2)."""
    rng = np.random.default_rng(42)
    m, n = 2000, 1000
    A = sp.random(m, n, density=0.01, random_state=3, format="csr")
    A.data[:] = rng.normal(size=A.nnz)
    x_true = np.zeros(n)
    idx = rng.choice(n, n // 20, replace=False)
    x_true[idx] = rng.normal(size=idx.size)
    b = A @ x_true + 0.1 * rng.normal(size=m)
    lam = 0.1 * float(np.max(np.abs(A.T @ b)))
    st = P.SolverSettings(abs_tol=1e-4, rel_tol=1e-4, max_iter=2500)
    f = P.FunctionVector(P.Function.SQUARE, m, b=b.astype(np.float32), dtype=np.float32)
    g = P.FunctionVector(P.Function.ABS, n, c=lam, dtype=np.float32)
    out = P.GraphFormSolver(A, dtype=torch.float32, device="cpu",
                            sparse_policy="keep").solve(f, g, settings=st)
    assert out.status == P.Status.SUCCESS
    assert int(out.final_iter) < 1000

    def canon_obj(x):
        x = x.numpy().astype(np.float64)
        r = A @ x - b
        return float(0.5 * r @ r + lam * np.abs(x).sum())

    dense = P.GraphFormSolver(A.toarray().astype(np.float32), device="cpu").solve(
        f, g, settings=st)
    assert canon_obj(out.x) == pytest.approx(canon_obj(dense.x), rel=1e-2)


# -- the cone form --------------------------------------------------------------

def _box_lp(seed=42, m=10, n=5):
    """The LP of the JAX package's tests/test_cone_solver.py strategy test
    (there 20×10): random rows plus a box |x| ≤ 3, all NonNeg."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    b = A @ rng.random(n) + rng.random(m)
    c = rng.normal(size=n)
    A_full = np.vstack([A, np.eye(n), -np.eye(n)])
    b_full = np.concatenate([b, 3 * np.ones(n), 3 * np.ones(n)])
    return A_full, b_full, c, [(JC.NON_NEG, range(A_full.shape[0]))]


def _socp():
    """min cᵀx s.t. ‖x‖ ≤ 1 and x ≤ 0.9 (an SOC block, then NonNeg rows)."""
    c = np.array([3.0, -4.0, 12.0])
    A = np.vstack([np.zeros((1, 3)), -np.eye(3), np.eye(3)])
    b = np.concatenate([[1.0], np.zeros(3), 0.9 * np.ones(3)])
    return A, b, c, [(JC.SOC, range(4)), (JC.NON_NEG, range(4, 7))]


def _cones(pairs, pkg):
    if pkg == "jax":
        return [JCC(k, idx) for k, idx in pairs]
    return [P.ConeConstraint(P.Cone(int(k)), idx) for k, idx in pairs]


@pytest.mark.parametrize("case,sparse", [("box_lp", True), ("box_lp", False),
                                          ("socp", True)])
def test_cone_cg_strategy_matches_jax(case, sparse):
    A, b, c, pairs = _box_lp() if case == "box_lp" else _socp()
    A_in = sp.csr_matrix(A) if sparse else A
    st = dict(abs_tol=1e-4, rel_tol=1e-4, max_iter=5000, polish=False)
    js = JConeSolver(A_in, Ky=_cones(pairs, "jax"), strategy="cg", dtype=jnp.float64)
    ps = P.ConeSolver(A_in, Ky=_cones(pairs, "torch"), strategy="cg", dtype=torch.float64,
                      device="cpu")
    assert ps.strategy == "cg" and ps.A.is_sparse == sparse
    rj = js.solve(b, c, settings=JSet(**st))
    rp = ps.solve(b, c, settings=P.SolverSettings(**st))
    assert rp.status == P.Status(int(rj.status)) == P.Status.SUCCESS
    assert int(rp.final_iter) == int(rj.final_iter)
    assert float(rp.optval) == pytest.approx(float(rj.optval), rel=1e-4)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rp.x.numpy(), xj, atol=2e-5 * max(1.0, np.abs(xj).max()))
    # The port's own SMW solve of the dense problem reaches the same optimum.
    smw = P.ConeSolver(A, Ky=_cones(pairs, "torch"), dtype=torch.float64, device="cpu")
    assert smw.strategy == "smw"
    rs = smw.solve(b, c, settings=P.SolverSettings(**st))
    assert rs.status == P.Status.SUCCESS
    assert float(rp.optval) == pytest.approx(float(rs.optval), rel=1e-3, abs=1e-4)


def test_cone_strategy_choice_and_graph_route():
    A, b, c, pairs = _box_lp()
    cones = _cones(pairs, "torch")
    assert P.ConeSolver(sp.csr_matrix(A), Ky=cones, device="cpu").strategy == "cg"
    assert P.ConeSolver(A, Ky=cones, device="cpu").strategy == "smw"
    assert P.ConeSolver(A, Ky=cones, device="cpu", projector="cgls").strategy == "direct"
    big = np.zeros((2000, 3))
    assert P.ConeSolver(big, device="cpu", projector="cgls").strategy == "cg"
    # K_x non-empty: the graph-form cone loop with the CGLS projector.
    Kx = [(JC.NON_NEG, range(A.shape[1]))]
    st = dict(abs_tol=1e-5, rel_tol=1e-5, max_iter=3000)
    js = JConeSolver(sp.csr_matrix(A), Kx=_cones(Kx, "jax"), Ky=_cones(pairs, "jax"),
                     dtype=jnp.float64)
    ps = P.ConeSolver(sp.csr_matrix(A), Kx=_cones(Kx, "torch"), Ky=cones,
                      dtype=torch.float64, device="cpu")
    assert ps.projector == "cgls" and not ps.use_hsde
    rj = js.solve(b, c, settings=JSet(**st))
    rp = ps.solve(b, c, settings=P.SolverSettings(**st))
    assert rp.status == P.Status(int(rj.status))
    assert int(rp.final_iter) == int(rj.final_iter)
    np.testing.assert_allclose(rp.x.numpy(), np.asarray(rj.x), atol=2e-5)


def _tail_lp(m0=120, n=30, density=0.1, seed=2):
    """tests/test_sparse.py's tail-polish LP shape at a smaller size: sparse
    rows stacked with ±I, all NonNeg."""
    rng = np.random.default_rng(seed)
    Araw = sp.random(m0, n, density=density, random_state=8, format="csr")
    Araw.data[:] = rng.standard_normal(Araw.nnz)
    A = sp.vstack([Araw, sp.eye(n), -sp.eye(n)]).tocsr()
    b = A @ rng.standard_normal(n) + rng.random(A.shape[0]) + 0.1
    return A, b, rng.standard_normal(n)


def test_sparse_lp_tail_polish_reaches_tight_tolerance():
    """The kept sparse LP polishes with Cholesky Newton steps on A densified
    for the polish only: it certifies 1e-6 within the JAX package's
    iterations and matches the dense twin."""
    A, b, c = _tail_lp()
    m = A.shape[0]
    st = dict(abs_tol=1e-6, rel_tol=1e-6, max_iter=3000)
    assert p_hsde.polish_plan(P.ConeSet(_cones([(JC.NON_NEG, range(m))], "torch"), m), m, 30,
                              True, sparse=True) == (250, 250, 10, "chol")
    rj = JConeSolver(A, Ky=_cones([(JC.NON_NEG, range(m))], "jax"), dtype=np.float64,
                     sparse_policy="keep").solve(b, c, settings=JSet(**st))
    rp = P.ConeSolver(A, Ky=_cones([(JC.NON_NEG, range(m))], "torch"), dtype=np.float64,
                      sparse_policy="keep", device="cpu").solve(b, c,
                                                                settings=P.SolverSettings(**st))
    assert rp.status == P.Status(int(rj.status)) == P.Status.SUCCESS
    assert int(rp.final_iter) == int(rj.final_iter) <= 2000
    rd = P.ConeSolver(A.toarray(), Ky=_cones([(JC.NON_NEG, range(m))], "torch"),
                      dtype=np.float64, device="cpu").solve(b, c, settings=P.SolverSettings(**st))
    assert rd.status == P.Status.SUCCESS
    assert float(rp.optval) == pytest.approx(float(rd.optval), rel=1e-5, abs=1e-5)


@pytest.fixture
def small_polish_caps(monkeypatch):
    """The polish caps patched down in both packages, so a small LP is
    beyond the Cholesky caps and polishes matrix-free, every 100 iterations
    with a 200-iteration PCG budget."""
    for mod in (j_hsde, p_hsde):
        for name, v in (("K_POLISH_MAX_M", 10), ("K_POLISH_MAX_N", 10),
                        ("K_POLISH_XL_MAX_M", 10), ("K_POLISH_XL_MAX_N", 10),
                        ("K_POLISH_CG_EVERY", 100), ("K_POLISH_CG_ITERS", 200)):
            monkeypatch.setattr(mod, name, v)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_matrix_free_polish_matches_jax(small_polish_caps, sparse):
    A, b, c = _tail_lp(m0=60, n=20, density=0.2, seed=4)
    m = A.shape[0]
    A_in = A if sparse else A.toarray()
    pairs = [(JC.NON_NEG, range(m))]
    assert p_hsde.polish_plan(P.ConeSet(_cones(pairs, "torch"), m), m, 20, True,
                              sparse=sparse) == (100, 100, 6, "cg")
    st = dict(abs_tol=1e-6, rel_tol=1e-6, max_iter=3000)
    kw = {"sparse_policy": "keep"}
    rj = JConeSolver(A_in, Ky=_cones(pairs, "jax"), dtype=np.float64, **kw).solve(
        b, c, settings=JSet(**st))
    it0 = p_hsde.pcg_psd.iterations
    rp = P.ConeSolver(A_in, Ky=_cones(pairs, "torch"), dtype=np.float64, device="cpu",
                      **kw).solve(b, c, settings=P.SolverSettings(**st))
    assert p_hsde.pcg_psd.iterations > it0       # the burst ran
    assert rp.status == P.Status(int(rj.status)) == P.Status.SUCCESS
    assert int(rp.final_iter) == int(rj.final_iter)
    assert float(rp.optval) == pytest.approx(float(rj.optval), rel=1e-6)
    np.testing.assert_allclose(rp.x.numpy(), np.asarray(rj.x), atol=2e-5)


def test_solve_cone_problem_keeps_scipy_sparse():
    A, b, c, _ = _box_lp()
    S = sp.csr_matrix(A)
    dims = {"l": A.shape[0]}
    rj = P.solve_cone_problem(c, S, b, dims, device="cpu", max_iter=5000)
    rd = P.solve_cone_problem(c, A, b, dims, device="cpu", max_iter=5000)
    assert rj["status"] == rd["status"] == 0
    assert rj["optval"] == pytest.approx(rd["optval"], rel=1e-3, abs=1e-4)
    from pogs_tpu_torch.api.cone import _CONE_PROBLEM_SOLVERS, auto_rho

    solvers = [s for s in _CONE_PROBLEM_SOLVERS.values() if s.A.is_sparse]
    assert len(solvers) == 1 and solvers[0].strategy == "cg"
    # auto_rho reads the Frobenius norm of a sparse A.
    dims_q = {"l": A.shape[0] - 4, "q": [4]}
    assert auto_rho(S, b, c, dims_q) == pytest.approx(auto_rho(A, b, c, dims_q), rel=1e-12)


@pytest.mark.parametrize("layout", ["torch_coo", "torch_csr"])
def test_solve_cone_problem_takes_torch_sparse(layout):
    """A sparse torch tensor takes the scipy matrix's route: the same solve,
    residual diagnostic and auto-ρ."""
    A, b, c, _ = _box_lp()
    S = sp.csr_matrix(A)
    T = _inputs(S)[layout]
    dims = {"l": A.shape[0]}
    rs = P.solve_cone_problem(c, S, b, dims, device="cpu", max_iter=5000)
    rt = P.solve_cone_problem(c, T, b, dims, device="cpu", max_iter=5000)
    assert rt["status"] == rs["status"] == 0
    assert rt["iterations"] == rs["iterations"]
    np.testing.assert_allclose(rt["x"], rs["x"], atol=1e-12)
    assert rt["primal_res"] == pytest.approx(rs["primal_res"], rel=1e-9, abs=1e-12)
    from pogs_tpu_torch.api.cone import auto_rho

    dims_q = {"l": A.shape[0] - 4, "q": [4]}
    assert auto_rho(T, b, c, dims_q) == pytest.approx(auto_rho(A, b, c, dims_q), rel=1e-12)
