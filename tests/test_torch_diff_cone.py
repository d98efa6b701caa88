"""The port's differentiable cone layer (pogs_tpu_torch/api/diff_cone.py) and
the exponential projection's implicit derivative, against finite-difference
and structural oracles.

Every test of tests/test_diff_cone.py, on the port, with the same problems,
oracles and tolerances: HiGHS (scipy.optimize.linprog) for the LP, central
finite differences through forward solves for LP / SOCP / SDP /
exponential-cone gradients, zeros at a nondegenerate vertex, the four
Jacobian cases of the exponential projection (torch.func.jacfwd against
differences, jacrev against jacfwd), and GMRES against the dense solve.
Where the JAX tests vmap over b, these pass a leading batch dimension.  CPU,
float64.
"""

import numpy as np
import pytest
import torch

from pogs_tpu_torch.api.diff_cone import diff_cone_solve, make_diff_cone_solver
from pogs_tpu_torch.cones.projections import project_exp_dual, project_exp_primal
from pogs_tpu_torch.types import Cone, ConeConstraint, SolverSettings

torch.set_num_threads(1)

TIGHT = SolverSettings(abs_tol=1e-10, rel_tol=1e-10, max_iter=40000)
F64 = torch.float64


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _grad(fn, *args):
    leaves = [a.detach().clone().requires_grad_() for a in args]
    return torch.autograd.grad(fn(*leaves), leaves)


def _fd(loss, p, V, eps=1e-6):
    return (float(loss(p + eps * V)) - float(loss(p - eps * V))) / (2 * eps)


def _lp(rng, m=18, n=8):
    """Bounded-feasible random inequality LP: min c'x s.t. Ax <= b."""
    A = rng.standard_normal((m, n))
    x0 = rng.standard_normal(n)
    b = A @ x0 + rng.random(m) + 0.1     # x0 strictly feasible
    c = rng.standard_normal(n)
    A = np.vstack([A, np.eye(n), -np.eye(n)])
    b = np.concatenate([b, np.full(n, 5.0), np.full(n, 5.0)])
    return t(A), t(b), t(c)


def _nonneg(A):
    return [ConeConstraint(Cone.NON_NEG, range(A.shape[0]))]


def test_lp_solution_matches_linprog(rng):
    from scipy.optimize import linprog

    A, b, c = _lp(rng)
    x, aux = diff_cone_solve(A, b, c, _nonneg(A), settings=TIGHT)
    assert int(aux["status"]) == 0
    ref = linprog(c.numpy(), A_ub=A.numpy(), b_ub=b.numpy(), bounds=(None, None),
                  method="highs")
    assert ref.status == 0
    assert float(aux["optval"]) == pytest.approx(ref.fun, rel=1e-7, abs=1e-8)
    np.testing.assert_allclose(x.numpy(), ref.x, atol=1e-6)


def test_lp_grad_b_vs_finite_diff(rng):
    A, b, c = _lp(rng)
    Ky = _nonneg(A)
    w = t(rng.standard_normal(A.shape[1]))

    def loss(b_):
        return w @ diff_cone_solve(A, b_, c, Ky, settings=TIGHT)[0]

    (g,) = _grad(loss, b)
    V = t(rng.standard_normal(b.shape))
    assert float(g @ V) == pytest.approx(_fd(loss, b, V), rel=5e-4, abs=1e-9)


def test_lp_grad_c_is_zero_at_nondegenerate_vertex(rng):
    """x*(c) is locally constant at a nondegenerate vertex, so dx/dc = 0:
    exact zeros from the generalized Jacobian, not noise."""
    A, b, c = _lp(rng)
    Ky = _nonneg(A)
    w = t(rng.standard_normal(A.shape[1]))
    (g,) = _grad(lambda c_: w @ diff_cone_solve(A, b, c_, Ky, settings=TIGHT)[0], c)
    np.testing.assert_allclose(g.numpy(), 0.0, atol=1e-6)


def test_lp_grad_A_vs_finite_diff(rng):
    A, b, c = _lp(rng, m=12, n=5)
    Ky = _nonneg(A)

    def loss(A_):
        return torch.sum(diff_cone_solve(A_, b, c, Ky, settings=TIGHT)[0] ** 2)

    (g,) = _grad(loss, A)
    V = t(rng.standard_normal(A.shape))
    assert float(torch.sum(g * V)) == pytest.approx(_fd(loss, A, V), rel=1e-3, abs=1e-8)


# ---------------------------------------------------------------------------
# SOCP
# ---------------------------------------------------------------------------

def _socp(rng, n=6):
    """min c'x s.t. ||F x - g|| <= d'x - e as one SOC row block, plus box rows."""
    F = rng.standard_normal((n + 2, n))
    g = rng.standard_normal(n + 2)
    d = rng.standard_normal(n)
    x0 = rng.standard_normal(n)
    e = float(d @ x0 - np.linalg.norm(F @ x0 - g) - 1.0)
    c = rng.standard_normal(n)
    A = np.vstack([-d[None, :], F])
    b = np.concatenate([[-e], g])
    A_full = np.vstack([np.eye(n), -np.eye(n), A])
    b_full = np.concatenate([np.full(n, 4.0), np.full(n, 4.0), b])
    Ky = [ConeConstraint(Cone.NON_NEG, range(2 * n)),
          ConeConstraint(Cone.SOC, range(2 * n, 2 * n + n + 3))]
    return t(A_full), t(b_full), t(c), Ky


def test_socp_grads_vs_finite_diff(rng):
    A, b, c, Ky = _socp(rng)
    _, aux = diff_cone_solve(A, b, c, Ky, settings=TIGHT)
    assert int(aux["status"]) == 0

    def loss(b_, c_):
        return torch.sum(diff_cone_solve(A, b_, c_, Ky, settings=TIGHT)[0] ** 2)

    gb, gc = _grad(loss, b, c)
    Vb = t(rng.standard_normal(b.shape))
    Vc = t(rng.standard_normal(c.shape))
    fd_b = _fd(lambda b_: loss(b_, c), b, Vb)
    fd_c = _fd(lambda c_: loss(b, c_), c, Vc)
    assert float(gb @ Vb) == pytest.approx(fd_b, rel=2e-3, abs=1e-8)
    assert float(gc @ Vc) == pytest.approx(fd_c, rel=2e-3, abs=1e-8)


# ---------------------------------------------------------------------------
# SDP
# ---------------------------------------------------------------------------

def _svec(M):
    """Upper-triangle svec with sqrt(2) off-diagonals (ConeSolver basis)."""
    k = M.shape[0]
    return np.asarray([M[i, j] * (1.0 if i == j else np.sqrt(2.0))
                       for i in range(k) for j in range(i, k)])


def test_sdp_grad_b_vs_finite_diff(rng):
    """min <C,X> over X(x) = B0 + x0 B1 + x1 B2 PSD, plus box rows on x."""
    k = 3

    def rnd_sym():
        M = rng.standard_normal((k, k))
        return (M + M.T) / 2

    B0 = np.eye(k) * 2.0
    B1, B2 = rnd_sym(), rnd_sym()
    C = rnd_sym()
    c = np.array([np.trace(C @ B1), np.trace(C @ B2)])
    nsvec = k * (k + 1) // 2
    A_sdp = np.column_stack([-_svec(B1), -_svec(B2)])
    A = np.vstack([np.eye(2), -np.eye(2), A_sdp])
    b = np.concatenate([np.full(2, 3.0), np.full(2, 3.0), _svec(B0)])
    Ky = [ConeConstraint(Cone.NON_NEG, range(4)),
          ConeConstraint(Cone.SDP, range(4, 4 + nsvec))]

    A, b, c = t(A), t(b), t(c)
    x, aux = diff_cone_solve(A, b, c, Ky, settings=TIGHT)
    assert int(aux["status"]) == 0
    # The PSD constraint is active at the optimum, so the gradient goes
    # through the SDP projection's Jacobian.
    X = B0 + float(x[0]) * B1 + float(x[1]) * B2
    assert np.linalg.eigvalsh(X).min() < 1e-6

    def loss(b_):
        return torch.sum(diff_cone_solve(A, b_, c, Ky, settings=TIGHT)[0] ** 2)

    (g,) = _grad(loss, b)
    V = t(rng.standard_normal(b.shape))
    assert float(g @ V) == pytest.approx(_fd(loss, b, V), rel=2e-3, abs=1e-8)


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------

def test_jit_vmap_over_b_batch(rng):
    A, b, c = _lp(rng, m=10, n=4)
    Ky = _nonneg(A)
    fn = make_diff_cone_solver(Ky, A.shape[0], A.shape[1], settings=TIGHT)
    bs = torch.stack([b, b + 0.05, b + 0.1])

    xs, aux = fn(A, bs, c)
    assert xs.shape == (3, A.shape[1]) and aux["status"].shape == (3,)
    for i in range(3):
        x_i, _ = diff_cone_solve(A, bs[i], c, Ky, settings=TIGHT)
        np.testing.assert_allclose(xs[i].numpy(), x_i.numpy(), atol=1e-7)


# ---------------------------------------------------------------------------
# Exponential cone: the implicit derivative of the projection
# ---------------------------------------------------------------------------

def _exp_proj_points():
    """One representative v per Jacobian case of the exp projection."""
    return {
        "interior": t([0.1, 1.0, 4.0]),          # s e^{r/s} < t
        "polar": t([0.5, -2.0, -1.0]),           # proj = 0
        "ray": t([-2.0, -0.5, 1.5]),             # face (r<0, t>0)
        "generic": t([1.0, 1.0, 1.0]),           # smooth boundary
    }


@pytest.mark.parametrize("case", ["interior", "polar", "ray", "generic"])
def test_exp_projection_jacfwd_vs_finite_diff(case):
    v = _exp_proj_points()[case][None, :]  # (1, 3) batch
    J = torch.func.jacfwd(project_exp_primal)(v)[0, :, 0, :]
    eps = 1e-6
    for k in range(3):
        dv = torch.zeros(3, dtype=F64)
        dv[k] = eps
        fd = (project_exp_primal(v + dv[None]) - project_exp_primal(v - dv[None]))[0] / (2 * eps)
        np.testing.assert_allclose(J[:, k].numpy(), fd.numpy(), atol=5e-5,
                                   err_msg=f"{case} col {k}")


def test_exp_projection_jacrev_matches_jacfwd():
    """The derivative transposes: reverse mode (what the gmres route uses)
    equals forward mode."""
    v = torch.stack(list(_exp_proj_points().values()))
    Jf = torch.func.jacfwd(project_exp_primal)(v)
    Jr = torch.func.jacrev(project_exp_primal)(v)
    np.testing.assert_allclose(Jf.numpy(), Jr.numpy(), atol=1e-12)


def test_exp_dual_projection_grad_consistent():
    v = t([[0.3, -0.8, 1.7]])
    J = torch.func.jacfwd(project_exp_dual)(v)[0, :, 0, :]
    eps = 1e-6
    for k in range(3):
        dv = torch.zeros(3, dtype=F64)
        dv[k] = eps
        fd = (project_exp_dual(v + dv[None]) - project_exp_dual(v - dv[None]))[0] / (2 * eps)
        np.testing.assert_allclose(J[:, k].numpy(), fd.numpy(), atol=5e-5)


def test_exp_cone_solve_grad_vs_finite_diff(rng):
    """min x1 − x0 s.t. (x0, 1, x1) ∈ K_exp plus box rows: the optimum lies
    on x1 = e^{x0} at (0, 1); gradient in b against differences."""
    n = 2
    A_exp = np.array([[-1.0, 0.0], [0.0, 0.0], [0.0, -1.0]])
    b_exp = np.array([0.0, 1.0, 0.0])
    A = t(np.vstack([np.eye(n), -np.eye(n), A_exp]))
    b = t(np.concatenate([np.full(n, 3.0), np.full(n, 3.0), b_exp]))
    c = t([-1.0, 1.0])
    Ky = [ConeConstraint(Cone.NON_NEG, range(2 * n)),
          ConeConstraint(Cone.EXP_PRIMAL, range(2 * n, 2 * n + 3))]
    st = SolverSettings(abs_tol=1e-9, rel_tol=1e-9, max_iter=40000)
    x, aux = diff_cone_solve(A, b, c, Ky, settings=st)
    assert int(aux["status"]) == 0
    np.testing.assert_allclose(x.numpy(), [0.0, 1.0], atol=1e-5)

    def loss(b_):
        return torch.sum(diff_cone_solve(A, b_, c, Ky, settings=st)[0] ** 2)

    (g,) = _grad(loss, b)
    V = t(rng.standard_normal(b.shape))
    assert float(g @ V) == pytest.approx(_fd(loss, b, V), rel=5e-3, abs=1e-7)


def test_gmres_matches_dense(rng):
    A, b, c = _lp(rng, m=10, n=4)
    Ky = _nonneg(A)
    w = t(rng.standard_normal(A.shape[1]))

    def g(kind):
        return _grad(lambda b_: w @ diff_cone_solve(A, b_, c, Ky, settings=TIGHT,
                                                    linear_solver=kind)[0], b)[0]

    np.testing.assert_allclose(g("gmres").numpy(), g("dense").numpy(), atol=1e-7)
