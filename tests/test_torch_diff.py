"""The port's differentiable graph-form layers (pogs_tpu_torch/api/diff.py)
against analytic and finite-difference oracles.

Every test of tests/test_diff.py, on the port, with the same problems, oracles
and tolerances: the ridge closed form (and its autograd gradient), central
finite differences through forward solves, the equality-QP KKT system, scipy's
SLSQP, and GMRES against the dense solve.  Where the JAX tests compose a layer
with ``jax.vmap``, these pass a leading batch dimension.  CPU, float64.
"""

import numpy as np
import pytest
import torch

from pogs_tpu_torch.api.diff import (
    diff_elastic_net,
    diff_lasso,
    diff_logistic,
    diff_nonneg_ls,
    diff_qp,
    diff_ridge,
    make_diff_solver,
)
from pogs_tpu_torch.types import Function, SolverSettings

torch.set_num_threads(1)

TIGHT = SolverSettings(abs_tol=1e-9, rel_tol=1e-9, max_iter=40000)
F64 = torch.float64


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _problem(rng, m=24, n=12):
    A = rng.standard_normal((m, n))
    x_true = rng.standard_normal(n)
    x_true[rng.random(n) < 0.5] = 0.0
    b = A @ x_true + 0.05 * rng.standard_normal(m)
    return t(A), t(b)


def _ridge_closed_form(A, b, lam):
    n = A.shape[1]
    return torch.linalg.solve(A.T @ A + lam * torch.eye(n, dtype=A.dtype), A.T @ b)


def _grad(fn, *args):
    """Gradients of the scalar fn(*args) w.r.t. every argument."""
    leaves = [a.detach().clone().requires_grad_() for a in args]
    return torch.autograd.grad(fn(*leaves), leaves)


def _fd(loss, p, V, eps):
    return (float(loss(p + eps * V)) - float(loss(p - eps * V))) / (2 * eps)


# ---------------------------------------------------------------------------
# Ridge: analytic gradient oracle
# ---------------------------------------------------------------------------

def test_ridge_solution_matches_closed_form(rng):
    A, b = _problem(rng)
    lam = 0.7
    x, aux = diff_ridge(A, b, lam, settings=TIGHT)
    np.testing.assert_allclose(x.numpy(), _ridge_closed_form(A, b, lam).numpy(), atol=1e-6)
    assert int(aux["status"]) == 0


def test_ridge_grad_lambda_vs_analytic(rng):
    A, b = _problem(rng)
    w = t(rng.standard_normal(A.shape[1]))
    (g_imp,) = _grad(lambda lam: w @ diff_ridge(A, b, lam, settings=TIGHT)[0], t(0.5))
    (g_ana,) = _grad(lambda lam: w @ _ridge_closed_form(A, b, lam), t(0.5))
    np.testing.assert_allclose(float(g_imp), float(g_ana), rtol=1e-4)


def test_ridge_grad_b_and_A_vs_analytic(rng):
    A, b = _problem(rng, m=16, n=8)
    w = t(rng.standard_normal(A.shape[1]))
    lam = t(0.9)
    gA_i, gb_i = _grad(lambda A_, b_: w @ diff_ridge(A_, b_, lam, settings=TIGHT)[0], A, b)
    gA_a, gb_a = _grad(lambda A_, b_: w @ _ridge_closed_form(A_, b_, lam), A, b)
    np.testing.assert_allclose(gb_i.numpy(), gb_a.numpy(), atol=1e-5)
    np.testing.assert_allclose(gA_i.numpy(), gA_a.numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# Lasso: nonsmooth g, generalized-Jacobian implicit gradients vs FD
# ---------------------------------------------------------------------------

def test_lasso_grad_lambda_vs_finite_diff(rng):
    A, b = _problem(rng)
    lam0 = 0.4 * float((A.T @ b).abs().max())
    x_ref = t(rng.standard_normal(A.shape[1]))

    def loss(lam):
        x, _ = diff_lasso(A, b, lam, settings=TIGHT)
        return 0.5 * torch.sum((x - x_ref) ** 2)

    (g,) = _grad(loss, t(lam0))
    eps = 1e-5 * lam0
    fd = (float(loss(t(lam0 + eps))) - float(loss(t(lam0 - eps)))) / (2 * eps)
    assert float(g) == pytest.approx(fd, rel=2e-3, abs=1e-8)


def test_lasso_inactive_set_gets_zero_gradient(rng):
    """Soft-threshold dead zone: coordinates off the support have exactly
    zero rows of dx/dλ (the generalized Jacobian)."""
    A, b = _problem(rng)
    lam = 0.8 * float((A.T @ b).abs().max())  # heavy shrinkage
    x, _ = diff_lasso(A, b, lam, settings=TIGHT)
    inactive = np.abs(x.numpy()) < 1e-10
    assert inactive.any()  # the test needs a nontrivial dead zone

    J = torch.autograd.functional.jacobian(
        lambda lam_: diff_lasso(A, b, lam_, settings=TIGHT)[0], t(lam))
    np.testing.assert_allclose(J.numpy()[inactive], 0.0, atol=1e-12)


# ---------------------------------------------------------------------------
# Other families
# ---------------------------------------------------------------------------

def test_elastic_net_grads_vs_finite_diff(rng):
    A, b = _problem(rng)
    lam1 = 0.3 * float((A.T @ b).abs().max())
    lam2 = 0.5

    def loss(l1, l2):
        x, _ = diff_elastic_net(A, b, l1, l2, settings=TIGHT)
        return torch.sum(x ** 2)

    g1, g2 = _grad(loss, t(lam1), t(lam2))
    eps = 1e-5
    fd1 = (float(loss(t(lam1 + eps), t(lam2))) - float(loss(t(lam1 - eps), t(lam2)))) / (2 * eps)
    fd2 = (float(loss(t(lam1), t(lam2 + eps))) - float(loss(t(lam1), t(lam2 - eps)))) / (2 * eps)
    assert float(g1) == pytest.approx(fd1, rel=2e-3, abs=1e-8)
    assert float(g2) == pytest.approx(fd2, rel=2e-3, abs=1e-8)


def test_logistic_grad_b_effect_vs_finite_diff(rng):
    m, n = 20, 6
    A = t(rng.standard_normal((m, n)))
    labels = np.sign(rng.standard_normal(m))
    labels[labels == 0] = 1.0
    lam = 0.05

    def loss(A_):
        x, _ = diff_logistic(A_, labels, lam, settings=TIGHT)
        return torch.sum(x ** 2)

    (g,) = _grad(loss, A)
    V = t(rng.standard_normal(A.shape))
    fd = _fd(loss, A, V, 1e-6)
    assert float(torch.sum(g * V)) == pytest.approx(fd, rel=5e-3, abs=1e-8)


def test_nonneg_ls_active_constraints_grad(rng):
    """Indicator g (projection prox): gradients exist a.e. and clamped
    coordinates have zero sensitivity."""
    A, b = _problem(rng)

    def loss(b_):
        x, _ = diff_nonneg_ls(A, b_, settings=TIGHT)
        return torch.sum(x)

    (g,) = _grad(loss, b)
    V = t(rng.standard_normal(b.shape))
    fd = _fd(loss, b, V, 1e-6)
    assert float(g @ V) == pytest.approx(fd, rel=5e-3, abs=1e-8)


# ---------------------------------------------------------------------------
# diff_qp: OptNet-style QP layer
# ---------------------------------------------------------------------------

def _rand_spd(rng, n, cond=10.0):
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    lams = np.geomspace(1.0, cond, n)
    return t(Q @ np.diag(lams) @ Q.T)


def _eq_qp_closed_form(P, q, A, b):
    """KKT solve for min 1/2 x'Px + q'x s.t. Ax = b (autodiffable oracle)."""
    n, p = P.shape[0], A.shape[0]
    K = torch.cat([torch.cat([P, A.T], 1),
                   torch.cat([A, torch.zeros((p, p), dtype=P.dtype)], 1)], 0)
    return torch.linalg.solve(K, torch.cat([-q, b]))[:n]


def test_diff_qp_equality_matches_kkt(rng):
    n, p = 8, 3
    P = _rand_spd(rng, n)
    q = t(rng.standard_normal(n))
    A = t(rng.standard_normal((p, n)))
    b = t(rng.standard_normal(p))
    x, aux = diff_qp(P, q, A=A, b=b, settings=TIGHT)
    np.testing.assert_allclose(x.numpy(), _eq_qp_closed_form(P, q, A, b).numpy(), atol=1e-6)
    assert int(aux["status"]) == 0


def test_diff_qp_grads_vs_analytic_equality(rng):
    n, p = 6, 2
    P = _rand_spd(rng, n)
    A = t(rng.standard_normal((p, n)))
    b = t(rng.standard_normal(p))
    w = t(rng.standard_normal(n))
    q0 = t(rng.standard_normal(n))
    gq_i, gb_i = _grad(lambda q_, b_: w @ diff_qp(P, q_, A=A, b=b_, settings=TIGHT)[0], q0, b)
    gq_a, gb_a = _grad(lambda q_, b_: w @ _eq_qp_closed_form(P, q_, A, b_), q0, b)
    np.testing.assert_allclose(gq_i.numpy(), gq_a.numpy(), atol=1e-5)
    np.testing.assert_allclose(gb_i.numpy(), gb_a.numpy(), atol=1e-5)


def test_diff_qp_inequality_solution_and_grad(rng):
    """Box-active QP: active rows behave as equalities locally, inactive rows
    have zero sensitivity; both checked by finite differences on h."""
    from scipy.optimize import minimize

    n, mi = 7, 10
    P = _rand_spd(rng, n)
    q = t(rng.standard_normal(n))
    G = t(rng.standard_normal((mi, n)))
    x_uncon = torch.linalg.solve(P, -q)
    slack = np.where(rng.random(mi) < 0.5, -0.1, 0.5)
    h = G @ x_uncon + t(slack)

    Pn, qn, Gn, hn = (v.numpy() for v in (P, q, G, h))
    res = minimize(
        lambda x: 0.5 * x @ Pn @ x + qn @ x,
        np.zeros(n),
        jac=lambda x: Pn @ x + qn,
        constraints=[{"type": "ineq", "fun": lambda x: hn - Gn @ x, "jac": lambda x: -Gn}],
        method="SLSQP", options={"maxiter": 400, "ftol": 1e-14},
    )
    x, _ = diff_qp(P, q, G=G, h=h, settings=TIGHT)
    np.testing.assert_allclose(x.numpy(), res.x, atol=2e-5)

    def loss(h_):
        x_, _ = diff_qp(P, q, G=G, h=h_, settings=TIGHT)
        return torch.sum(x_ ** 2)

    (g,) = _grad(loss, h)
    V = t(rng.standard_normal(mi))
    fd = _fd(loss, h, V, 1e-6)
    assert float(g @ V) == pytest.approx(fd, rel=5e-3, abs=1e-7)


def test_diff_qp_grad_P_vs_finite_diff(rng):
    """Gradient through the quadratic term (the Cholesky factor of P in the
    stacked operator rows)."""
    n = 5
    P0 = _rand_spd(rng, n)
    q = t(rng.standard_normal(n))
    A = t(rng.standard_normal((2, n)))
    b = t(rng.standard_normal(2))
    V = rng.standard_normal((n, n))
    V = t((V + V.T) / 2)  # keep P symmetric along the FD path

    (g,) = _grad(lambda P_: torch.sum(diff_qp(P_, q, A=A, b=b, settings=TIGHT)[0] ** 2), P0)
    (g_a,) = _grad(lambda P_: torch.sum(_eq_qp_closed_form(P_, q, A, b) ** 2), P0)
    assert float(torch.sum(g * V)) == pytest.approx(float(torch.sum(g_a * V)), rel=1e-3,
                                                    abs=1e-8)


def test_diff_qp_vmap_batch(rng):
    """A batch of QPs differing in q (the leading batch dimension, the
    counterpart of jax.vmap): the convex-layer use."""
    n, p, B = 6, 2, 4
    P = _rand_spd(rng, n)
    A = t(rng.standard_normal((p, n)))
    b = t(rng.standard_normal(p))
    qs = t(rng.standard_normal((B, n)))

    xs, aux = diff_qp(P, qs, A=A, b=b, settings=TIGHT)
    assert xs.shape == (B, n) and aux["status"].shape == (B,)
    for i in range(B):
        np.testing.assert_allclose(xs[i].numpy(), _eq_qp_closed_form(P, qs[i], A, b).numpy(),
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# Composition: batches, the gmres path, the factory
# ---------------------------------------------------------------------------

def test_jit_vmap_grad_over_lambda_batch(rng):
    A, b = _problem(rng, m=16, n=8)
    lams = t([0.1, 0.5, 1.0, 2.0])

    # One batched call; each λ's loss depends on its own solution only, so
    # the gradient of the sum is the per-λ gradient.
    (g_batch,) = _grad(lambda l: torch.sum(diff_ridge(A, b, l, settings=TIGHT)[0] ** 2), lams)
    g_ana = torch.stack([
        _grad(lambda l: torch.sum(_ridge_closed_form(A, b, l) ** 2), lam)[0] for lam in lams])
    np.testing.assert_allclose(g_batch.numpy(), g_ana.numpy(), rtol=1e-4)


def test_gmres_linear_solver_matches_dense(rng):
    A, b = _problem(rng, m=14, n=7)

    def grad(kind):
        return _grad(lambda l: torch.sum(
            diff_ridge(A, b, l, settings=TIGHT, linear_solver=kind)[0] ** 2), t(0.6))[0]

    np.testing.assert_allclose(float(grad("gmres")), float(grad("dense")), rtol=1e-6)


def test_make_diff_solver_custom_objective(rng):
    """Direct factory use with huber f (smooth, non-quadratic)."""
    m, n = 18, 9
    A = t(rng.standard_normal((m, n)))
    b = t(rng.standard_normal(m))
    fn = make_diff_solver(
        np.full(m, Function.HUBER, np.int32),
        np.full(n, Function.SQUARE, np.int32),
        settings=TIGHT,
    )
    ones_m, zer_m = torch.ones(m, dtype=F64), torch.zeros(m, dtype=F64)
    ones_n, zer_n = torch.ones(n, dtype=F64), torch.zeros(n, dtype=F64)

    def loss(lam):
        fp = (ones_m, b, ones_m, zer_m, zer_m)
        gp = (ones_n, zer_n, lam * ones_n, zer_n, zer_n)
        x, _ = fn(A, fp, gp)
        return torch.sum(x ** 2)

    lam0 = 0.5
    (g,) = _grad(loss, t(lam0))
    eps = 1e-5
    fd = (float(loss(t(lam0 + eps))) - float(loss(t(lam0 - eps)))) / (2 * eps)
    assert float(g) == pytest.approx(fd, rel=2e-3, abs=1e-8)


def test_layers_import_neither_jax_nor_pogs_tpu():
    """The differentiable layers pull in no JAX and nothing of pogs_tpu."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "import pogs_tpu_torch.api.diff, pogs_tpu_torch.api.diff_cone\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'pogs_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)
