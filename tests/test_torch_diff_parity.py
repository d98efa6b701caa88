"""The port's differentiable graph-form layers against pogs_tpu's, on the
same inputs.

``diff_lasso``, ``diff_logistic`` and ``diff_qp`` with inequalities: the
same numpy data from one seed through the JAX layer (called as
tests/test_diff.py calls it, under ``jax.grad``) and the port's.  Pass: the
same status and iteration count, x within 1e-8·max(1, ‖x‖∞), and the
gradients w.r.t. A, b and λ (G, h and q for the QP) within rtol 1e-6,
atol 1e-9.  Also the exponential projection's value and tangent against
``jax.jvp`` of the JAX projection on its four Jacobian cases (atol 1e-10).
CPU, float64.  tests/test_torch_diff_cone_parity.py holds the cone layer.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pogs_tpu.api.diff import diff_lasso as j_diff_lasso, diff_logistic as j_diff_logistic
from pogs_tpu.api.diff import diff_qp as j_diff_qp
import pogs_tpu.cones.projections as j_proj
from pogs_tpu.types import SolverSettings as JSet

from pogs_tpu_torch.api.diff import diff_lasso, diff_logistic, diff_qp
from pogs_tpu_torch.cones.projections import project_exp_primal
from pogs_tpu_torch.types import SolverSettings

torch.set_num_threads(1)

F64 = torch.float64
TIGHT = dict(abs_tol=1e-9, rel_tol=1e-9, max_iter=40000)


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _port_grads(layer, args, w):
    """x, aux and the gradients of w·x w.r.t. every tensor argument."""
    leaves = [t(a).requires_grad_() for a in args]
    x, aux = layer(*leaves)
    grads = torch.autograd.grad(torch.dot(t(w), x), leaves)
    return x.detach().numpy(), aux, [g.numpy() for g in grads]


def _jax_grads(layer, args, w):
    def loss(*a):
        x, aux = layer(*a)
        return jnp.dot(jnp.asarray(w), x), (x, aux)

    grads, (x, aux) = jax.grad(loss, argnums=tuple(range(len(args))), has_aux=True)(
        *[jnp.asarray(a) for a in args])
    return np.asarray(x), aux, [np.asarray(g) for g in grads]


def _assert_parity(jax_out, port_out):
    xj, auxj, gj = jax_out
    xp, auxp, gp = port_out
    assert int(auxp["status"]) == int(auxj["status"]) == 0
    assert int(auxp["iterations"]) == int(auxj["iterations"])
    np.testing.assert_allclose(xp, xj, rtol=0, atol=1e-8 * max(1.0, np.abs(xj).max()))
    for k, (a, b) in enumerate(zip(gp, gj)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9, err_msg=f"gradient {k}")


# ---------------------------------------------------------------------------
# Graph form
# ---------------------------------------------------------------------------

def _regression(rng, m, n):
    A = rng.standard_normal((m, n))
    x_true = rng.standard_normal(n)
    x_true[rng.random(n) < 0.5] = 0.0
    return A, A @ x_true + 0.05 * rng.standard_normal(m)


def test_diff_lasso_matches_jax(rng):
    A, b = _regression(rng, 24, 12)
    lam = 0.3 * np.max(np.abs(A.T @ b))
    w = rng.standard_normal(12)
    args = (A, b, np.float64(lam))
    out_j = _jax_grads(lambda *a: j_diff_lasso(*a, settings=JSet(**TIGHT)), args, w)
    out_p = _port_grads(lambda *a: diff_lasso(*a, settings=SolverSettings(**TIGHT)), args, w)
    _assert_parity(out_j, out_p)


def test_diff_logistic_matches_jax(rng):
    m, n = 20, 6
    A = rng.standard_normal((m, n))
    labels = np.sign(rng.standard_normal(m))
    labels[labels == 0] = 1.0
    w = rng.standard_normal(n)
    args = (A, labels, np.float64(0.05))
    out_j = _jax_grads(lambda *a: j_diff_logistic(*a, settings=JSet(**TIGHT)), args, w)
    out_p = _port_grads(lambda *a: diff_logistic(*a, settings=SolverSettings(**TIGHT)),
                        args, w)
    _assert_parity(out_j, out_p)


def test_diff_qp_inequality_matches_jax(rng):
    n, mi = 7, 10
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    P = Q @ np.diag(np.geomspace(1.0, 10.0, n)) @ Q.T
    q = rng.standard_normal(n)
    G = rng.standard_normal((mi, n))
    h = G @ np.linalg.solve(P, -q) + np.where(rng.random(mi) < 0.5, -0.1, 0.5)
    w = rng.standard_normal(n)
    # Gradients w.r.t. the constraint matrix G, its bound h and q.
    args = (G, h, q)
    out_j = _jax_grads(lambda G_, h_, q_: j_diff_qp(P, q_, G=G_, h=h_, settings=JSet(**TIGHT)),
                       args, w)
    out_p = _port_grads(lambda G_, h_, q_: diff_qp(t(P), q_, G=G_, h=h_,
                                                   settings=SolverSettings(**TIGHT)), args, w)
    _assert_parity(out_j, out_p)


# ---------------------------------------------------------------------------
# The exponential projection's tangent
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["interior", "polar", "ray", "generic"])
def test_exp_projection_tangent_matches_jax(rng, case):
    v = {"interior": [0.1, 1.0, 4.0], "polar": [0.5, -2.0, -1.0],
         "ray": [-2.0, -0.5, 1.5], "generic": [1.0, 1.0, 1.0]}[case]
    v = np.asarray([v])
    dv = rng.standard_normal((1, 3))
    p_j, dp_j = jax.jvp(j_proj.project_exp_primal, (jnp.asarray(v),), (jnp.asarray(dv),))
    p_p, dp_p = torch.func.jvp(project_exp_primal, (t(v),), (t(dv),))
    np.testing.assert_allclose(p_p.numpy(), np.asarray(p_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(dp_p.numpy(), np.asarray(dp_j), rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# The prox library's derivatives (the backward pass differentiates prox_eval)
# ---------------------------------------------------------------------------

FAMILIES = ["SQUARE", "ABS", "LOGISTIC", "HUBER", "INDGE0", "INDLE0", "INDEQ0", "ZERO"]


@pytest.mark.parametrize("family", FAMILIES)
def test_prox_derivatives_match_jax(rng, family):
    """d prox_eval / d(v, a, b, c, d, e) elementwise at ρ = 1, against
    ``jax.jacfwd`` of the JAX prox on the same points."""
    from pogs_tpu.api.diff import _fv as j_fv
    from pogs_tpu.prox.vector import prox_eval as j_prox_eval
    from pogs_tpu.types import Function as JFunction
    from pogs_tpu_torch.ops.fused_admm import _fv
    from pogs_tpu_torch.prox.vector import prox_eval

    k = 40
    h = np.full(k, int(getattr(JFunction, family)), np.int32)
    v = 3.0 * rng.standard_normal(k)
    params = [rng.choice([-1.0, 1.0], k) * rng.uniform(0.5, 2.0, k),  # a, away from 0
              rng.standard_normal(k), rng.uniform(0.2, 2.0, k),
              rng.standard_normal(k), rng.uniform(0.0, 1.0, k)]

    def j_fn(v_, *p):
        return j_prox_eval(j_fv(h, p), v_, jnp.asarray(1.0))

    def p_fn(v_, *p):
        return prox_eval(_fv(h, p), v_, torch.ones((), dtype=F64))

    args = [v] + params
    J_j = jax.jacfwd(j_fn, argnums=tuple(range(6)))(*[jnp.asarray(a) for a in args])
    J_p = torch.func.jacfwd(p_fn, argnums=tuple(range(6)))(*[t(a) for a in args])
    np.testing.assert_allclose(p_fn(*[t(a) for a in args]).numpy(),
                               np.asarray(j_fn(*[jnp.asarray(a) for a in args])),
                               rtol=1e-12, atol=1e-12)
    for i, (a, b) in enumerate(zip(J_p, J_j)):
        assert np.all(np.isfinite(a.numpy())), f"argument {i}"
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-12,
                                   err_msg=f"argument {i}")
