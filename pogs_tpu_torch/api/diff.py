"""Differentiable graph-form solves: implicit gradients through the optimum.

Counterpart of ``pogs_tpu/api/diff.py``.  A solve is differentiable with
respect to the data matrix ``A`` and every objective parameter (a, b, c, d,
e of both ``f`` and ``g``): λ-selection on a validation loss, bilevel
programs, and convex layers inside a network (OptNet).

Method: the implicit function theorem on the Douglas–Rachford fixed point,
not backpropagation through the ADMM iterations.  ADMM with unit step on
F(z) = g(x) + f(y) and the graph G_A = {(x, y) : y = A x} has the fixed-point
residual, in the reflected variable u,

    R(u, A, f_params, g_params) = Π(2 prox_F(u) − u) − prox_F(u),

Π the orthogonal projection onto G_A.  The solver's primal-dual answer in
the original space gives an exact fixed point at ρ = 1,

    u* = (x* + μ*, y* + ν*),

so the backward pass never touches equilibration, over-relaxation or the ρ
schedule: it solves one (m+n)-dimensional system Jᵀλ = (∂S/∂u)ᵀw with
J = ∂R/∂u (formed by ``torch.func.jacfwd`` up to m+n = 2048, else
matrix-free by GMRES on vector-Jacobian products) and returns

    dθ = ∂S/∂θ − (∂R/∂θ)ᵀλ,       S(u, g_params) = prox_g(u_x) = x*.

The forward pass is ``GraphFormSolver``'s cold solve from zeros at
``settings.rho`` (equilibration, the ‖A‖ estimate, the inverse projector):
on a CUDA device one launch of the solve kernel (``ops/fused_admm.py``), on
the CPU the eager loop.  Both passes run inside ``highest_precision``.

Where the JAX package composes the layers with ``jax.vmap``, a parameter
here may carry a leading batch dimension (the wrappers: b, λ, q, h); the
batch shares one init of A and runs one forward solve per element, each
equal to its own single call.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pogs_tpu_torch.types import Function, SolverSettings
from pogs_tpu_torch.prox.vector import prox_eval
from pogs_tpu_torch.ops.fused_admm import _fv
from pogs_tpu_torch.solver.graph import GraphFormSolver
from pogs_tpu_torch.linalg.gmres import gmres
from pogs_tpu_torch.utils.precision import highest_precision

__all__ = [
    "make_diff_solver",
    "diff_lasso",
    "diff_ridge",
    "diff_elastic_net",
    "diff_logistic",
    "diff_nonneg_ls",
    "diff_qp",
]

_DIFF_CACHE: dict = {}

#: Up to this m+n the fixed-point Jacobian is formed and solved densely;
#: beyond it GMRES solves with vector-Jacobian products.
_DENSE_MAX_DIM = 2048


# ---------------------------------------------------------------------------
# The pieces both layers share (api/diff_cone.py uses them too).
# ---------------------------------------------------------------------------

def graph_projection(A, rx, ry):
    """Π(rx, ry): the projection onto {y = A x} through the Cholesky factor
    of I + AᵀA (m ≥ n) or I + AAᵀ, differentiable in A."""
    m, n = A.shape
    if m >= n:
        K = torch.eye(n, dtype=A.dtype, device=A.device) + A.T @ A
        x_pi = torch.cholesky_solve((rx + A.T @ ry)[:, None], torch.linalg.cholesky(K))[:, 0]
    else:
        K = torch.eye(m, dtype=A.dtype, device=A.device) + A @ A.T
        w = torch.cholesky_solve((A @ rx - ry)[:, None], torch.linalg.cholesky(K))[:, 0]
        x_pi = rx - A.T @ w
    return x_pi, A @ x_pi


def fixed_point_jacobian(R_u, u, dense: bool):
    """J = ∂R/∂u at u (dense), or the function v ↦ Jᵀv (matrix-free)."""
    if dense:
        return torch.func.jacfwd(R_u)(u)
    _, vjp_fn = torch.func.vjp(R_u, u)
    return lambda v: vjp_fn(v)[0]


def adjoint_solve(jac, rhs, dense: bool):
    """λ with Jᵀλ = rhs: a dense solve, or GMRES with tolerance 1e-10,
    restart 20 and 20·dim restarts at most (the JAX package's call)."""
    if dense:
        return torch.linalg.solve(jac.T, rhs)
    lam, _ = gmres(jac, rhs, tol=1e-10, atol=0.0, maxiter=20 * rhs.shape[0])
    return lam


def param_vjp(fn, cotangent, tensors):
    """The vector-Jacobian product of fn(*tensors) with ``cotangent``, one
    gradient per tensor (zeros where fn does not depend on it)."""
    leaves = [t.detach().requires_grad_() for t in tensors]
    with torch.enable_grad():
        grads = torch.autograd.grad(fn(*leaves), leaves, cotangent, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for t, g in zip(tensors, grads)]


def batch_size(tensors) -> Optional[int]:
    """The leading batch dimension of the 2-D tensors among ``tensors``
    (None if none is batched); they must agree."""
    sizes = {t.shape[0] for t in tensors if t.ndim == 2}
    if len(sizes) > 1:
        raise ValueError(f"batched parameters disagree on the batch size: {sorted(sizes)}")
    return sizes.pop() if sizes else None


def element(t, i):
    """Element i of a batched (2-D) tensor; an unbatched one is shared."""
    return t[i] if t.ndim == 2 else t


def batch_grad(grads, t):
    """Per-element gradients of an input: stacked for a batched input,
    summed for a shared one."""
    return torch.stack(grads) if t.ndim == 2 else sum(grads)


def as_matrix(A, device=None):
    """A as a tensor: a tensor keeps its device (unless ``device`` is
    given), anything else goes to ``device``, by default CUDA."""
    if isinstance(A, torch.Tensor):
        return A if device is None else A.to(device)
    return torch.as_tensor(np.asarray(A), device="cuda" if device is None else device)


def as_param(p, length: int, like: torch.Tensor):
    """A parameter as a tensor of ``like``'s dtype and device: a scalar
    broadcasts to (length,); (length,) and (batch, length) pass through.
    A tensor keeps its autograd history."""
    t = p if isinstance(p, torch.Tensor) else torch.as_tensor(np.asarray(p))
    t = t.to(dtype=like.dtype, device=like.device)
    if t.ndim == 0:
        return t.expand(length)
    if t.shape[-1] != length or t.ndim > 2:
        raise ValueError(f"parameter of shape {tuple(t.shape)}, expected ({length},) "
                         f"or (batch, {length})")
    return t


def _aux(outs: list, batched: bool) -> dict:
    """The per-element result dicts as one dict (stacked when batched)."""
    if not batched:
        return outs[0]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


# ---------------------------------------------------------------------------
# The graph-form layer.
# ---------------------------------------------------------------------------

class _GraphLayer:
    """Forward and backward of one (h_f, h_g, settings, linear solver)."""

    def __init__(self, h_f, h_g, settings: SolverSettings, dense: bool):
        self.h_f, self.h_g = h_f, h_g
        self.m, self.n = h_f.shape[0], h_g.shape[0]
        self.settings, self.dense = settings, dense

    def forward(self, A, fps, gps):
        """Cold solves of every batch element on one init of A."""
        B = batch_size(fps + gps)
        solver = GraphFormSolver(A, settings=self.settings)
        outs = []
        for i in range(B or 1):
            solver.reset_warm_start()
            r = solver.solve(_fv(self.h_f, [element(p, i) for p in fps]),
                             _fv(self.h_g, [element(p, i) for p in gps]),
                             rho=float(self.settings.rho))
            outs.append({"x": r.x, "y": r.y, "mu": r.mu, "nu": r.nu, "optval": r.optval,
                         "status": torch.tensor(int(r.status), device=A.device),
                         "iterations": torch.as_tensor(r.final_iter, device=A.device)})
        return _aux(outs, B is not None)

    def residual(self, u, A, *params):
        n = self.n
        one = torch.ones((), dtype=u.dtype, device=u.device)
        px = prox_eval(_fv(self.h_g, params[5:]), u[:n], one)
        py = prox_eval(_fv(self.h_f, params[:5]), u[n:], one)
        x_pi, y_pi = graph_projection(A, 2.0 * px - u[:n], 2.0 * py - u[n:])
        return torch.cat([x_pi - px, y_pi - py])

    def vjp(self, A, params, x, y, mu, nu, ct_x):
        """[dA, d f_params..., d g_params...] of one element for the
        cotangent ct_x of x = S(u*, g_params) = prox_g(u*_x)."""
        n = self.n
        u = torch.cat([x + mu, y + nu])
        one = torch.ones((), dtype=u.dtype, device=u.device)
        gS_u, *gS_g = param_vjp(lambda u_, *gp: prox_eval(_fv(self.h_g, gp), u_[:n], one),
                                ct_x, (u,) + tuple(params[5:]))
        jac = fixed_point_jacobian(lambda u_: self.residual(u_, A, *params), u, self.dense)
        lam = adjoint_solve(jac, gS_u, self.dense)
        dR = param_vjp(lambda *t: self.residual(u, *t), lam, (A,) + tuple(params))
        return [-g for g in dR[:6]] + [s - g for s, g in zip(gS_g, dR[6:])]


class _DiffSolve(torch.autograd.Function):
    """x* of the layer, differentiable in A and the ten parameter tensors;
    the other outputs are not differentiable."""

    @staticmethod
    def forward(ctx, layer, A, *params):
        with highest_precision():
            out = layer.forward(A.detach(), [p.detach() for p in params[:5]],
                                [p.detach() for p in params[5:]])
        ctx.layer = layer
        ctx.save_for_backward(A, *params, out["x"], out["y"], out["mu"], out["nu"])
        aux = [out[k] for k in ("y", "mu", "nu", "optval", "status", "iterations")]
        ctx.mark_non_differentiable(*aux)
        return (out["x"], *aux)

    @staticmethod
    def backward(ctx, ct_x, *_):
        layer = ctx.layer
        A, *rest = ctx.saved_tensors
        params, (x, y, mu, nu) = rest[:10], rest[10:]
        batched = x.ndim == 2
        per = []
        with highest_precision():
            for i in range(x.shape[0] if batched else 1):
                sel = (lambda t: t[i]) if batched else (lambda t: t)
                per.append(layer.vjp(A.detach(), [element(p, i).detach() for p in params],
                                     sel(x), sel(y), sel(mu), sel(nu), sel(ct_x)))
        dA = sum(g[0] for g in per)
        dparams = [batch_grad([g[1 + j] for g in per], p) for j, p in enumerate(params)]
        return (None, dA, *dparams)


def make_diff_solver(
    h_f,
    h_g,
    settings: Optional[SolverSettings] = None,
    linear_solver: str = "auto",
):
    """Build a differentiable graph-form solver for fixed objective types.

    Returns ``fn(A, f_params, g_params) -> (x, aux)``: ``x`` is the primal
    solution, differentiable w.r.t. all three arguments by implicit
    differentiation; ``aux`` holds ``y, mu, nu, optval, status, iterations``
    (not differentiable).  ``f_params`` / ``g_params`` are 5-tuples
    ``(a, b, c, d, e)`` encoding f_i(y) = c h(a y − b) + d y + (e/2) y²;
    each entry is a scalar, a length-m (length-n) tensor, or a (batch, m)
    tensor for a batch of problems on one A (then ``x`` is (batch, n)).

    ``linear_solver``: ``'dense'`` forms the (m+n)² fixed-point Jacobian,
    ``'gmres'`` solves matrix-free, ``'auto'`` picks dense for
    m+n <= {dmax}.  Functions are cached per (h_f, h_g, settings, solver).
    """
    h_f = np.asarray(h_f, np.int32)
    h_g = np.asarray(h_g, np.int32)
    if settings is None:
        settings = SolverSettings(abs_tol=1e-6, rel_tol=1e-6, max_iter=20000)
    if linear_solver not in ("auto", "dense", "gmres"):
        raise ValueError(f"unknown linear_solver {linear_solver!r}")
    m, n = h_f.shape[0], h_g.shape[0]
    key = (h_f.tobytes(), h_g.tobytes(), m, n, settings, linear_solver)
    cached = _DIFF_CACHE.get(key)
    if cached is not None:
        return cached

    dense = linear_solver == "dense" or (linear_solver == "auto" and m + n <= _DENSE_MAX_DIM)
    layer = _GraphLayer(h_f, h_g, settings, dense)

    def fn(A, f_params, g_params):
        if tuple(A.shape) != (m, n):
            raise ValueError(f"A has shape {tuple(A.shape)}, expected {(m, n)}")
        fps = [as_param(p, m, A) for p in f_params]
        gps = [as_param(p, n, A) for p in g_params]
        x, y, mu, nu, optval, status, iterations = _DiffSolve.apply(layer, A, *fps, *gps)
        return x, {"y": y, "mu": mu, "nu": nu, "optval": optval, "status": status,
                   "iterations": iterations}

    if len(_DIFF_CACHE) > 32:  # bound long-process growth
        _DIFF_CACHE.clear()
    _DIFF_CACHE[key] = fn
    return fn


make_diff_solver.__doc__ = make_diff_solver.__doc__.format(dmax=_DENSE_MAX_DIM)


# ---------------------------------------------------------------------------
# Wrappers with the encodings of api/graph.py.  λ is a scalar, or a (batch,)
# tensor for a batch of problems; b is (m,) or (batch, m).
# ---------------------------------------------------------------------------

def _scalar_param(lam, n: int, like):
    """A scalar weight as a g parameter: (n,), or (batch, n) for (batch,)."""
    t = lam if isinstance(lam, torch.Tensor) else torch.as_tensor(np.asarray(lam))
    t = t.to(dtype=like.dtype, device=like.device)
    if t.ndim == 0:
        return t.expand(n)
    if t.ndim == 1:
        return t[:, None].expand(-1, n)
    raise ValueError(f"a weight is a scalar or a (batch,) tensor, got {tuple(t.shape)}")


def _separable(A, f_params, g_params, h_f: Function, h_g: Function, settings, kw):
    m, n = A.shape
    fn = make_diff_solver(np.full(m, h_f, np.int32), np.full(n, h_g, np.int32),
                          settings=settings, **kw)
    return fn(A, f_params, g_params)


def diff_lasso(A, b, lam, settings=None, device=None, **kw):
    """Differentiable lasso: min (1/2)‖Ax − b‖² + λ‖x‖₁.

    Differentiable w.r.t. A, b and λ.  Returns ``(x, aux)``.
    """
    A = as_matrix(A, device)
    n = A.shape[1]
    return _separable(A, (1.0, b, 1.0, 0.0, 0.0),
                      (1.0, 0.0, _scalar_param(lam, n, A), 0.0, 0.0),
                      Function.SQUARE, Function.ABS, settings, kw)


def diff_ridge(A, b, lam, settings=None, device=None, **kw):
    """Differentiable ridge: min (1/2)‖Ax − b‖² + (λ/2)‖x‖²."""
    A = as_matrix(A, device)
    n = A.shape[1]
    return _separable(A, (1.0, b, 1.0, 0.0, 0.0),
                      (1.0, 0.0, _scalar_param(lam, n, A), 0.0, 0.0),
                      Function.SQUARE, Function.SQUARE, settings, kw)


def diff_elastic_net(A, b, lam1, lam2, settings=None, device=None, **kw):
    """Differentiable elastic net: (1/2)‖Ax−b‖² + λ₁‖x‖₁ + (λ₂/2)‖x‖²."""
    A = as_matrix(A, device)
    n = A.shape[1]
    return _separable(A, (1.0, b, 1.0, 0.0, 0.0),
                      (1.0, 0.0, _scalar_param(lam1, n, A), 0.0, _scalar_param(lam2, n, A)),
                      Function.SQUARE, Function.ABS, settings, kw)


def diff_logistic(A, b, lam=0.0, settings=None, device=None, **kw):
    """Differentiable l1-regularized logistic regression (labels b in {−1, +1}):

        minimize Σ_i log(1 + exp(−b_i a_iᵀx)) + λ‖x‖₁,

    the a = −b encoding of ``api/graph.py::solve_logistic``.
    """
    A = as_matrix(A, device)
    n = A.shape[1]
    return _separable(A, (-as_param(b, A.shape[0], A), 0.0, 1.0, 0.0, 0.0),
                      (1.0, 0.0, _scalar_param(lam, n, A), 0.0, 0.0),
                      Function.LOGISTIC, Function.ABS, settings, kw)


def diff_nonneg_ls(A, b, settings=None, device=None, **kw):
    """Differentiable nonnegative least squares: min (1/2)‖Ax − b‖², x ≥ 0."""
    A = as_matrix(A, device)
    return _separable(A, (1.0, b, 1.0, 0.0, 0.0), (1.0, 0.0, 1.0, 0.0, 0.0),
                      Function.SQUARE, Function.INDGE0, settings, kw)


def diff_qp(P, q, G=None, h=None, A=None, b=None, settings=None, device=None, **kw):
    """Differentiable QP layer (OptNet-style):

        minimize   (1/2) xᵀPx + qᵀx
        subject to Gx ≤ h,  Ax = b

    differentiable w.r.t. every argument.  Returns ``(x, aux)``.

    P = LLᵀ by Cholesky (P must be positive definite), and the QP is the
    graph-form problem

        minimize  (1/2)‖y_L‖² + I(y_G ≤ h) + I(y_A = b) + qᵀx
        s.t.      [y_L; y_G; y_A] = [Lᵀ; G; A] x

    (stacked SQUARE / shifted INDLE0 / shifted INDEQ0 rows), differentiated
    like every other family; gradients w.r.t. P flow through the Cholesky
    factor.  q, h and b may carry a leading batch dimension (a batch of QPs
    on one P, G, A: one forward solve per element).
    """
    P = as_matrix(P, device)
    n = P.shape[0]
    L = torch.linalg.cholesky((P + P.T) / 2)
    rows = [L.T]  # ‖Lᵀx‖² = xᵀPx
    h_blocks = [np.full(n, Function.SQUARE, np.int32)]
    shifts = [torch.zeros(n, dtype=P.dtype, device=P.device)]
    for M, v, kind in ((G, h, Function.INDLE0), (A, b, Function.INDEQ0)):
        if M is not None:
            M = as_matrix(M, P.device).to(P.dtype)
            rows.append(M)
            h_blocks.append(np.full(M.shape[0], kind, np.int32))
            shifts.append(as_param(v, M.shape[0], P))
    A_stack = torch.cat(rows, dim=0)
    m = A_stack.shape[0]
    B = batch_size(shifts)
    if B is not None:
        shifts = [s if s.ndim == 2 else s.expand(B, -1) for s in shifts]
    fp = (1.0, torch.cat(shifts, dim=-1), 1.0, 0.0, 0.0)
    gp = (1.0, 0.0, 1.0, as_param(q, n, P), 0.0)
    fn = make_diff_solver(np.concatenate(h_blocks), np.full(n, Function.ZERO, np.int32),
                          settings=settings, **kw)
    return fn(A_stack, fp, gp)
