"""Differentiable cone-form solves: implicit gradients for LP / SOCP / SDP /
exponential-cone programs.

Counterpart of ``pogs_tpu/api/diff_cone.py``.  The solution map of

    minimize    c'x     subject to   b − A x ∈ K

is differentiable w.r.t. ``A``, ``b`` and ``c`` (conic convex layers).

Method (``api/diff.py`` has the derivation): the graph-form split
g(x) = c'x, f(y) = I{b − y ∈ K} has, at ρ = 1 in the original space, the
Douglas–Rachford fixed point

    u* = (x* + c,  y* + ν*),

ν* the returned cone dual.  Its residual uses prox_g(v) = v − c and
prox_f(v) = b − Π_K(b − v) with Π_K = ``ConeSet.project``, whose
generalized Jacobian comes from autograd: masks for Zero / NonNeg / NonPos
rows, the SOC closed form as written, the SDP clamp through
``torch.linalg.eigh``'s derivative, and the exponential cone through the
implicit rule of ``cones/projections.py``.

The forward pass is ``ConeSolver.cold_solve``, its HSDE solve
(equilibration with the cone-averaged row scaling, the τ guard, unscaling)
with the JAX layer's zeros where τ fails, on ``ConeSolver``'s route: the
cone kernel (``ops/fused_hsde.py``, one launch) on a CUDA device for SOC
and exponential cones, the eager loop with its polish for polyhedral cones
when polish is on, and the eager loop for SDP rows (given in the svec
convention).  b and c may carry a leading batch dimension: one init of A,
one forward solve per element.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from pogs_tpu_torch.types import ConeConstraint, SolverSettings
from pogs_tpu_torch.cones.sets import ConeSet
from pogs_tpu_torch.solver.cone import ConeSolver
from pogs_tpu_torch.api.diff import (
    _DENSE_MAX_DIM, _aux, adjoint_solve, as_matrix, as_param, batch_grad, batch_size,
    element, fixed_point_jacobian, graph_projection, param_vjp,
)
from pogs_tpu_torch.utils.precision import highest_precision

__all__ = ["make_diff_cone_solver", "diff_cone_solve"]

_DIFF_CONE_CACHE: dict = {}


class _ConeLayer:
    """Forward and backward of one (cone structure, shape, settings)."""

    def __init__(self, Ky, m, n, settings: SolverSettings, strategy: str, dense: bool):
        self.Ky, self.Kset = Ky, ConeSet(Ky, m)
        self.m, self.n = m, n
        self.settings, self.strategy, self.dense = settings, strategy, dense

    def forward(self, A, bs, cs):
        """Cold HSDE solves of every batch element on one init of A."""
        B = batch_size([bs, cs])
        solver = ConeSolver(A, Ky=self.Ky, settings=self.settings, strategy=self.strategy,
                            assume_svec=True).init()
        outs = [solver.cold_solve(element(bs, i), element(cs, i)) for i in range(B or 1)]
        return _aux(outs, B is not None)

    def residual(self, u, A, b, c):
        n = self.n
        px = u[:n] - c
        py = b - self.Kset.project(b - u[n:])
        x_pi, y_pi = graph_projection(A, 2.0 * px - u[:n], 2.0 * py - u[n:])
        return torch.cat([x_pi - px, y_pi - py])

    def vjp(self, A, b, c, x, y, nu, ct_x):
        """(dA, db, dc) of one element for the cotangent ct_x of x.  S(u, c) =
        u_x − c extracts x*: (∂S/∂u)ᵀw = [w; 0] and (∂S/∂c)ᵀw = −w."""
        u = torch.cat([x + c, y + nu])
        rhs = torch.cat([ct_x, torch.zeros_like(y)])
        jac = fixed_point_jacobian(lambda u_: self.residual(u_, A, b, c), u, self.dense)
        lam = adjoint_solve(jac, rhs, self.dense)
        dA, db, dc = param_vjp(lambda *t: self.residual(u, *t), lam, (A, b, c))
        return -dA, -db, -dc - ct_x


class _DiffConeSolve(torch.autograd.Function):
    """x* of the cone layer, differentiable in A, b and c."""

    @staticmethod
    def forward(ctx, layer, A, b, c):
        with highest_precision():
            out = layer.forward(A.detach(), b.detach(), c.detach())
        ctx.layer = layer
        ctx.save_for_backward(A, b, c, out["x"], out["y"], out["nu"])
        aux = [out[k] for k in ("y", "nu", "s", "optval", "status", "iterations")]
        ctx.mark_non_differentiable(*aux)
        return (out["x"], *aux)

    @staticmethod
    def backward(ctx, ct_x, *_):
        A, b, c, x, y, nu = ctx.saved_tensors
        batched = x.ndim == 2
        per = []
        with highest_precision():
            for i in range(x.shape[0] if batched else 1):
                sel = (lambda t: t[i]) if batched else (lambda t: t)
                per.append(ctx.layer.vjp(A.detach(), element(b, i).detach(),
                                         element(c, i).detach(), sel(x), sel(y), sel(nu),
                                         sel(ct_x)))
        return (None, sum(g[0] for g in per), batch_grad([g[1] for g in per], b),
                batch_grad([g[2] for g in per], c))


def make_diff_cone_solver(
    Ky: Sequence[ConeConstraint],
    m: int,
    n: int,
    settings: Optional[SolverSettings] = None,
    strategy: str = "smw",
    linear_solver: str = "auto",
):
    """Build a differentiable cone solver for a fixed cone structure.

    Returns ``fn(A, b, c) -> (x, aux)``: ``x`` is the primal solution,
    differentiable w.r.t. all three arguments; ``aux`` holds ``y, nu, s,
    optval, status, iterations`` (not differentiable).  Check
    ``aux["status"] == 0``: gradients at a non-optimal iterate inherit its
    residual error, and certificates (infeasible / unbounded) have no
    gradient.  b (m,) and c (n,) may be (batch, m) and (batch, n).

    Cones on the y rows: Zero, NonNeg, NonPos, SOC, SDP (svec rows, as in
    ``ConeSolver(assume_svec=True)``), EXP_PRIMAL and EXP_DUAL.
    """
    Ky = [con if isinstance(con, ConeConstraint) else ConeConstraint(*con) for con in Ky]
    if settings is None:
        settings = SolverSettings(abs_tol=1e-8, rel_tol=1e-8, max_iter=20000)
    if linear_solver not in ("auto", "dense", "gmres"):
        raise ValueError(f"unknown linear_solver {linear_solver!r}")
    key = (tuple((int(con.cone), con.indices) for con in Ky), m, n, settings, strategy,
           linear_solver)
    cached = _DIFF_CONE_CACHE.get(key)
    if cached is not None:
        return cached

    dense = linear_solver == "dense" or (linear_solver == "auto" and m + n <= _DENSE_MAX_DIM)
    layer = _ConeLayer(Ky, m, n, settings, strategy, dense)

    def fn(A, b, c):
        if tuple(A.shape) != (m, n):
            raise ValueError(f"A has shape {tuple(A.shape)}, expected {(m, n)}")
        x, y, nu, s, optval, status, iterations = _DiffConeSolve.apply(
            layer, A, as_param(b, m, A), as_param(c, n, A))
        return x, {"y": y, "nu": nu, "s": s, "optval": optval, "status": status,
                   "iterations": iterations}

    if len(_DIFF_CONE_CACHE) > 32:  # bound long-process growth
        _DIFF_CONE_CACHE.clear()
    _DIFF_CONE_CACHE[key] = fn
    return fn


def diff_cone_solve(A, b, c, Ky, settings=None, device=None, **kw):
    """One-shot differentiable cone solve: min c'x s.t. b − Ax ∈ K_y.

    Returns ``(x, aux)``; see :func:`make_diff_cone_solver`.  The solver
    function is cached per (cone structure, shape, settings).
    """
    A = as_matrix(A, device)
    m, n = A.shape
    return make_diff_cone_solver(Ky, m, n, settings=settings, **kw)(A, b, c)
