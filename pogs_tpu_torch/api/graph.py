"""Graph-form problem builders: lasso, ridge, elastic net, logistic, huber,
SVM, non-negative least squares.

Counterpart of ``pogs_tpu/api/graph.py``: the same FunctionVector
constructions, the same result dict (x, y, l, optval, iterations, status)
and the same defaults (abs_tol 1e-4, rel_tol 1e-4, max_iter 2500, rho 1.0,
adaptive_rho and gap_stop on).  Every builder takes ``device=``: by default
the device of a tensor A, else CUDA; A may be sparse (a scipy matrix or a
sparse tensor), and ``sparse_policy=`` goes on to the solver.
``backend="native"`` solves on the host instead, through the native
runtime (``pogs_tpu_torch.native``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from pogs_tpu_torch.types import Function, FunctionVector, SolverSettings
from pogs_tpu_torch.linalg.matrix import is_sparse_input
from pogs_tpu_torch.solver.graph import GraphFormSolver
from pogs_tpu_torch.utils.profiling import span

# "auto" and "torch" solve on the solver's device; "native" on the host.
BACKENDS = ("auto", "torch", "native")


def solve_graph_form(
    A,
    f: FunctionVector,
    g: FunctionVector,
    abs_tol: float = 1e-4,
    rel_tol: float = 1e-4,
    max_iter: int = 2500,
    verbose: int = 0,
    rho: float = 1.0,
    adaptive_rho: bool = True,
    gap_stop: bool = True,
    use_fused: Optional[bool] = None,
    solver: Optional[GraphFormSolver] = None,
    dtype=None,
    device=None,
    backend: str = "auto",
    **solver_kw,
):
    """Solve min f(y) + g(x) s.t. y = Ax. Returns the reference result dict.

    ``f``/``g`` accept FunctionVector objects or lists of FunctionObj.

    ``backend``: "auto" (default) and "torch" solve on the device (by
    default CUDA; see GraphFormSolver), "native" solves on the host through
    the native runtime's :func:`~pogs_tpu_torch.native.solve_graph_native`
    and marks the result ``out["backend"] = "native"``.  The JAX package's
    "auto" sends small one-shot problems to the native runtime; here "auto"
    stays on the device."""
    with span("pogs.call"):
        if isinstance(f, (list, tuple)):
            f = FunctionVector.from_objs(f, dtype=dtype)
        if isinstance(g, (list, tuple)):
            g = FunctionVector.from_objs(g, dtype=dtype)
        st = SolverSettings(
            abs_tol=abs_tol, rel_tol=rel_tol, rho=rho, max_iter=max_iter,
            verbose=verbose, adaptive_rho=adaptive_rho, gap_stop=gap_stop,
            use_fused=use_fused,
        )
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "native":
            from pogs_tpu_torch.native import solve_graph_native

            t0 = time.perf_counter()
            out = solve_graph_native(A, f, g, settings=st)
            out["status"] = int(out["status"])
            out["solve_time"] = time.perf_counter() - t0
            out["backend"] = "native"
            return out
        if solver is None:
            solver = GraphFormSolver(A, dtype=dtype, settings=st, device=device,
                                     **solver_kw)
        res = solver.solve(f, g, settings=st)
        out = res.as_dict()
        out["solve_time"] = res.solve_time
        return out


def _shape(A):
    """A with its shape: a tensor or a scipy sparse matrix passes through (a
    sparse A reaches GraphFormSolver, which keeps it sparse or densifies it
    by ``sparse_policy``), anything else becomes an ndarray."""
    if isinstance(A, torch.Tensor) or is_sparse_input(A):
        return A, tuple(A.shape)
    A = np.asarray(A)
    return A, A.shape


def _vec(b):
    if isinstance(b, torch.Tensor):
        return b.reshape(-1)
    return np.asarray(b).ravel()


def solve_lasso(A, b, lambd, dtype=None, **kw):
    """minimize 0.5‖Ax − b‖² + λ‖x‖₁."""
    with span("pogs.call"):
        A, (m, n) = _shape(A)
        f = FunctionVector(Function.SQUARE, m, b=_vec(b), dtype=dtype)
        g = FunctionVector(Function.ABS, n, c=lambd, dtype=dtype)
        return solve_graph_form(A, f, g, dtype=dtype, **kw)


def solve_ridge(A, b, lambd, dtype=None, **kw):
    """minimize 0.5‖Ax − b‖² + (λ/2)‖x‖²."""
    with span("pogs.call"):
        A, (m, n) = _shape(A)
        f = FunctionVector(Function.SQUARE, m, b=_vec(b), dtype=dtype)
        g = FunctionVector(Function.SQUARE, n, c=lambd, dtype=dtype)
        return solve_graph_form(A, f, g, dtype=dtype, **kw)


def solve_elastic_net(A, b, lambda1, lambda2, dtype=None, **kw):
    """minimize 0.5‖Ax − b‖² + λ₁‖x‖₁ + (λ₂/2)‖x‖² (e = λ₂, as in the JAX
    package, which documents why it differs from the reference's λ₂/2)."""
    with span("pogs.call"):
        A, (m, n) = _shape(A)
        f = FunctionVector(Function.SQUARE, m, b=_vec(b), dtype=dtype)
        g = FunctionVector(Function.ABS, n, c=lambda1, e=lambda2, dtype=dtype)
        return solve_graph_form(A, f, g, dtype=dtype, **kw)


def solve_logistic(A, b, lambd=0.0, dtype=None, **kw):
    """minimize Σ log(1 + exp(−bᵢ aᵢᵀx)) + λ‖x‖₁."""
    with span("pogs.call"):
        A, (m, n) = _shape(A)
        f = FunctionVector(Function.LOGISTIC, m, a=-_vec(b), dtype=dtype)
        if lambd > 0:
            g = FunctionVector(Function.ABS, n, c=lambd, dtype=dtype)
        else:
            g = FunctionVector(Function.ZERO, n, dtype=dtype)
        return solve_graph_form(A, f, g, dtype=dtype, **kw)


def solve_huber(A, b, delta=1.0, lambd=0.0, dtype=None, **kw):
    """minimize Σ huber_δ(aᵢᵀx − bᵢ) + λ‖x‖₁."""
    with span("pogs.call"):
        A, (m, n) = _shape(A)
        f = FunctionVector(
            Function.HUBER, m, a=1.0 / delta, b=_vec(b) / delta, c=delta * delta,
            dtype=dtype,
        )
        if lambd > 0:
            g = FunctionVector(Function.ABS, n, c=lambd, dtype=dtype)
        else:
            g = FunctionVector(Function.ZERO, n, dtype=dtype)
        return solve_graph_form(A, f, g, dtype=dtype, **kw)


def solve_svm(A, b, lambd=1.0, dtype=None, **kw):
    """minimize Σ max(0, 1 − bᵢ aᵢᵀx) + (λ/2)‖x‖²."""
    with span("pogs.call"):
        A, (m, n) = _shape(A)
        f = FunctionVector(Function.MAXPOS0, m, a=-_vec(b), b=-1.0, dtype=dtype)
        g = FunctionVector(Function.SQUARE, n, c=lambd, dtype=dtype)
        return solve_graph_form(A, f, g, dtype=dtype, **kw)


def solve_nonneg_ls(A, b, dtype=None, **kw):
    """minimize 0.5‖Ax − b‖² s.t. x ≥ 0."""
    with span("pogs.call"):
        A, (m, n) = _shape(A)
        f = FunctionVector(Function.SQUARE, m, b=_vec(b), dtype=dtype)
        g = FunctionVector(Function.INDGE0, n, dtype=dtype)
        return solve_graph_form(A, f, g, dtype=dtype, **kw)
