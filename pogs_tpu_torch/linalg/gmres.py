"""Restarted GMRES on a matrix-free operator.

The semantics of ``jax.scipy.sparse.linalg.gmres`` with
``solve_method="batched"``, which the JAX package's differentiable layers
call: each restart builds a ``restart``-dimensional Krylov basis by Arnoldi
with two classical Gram–Schmidt passes, then solves the least-squares
problem on the Hessenberg matrix through its normal equations.  The run
stops when ‖b − A x‖ ≤ max(tol·‖b‖, atol) or after ``maxiter`` restarts.

The residual norm is read on the host once per restart and never inside
the Arnoldi process: a breakdown there (a Krylov vector of norm below
eps times its norm before orthogonalization) freezes the remaining steps by
masks, as JAX's loop stops at it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _safe_normalize(x, thresh=None):
    """(x / ‖x‖, ‖x‖), or (0, 0) where ‖x‖ ≤ thresh (default eps)."""
    nrm = torch.linalg.vector_norm(x)
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = nrm > thresh
    safe = torch.where(use, nrm, torch.ones_like(nrm))
    return (torch.where(use, x / safe, torch.zeros_like(x)),
            torch.where(use, nrm, torch.zeros_like(nrm)))


def _restart(matvec, b, x0, unit_residual, residual_norm, restart: int):
    """One restart: the Krylov basis V, the Hessenberg H, and the update."""
    n = b.shape[0]
    dt, dev = b.dtype, b.device
    eps = torch.finfo(dt).eps
    V = torch.zeros((n, restart + 1), dtype=dt, device=dev)
    V[:, 0] = unit_residual
    H = torch.eye(restart, restart + 1, dtype=dt, device=dev)
    broken = torch.zeros((), dtype=torch.bool, device=dev)
    for k in range(restart):
        v = matvec(V[:, k])
        v_norm_0 = torch.linalg.vector_norm(v)
        h = torch.zeros(restart + 1, dtype=dt, device=dev)
        for _ in range(2):  # "twice is enough"
            proj = V.T @ v
            v = v - V @ proj
            h = h + proj
        unit_v, v_norm_1 = _safe_normalize(v, eps * v_norm_0)
        h[k + 1] = v_norm_1
        V[:, k + 1] = torch.where(broken, V[:, k + 1], unit_v)
        H[k] = torch.where(broken, H[k], h)
        broken = broken | (v_norm_1 == 0)
    beta = torch.zeros(restart + 1, dtype=dt, device=dev)
    beta[0] = residual_norm
    # Least squares min ‖Hᵀy − β‖ by its normal equations (H Hᵀ is SPD).
    y = torch.cholesky_solve((H @ beta)[:, None], torch.linalg.cholesky(H @ H.T))[:, 0]
    x = x0 + V[:, :-1] @ y
    return x, *_safe_normalize(b - matvec(x))


def gmres(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None, *,
          tol: float = 1e-5, atol: float = 0.0, restart: int = 20,
          maxiter: Optional[int] = None):
    """Solve A x = b for a linear ``matvec`` (x ↦ A x) by restarted GMRES.

    Returns (x, info): info is 0, or −1 when x holds a NaN.  ``maxiter``
    counts restarts (10·len(b) if None), as in JAX.
    """
    x = torch.zeros_like(b) if x0 is None else x0
    restart = min(restart, b.shape[0])
    if maxiter is None:
        maxiter = 10 * b.shape[0]
    b_norm = float(torch.linalg.vector_norm(b))
    stop = max(tol * b_norm, atol)
    unit_residual, residual_norm = _safe_normalize(b - matvec(x))
    k = 0
    while k < maxiter and float(residual_norm) > stop:  # one host read per restart
        x, unit_residual, residual_norm = _restart(matvec, b, x, unit_residual,
                                                   residual_norm, restart)
        k += 1
    gmres.restarts = k
    info = -1 if bool(torch.isnan(torch.linalg.vector_norm(x))) else 0
    return x, info


gmres.restarts = 0
