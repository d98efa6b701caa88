"""Direct (factorization-based) graph projector.

Counterpart of ``pogs_tpu/projector/direct.py``: form the Gram matrix of the
smaller dimension once, factor (G + sI) once, then each projection is a
handful of matvecs.

    m ≥ n (tall):  x = (AᵀA + sI)⁻¹ (s·x0 + Aᵀy0),        y = A x
    m < n (wide):  w = (AAᵀ + sI)⁻¹ (A x0 − y0),
                   x = x0 − Aᵀ w,                          y = y0 + s·w

``method='inverse'`` (the default, and what the fused solve kernel consumes)
keeps the explicit SPD inverse L⁻ᵀL⁻¹; ``method='cholesky'`` keeps L and
solves two triangular systems per projection.  The Gram, the factor and the
inverse are library calls made once at init.

On a sharded operator (``parallel/mesh.py``) the Gram is the all-reduced
local Gram (``gram``), the factor is whole on every rank, and a projection
takes the operator's ``mv`` and ``rmv`` with their collectives; where the
Gram's side is the split one (a mismatched plan) the right-hand side is
gathered and each rank keeps its part of the solve.
"""

from __future__ import annotations

import torch

from pogs_tpu_torch.linalg.matrix import is_sharded, part, whole


def _as_dense(A):
    return A.dense() if hasattr(A, "dense") else A


class DirectProjector:
    """``init`` returns the factor dict; ``project`` is a function of it."""

    def __init__(self, method: str = "inverse"):
        if method not in ("inverse", "cholesky"):
            raise ValueError(f"unknown direct method {method!r}")
        self.method = method

    def init(self, A, s=1.0):
        """Factor (G + sI). Returns {"op": inverse or L, "s": s}."""
        m, n = A.shape
        if is_sharded(A):
            G = A.gram("n" if m >= n else "m")
        else:
            A = _as_dense(A)
            G = A.T @ A if m >= n else A @ A.T
        k = G.shape[0]
        K = G + s * torch.eye(k, dtype=A.dtype, device=A.device)
        L = torch.linalg.cholesky(K)
        if self.method == "inverse":
            eye = torch.eye(k, dtype=A.dtype, device=A.device)
            Linv = torch.linalg.solve_triangular(L, eye, upper=False)
            op = Linv.T @ Linv
        else:
            op = L
        return {"op": op, "s": torch.tensor(s, dtype=A.dtype, device=A.device)}

    def _solve(self, factor, rhs):
        if self.method == "inverse":
            return torch.mv(factor["op"], rhs)
        return torch.cholesky_solve(rhs[:, None], factor["op"], upper=False)[:, 0]

    def project(self, A, factor, x0, y0, tol=None, x_warm=None):
        """Project (x0, y0) onto {(x, y) : y = A x}. tol/x_warm unused here."""
        if is_sharded(A):
            return self._project_sharded(A, factor, x0, y0)
        A = _as_dense(A)
        m, n = A.shape
        s = factor["s"]
        if m >= n:
            rhs = s * x0 + torch.mv(A.T, y0)
            x = self._solve(factor, rhs)
            y = torch.mv(A, x)
        else:
            rhs = torch.mv(A, x0) - y0
            w = self._solve(factor, rhs)
            x = x0 - torch.mv(A.T, w)
            y = y0 + s * w
        return x, y

    def _project_sharded(self, A, factor, x0, y0):
        m, n = A.shape
        s = factor["s"]
        if m >= n:
            rhs = s * x0 + A.rmv(y0)
            x = part(A, "n", self._solve(factor, whole(A, "n", rhs)))
            return x, A.mv(x)
        rhs = A.mv(x0) - y0
        w = part(A, "m", self._solve(factor, whole(A, "m", rhs)))
        return x0 - A.rmv(w), y0 + s * w
