"""Indirect (CGLS) graph projector, for sparse or very large A.

Counterpart of ``pogs_tpu/projector/indirect.py``: the warm-started delta
formulation — solve

    minimize ‖A Δx − (y0 − A x0)‖² + s ‖Δx‖²

by CGLS (numerically stabler than CG on the normal equations), then
x = x0 + Δx, y = A x.  The tolerance is the residual-tied one the ADMM loop
passes, and the warm start its previous x.  A sharded operator's split side
sums through its ``reduce`` inside CGLS.
"""

from __future__ import annotations

import torch

from pogs_tpu_torch.linalg.cgls import cgls_solve
from pogs_tpu_torch.linalg.matrix import matvecs


class CglsProjector:
    def __init__(self, max_iter: int = 500):
        self.max_iter = max_iter

    def init(self, A, s=1.0):
        return {"s": torch.tensor(s, dtype=A.dtype, device=A.device)}

    def project(self, A, factor, x0, y0, tol, x_warm=None):
        """Project (x0, y0) onto {(x, y) : y = A x}; A a tensor or an operator."""
        matvec, rmatvec = matvecs(A)
        b = y0 - matvec(x0)
        dx0 = (x_warm - x0) if x_warm is not None else torch.zeros_like(x0)
        dx, _ = cgls_solve(matvec, rmatvec, b, dx0, factor["s"], tol, self.max_iter,
                           A=A if hasattr(A, "rmv") else None)
        x = x0 + dx
        return x, matvec(x)
