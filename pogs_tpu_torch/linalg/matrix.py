"""Dense matrix operator with the contract the solvers consume.

Counterpart of ``pogs_tpu/linalg/matrix.py::DenseMatrix``:

    mv(x)      — A @ x            rmv(y)    — Aᵀ @ y
    sq_mv(v)   — (A∘A) @ v        sq_rmv(v) — (A∘A)ᵀ @ v     (equilibration)
    scale(d,e) — diag(d)·A·diag(e) as a new operator
    frob2()    — ‖A‖_F²           dense()   — the tensor itself
"""

from __future__ import annotations

import torch


class DenseMatrix:
    def __init__(self, A: torch.Tensor):
        self.A = A

    @property
    def shape(self):
        return tuple(self.A.shape)

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def device(self):
        return self.A.device

    @property
    def is_sparse(self):
        return False

    def mv(self, x):
        return torch.mv(self.A, x)

    def rmv(self, y):
        return torch.mv(self.A.T, y)

    def sq_mv(self, v):
        return torch.mv(self.A * self.A, v)

    def sq_rmv(self, v):
        return torch.mv((self.A * self.A).T, v)

    def scale(self, d, e) -> "DenseMatrix":
        return DenseMatrix(self.A * d[:, None] * e[None, :])

    def scalar_mul(self, s) -> "DenseMatrix":
        return DenseMatrix(self.A * s)

    def frob2(self):
        return torch.sum(self.A * self.A)

    def dense(self):
        return self.A
