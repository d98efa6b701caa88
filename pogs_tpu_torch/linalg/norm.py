"""Spectral-norm estimation by power iteration (MATLAB normest scheme).

Counterpart of ``pogs_tpu/linalg/norm.py``.  The JAX version stops a
``while_loop`` once the relative change falls under ``tol``; here all
``max_iter`` sweeps run and the state freezes (``torch.where``) from the
sweep that passes the test on, which gives the same result with no host
sync per sweep.
"""

from __future__ import annotations

from typing import Optional

import torch

from pogs_tpu_torch.linalg.matrix import matvecs, part, side_sums

NORM_EST_TOL = 1e-4
NORM_EST_MAX_ITER = 50


def norm2_est(A, tol: float = NORM_EST_TOL, max_iter: int = NORM_EST_MAX_ITER,
              seed: int = 0, x0: Optional[torch.Tensor] = None):
    """Estimate ‖A‖₂ by power iteration on AᵀA, through A's products (a
    tensor or a matrix operator).

    ``x0`` is the start vector; without one it is drawn uniformly on [0, 1)
    from a ``torch.Generator`` seeded with ``seed``.  On a sharded operator
    the whole start vector is drawn on every rank, and a rank that holds a
    block of columns takes its part, so the ranks agree; ‖Aᵀ A x‖ and
    ‖A x‖ sum their split side through the operator's ``reduce``.
    """
    m, n = A.shape
    dt, dev = A.dtype, A.device
    amv, armv = matvecs(A)
    if x0 is None:
        gen = torch.Generator().manual_seed(seed)
        x0 = torch.rand(n, generator=gen, dtype=torch.float32)
    x = part(A, "n", x0.to(dtype=dt, device=dev))

    def sweep(x):
        sx = amv(x)
        x = armv(sx)
        normx, = side_sums(A, "n", [("norm", x)])
        norm_sx, = side_sums(A, "m", [("norm", sx)])
        # A zero operator yields ‖A‖₂ = 0, not 0/0 = NaN.
        safe = normx > 0
        x = torch.where(safe, x / torch.where(safe, normx, torch.ones_like(normx)),
                        torch.zeros_like(x))
        est = torch.where(norm_sx > 0, normx / norm_sx, torch.zeros_like(normx))
        return x, est

    # One unconditional first sweep (i = 1), then sweeps while i < max_iter,
    # est > 0 and the relative change is at least tol.
    x, est = sweep(x)
    last = torch.zeros_like(est)
    active = torch.ones((), dtype=torch.bool, device=dev)
    for _ in range(1, max_iter):
        active = active & (est > 0) & (torch.abs(est - last) >= tol * est)
        x_new, est_new = sweep(x)
        x = torch.where(active, x_new, x)
        last = torch.where(active, est, last)
        est = torch.where(active, est_new, est)
    return est
