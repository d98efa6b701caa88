"""Fougner–Boyd matrix equilibration (modified Sinkhorn–Knopp).

Counterpart of ``pogs_tpu/linalg/equil.py``:

  1. B = A ∘ A (2-norm equilibration).
  2. 50 Sinkhorn–Knopp sweeps on B with a regularizing constant, on the
     effective row/column counts, with zero rows/columns pinned to scale 1;
     optional ``constrain_d`` / ``constrain_e`` hooks act on each sweep's
     accumulations (the cone solver averages them within a non-separable
     cone, so the scaling is uniform inside it).
  3. d ← √d, e ← √e; A ← diag(d) · A · diag(e).
  4. Normalize: ‖A‖_F / √min(m,n) = 1, folding √normA into both d and e.

A sparse operator takes the operator path of the JAX package: Sinkhorn on
the view of its elementwise square (``sq_mv``/``sq_rmv``), then ``scale``,
``frob2`` and ``scalar_mul``; nothing is densified.  So does a sharded
operator (``parallel/mesh.py``): its products carry the collectives, the
live-row and live-column counts of the split side are summed through its
``reduce`` hook, and the zero rows that pad a shard stay pinned to scale 1,
inert as every other zero row.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from pogs_tpu_torch.linalg.matrix import DenseMatrix, SparseMatrix, is_sharded, local_shape, side_sums

SINKHORN_CONST = 1e-4
EQUIL_ITERS = 50


@dataclasses.dataclass
class EquilResult:
    """Equilibrated matrix and scalings: A_eq = d[:,None] * A * e[None,:] / normA."""

    A: object
    d: torch.Tensor
    e: torch.Tensor


def sinkhorn_knopp(bm, brm, m: int, n: int, dt, device, iters: int = EQUIL_ITERS,
                   constrain_d: Optional[Callable] = None,
                   constrain_e: Optional[Callable] = None, A=None):
    """Modified Sinkhorn–Knopp on a nonnegative operator (bm = B@, brm = Bᵀ@).

    ``m`` and ``n`` are the lengths of the vectors this rank holds; ``A``,
    a sharded operator, sums the live counts across its shards.

    Alternates e ← m_eff / (Bᵀ d + reg_e) and d ← n_eff / (B e + reg_d).  The
    hooks act on the accumulations after the zero rows and columns are
    pinned to the neutral value, so a cone that holds a zero row (the radius
    row of an SOC ball) still gets one uniform scale.
    """
    row_mass = bm(torch.ones(n, dtype=dt, device=device))
    col_mass = brm(torch.ones(m, dtype=dt, device=device))
    row_live = row_mass > 0
    col_live = col_mass > 0
    m_eff = torch.clamp(side_sums(A, "m", [("sum", row_live.to(dt))])[0], min=1.0)
    n_eff = torch.clamp(side_sums(A, "n", [("sum", col_live.to(dt))])[0], min=1.0)
    reg_e = SINKHORN_CONST * (m_eff + n_eff) / m_eff
    reg_d = SINKHORN_CONST * (m_eff + n_eff) / n_eff

    d = torch.ones(m, dtype=dt, device=device)
    e = torch.ones(n, dtype=dt, device=device)
    cd = constrain_d if constrain_d is not None else (lambda v: v)
    ce = constrain_e if constrain_e is not None else (lambda v: v)
    for _ in range(iters):
        acc_e = torch.where(col_live, brm(d) + reg_e, m_eff)
        e = m_eff / ce(acc_e)
        acc_d = torch.where(row_live, bm(e) + reg_d, n_eff)
        d = n_eff / cd(acc_d)
    return d, e


def equilibrate(A, constrain_d: Optional[Callable] = None,
                constrain_e: Optional[Callable] = None,
                iters: int = EQUIL_ITERS) -> EquilResult:
    """Full equilibration pipeline. ``A`` is a tensor, a DenseMatrix or a
    SparseMatrix; the returned ``EquilResult.A`` is of the same kind."""
    if isinstance(A, SparseMatrix) or is_sharded(A):
        return _equilibrate_op(A, constrain_d, constrain_e, iters)
    is_op = isinstance(A, DenseMatrix)
    At = A.dense() if is_op else A
    m, n = At.shape
    dt = At.dtype
    B = At * At
    d, e = sinkhorn_knopp(lambda v: torch.mv(B, v), lambda v: torch.mv(B.T, v),
                          m, n, dt, At.device, iters, constrain_d, constrain_e)
    d = torch.sqrt(d)
    e = torch.sqrt(e)
    A_eq = At * d[:, None] * e[None, :]
    norm_a = torch.sqrt(torch.sum(A_eq * A_eq)) / torch.sqrt(
        torch.tensor(float(min(m, n)), dtype=dt, device=At.device))
    norm_a = torch.where(norm_a > 0, norm_a, torch.ones_like(norm_a))  # A = 0
    # The operator path multiplies by the reciprocal, as DenseMatrix.scalar_mul
    # does in the JAX package.
    A_eq = A_eq * (1.0 / norm_a) if is_op else A_eq / norm_a
    scale = torch.sqrt(norm_a)
    return EquilResult(A=DenseMatrix(A_eq) if is_op else A_eq,
                       d=d / scale, e=e / scale)


def _equilibrate_op(A, constrain_d, constrain_e, iters) -> EquilResult:
    """The pipeline on an operator: Sinkhorn on A∘A through sq_mv/sq_rmv,
    then A.scale(d, e) normalized by its Frobenius norm."""
    m, n = A.shape
    m_loc, n_loc = local_shape(A)
    dt, dev = A.dtype, A.device
    d, e = sinkhorn_knopp(A.sq_mv, A.sq_rmv, m_loc, n_loc, dt, dev, iters,
                          constrain_d, constrain_e, A=A)
    d = torch.sqrt(d)
    e = torch.sqrt(e)
    A_eq = A.scale(d, e)
    norm_a = torch.sqrt(A_eq.frob2()) / torch.sqrt(
        torch.tensor(float(min(m, n)), dtype=dt, device=dev))
    norm_a = torch.where(norm_a > 0, norm_a, torch.ones_like(norm_a))  # A = 0
    A_eq = A_eq.scalar_mul(1.0 / norm_a)
    scale = torch.sqrt(norm_a)
    return EquilResult(A=A_eq, d=d / scale, e=e / scale)
