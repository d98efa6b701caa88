"""Row-block-sharded sparse operator (a cone-form LP/SOCP with a row-sharded
sparse A).

Counterpart of ``pogs_tpu/parallel/sparse.py``, the explicit plan the JAX
package writes with ``shard_map`` because GSPMD cannot split a sparse
product by rows; here every collective is explicit anyway:

  * storage      — each rank holds one block of rows as a ``SparseMatrix``
                   (CSR of the block and of its transpose) with row ids
                   LOCAL to the block; rows are zero-padded to a multiple of
                   the shard count so the blocks are equal
  * ``A @ x``    — local product, y stays row-sharded (no communication)
  * ``Aᵀ @ y``   — local product + one ``all_reduce`` of length n
  * equilibration scaling — purely local (d is row-sharded, x whole)

The operator is ``parallel/mesh.py``'s ``ShardedMatrix`` over a
``SparseMatrix`` block: the same collectives and hooks (``reduce``,
``gather``, ``local``) as the dense row plan, so the CGLS projector and the
HSDE ``cg`` strategy run on it unchanged.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pogs_tpu_torch.linalg.matrix import SparseMatrix, as_matrix_op, split_bounds
from pogs_tpu_torch.parallel.mesh import Mesh, ShardedMatrix, all_reduce


class ShardedSparseMatrix(ShardedMatrix):
    """One rank's block of rows of a sparse A over a mesh axis: a
    ``ShardedMatrix`` over a ``SparseMatrix`` block, whose gathered form is
    sparse too."""

    def gather_op(self) -> SparseMatrix:
        """The whole A as a single-device ``SparseMatrix`` on every rank (the
        polish): the blocks' coordinates and values in zero-padded buffers,
        summed across the axis."""
        R = self.mesh.size(self.axis)
        k = self.mesh.index(self.axis)
        s = self.block._s
        nnz = torch.zeros(R, dtype=torch.int64, device=self.device)
        nnz[k] = s.rows.numel()
        nnz = all_reduce(nnz, self.group)
        cap = int(nnz.max())
        ij = torch.zeros((2, R, cap), dtype=torch.int64, device=self.device)
        vals = torch.zeros((R, cap), dtype=self.dtype, device=self.device)
        cnt = s.rows.numel()
        ij[0, k, :cnt] = s.rows + self.lo
        ij[1, k, :cnt] = s.cols
        vals[k, :cnt] = self.block.values
        ij = all_reduce(ij, self.group)
        vals = all_reduce(vals, self.group)
        keep = torch.arange(cap, device=self.device)[None, :] < nnz[:, None]
        # Blocks in rank order, each row-major: the whole A's row-major order.
        return SparseMatrix.from_coo(ij[0][keep], ij[1][keep], vals[keep], self.shape)


def shard_sparse(A, mesh: Mesh, axis: str = "rows", dtype=None
                 ) -> Tuple[ShardedSparseMatrix, int]:
    """This rank's block of rows of a scipy sparse matrix (the same on every
    rank) on ``mesh.device``.

    Rows are zero-padded to a multiple of the shard count (zero rows are
    inert in every contracted product).  Returns (operator, m_original):
    callers pad b and add the padded rows to a Zero cone with
    :func:`pad_cone_rows`.
    """
    import scipy.sparse as sp

    mesh.check_axis(axis)
    R = mesh.size(axis)
    A = sp.csr_matrix(A)
    m, n = A.shape
    m_tot = m + (-m) % R
    lo, hi = split_bounds(m_tot, R, mesh.index(axis))
    rows = A[lo:min(hi, m)] if lo < m else sp.csr_matrix((0, n))
    block = sp.vstack([rows, sp.csr_matrix((hi - lo - rows.shape[0], n))]).tocsr()
    dt = dtype
    if dt is None:
        dt = torch.float64
    elif not isinstance(dt, torch.dtype):
        dt = torch.float64 if np.dtype(dt) == np.float64 else torch.float32
    op = as_matrix_op(block, dt, mesh.device)
    return ShardedSparseMatrix(op, "rows", (m_tot, n), mesh, axis), m


def pad_cone_rows(b, cones, m_tot: int):
    """Extend (b, K_y) over padded zero rows: b_pad = 0 on a Zero cone
    (0 − 0·x = 0 ∈ {0}, so padding never affects the solution)."""
    from pogs_tpu_torch.types import Cone, ConeConstraint

    m = len(b)
    if m_tot == m:
        return np.asarray(b), list(cones)
    b_pad = np.zeros(m_tot, np.asarray(b).dtype)
    b_pad[:m] = np.asarray(b)
    return b_pad, list(cones) + [ConeConstraint(Cone.ZERO, range(m, m_tot))]
