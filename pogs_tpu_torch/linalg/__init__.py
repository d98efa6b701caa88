"""Linear-algebra substrate (matrix operators, equilibration, norms, CGLS)."""

from pogs_tpu_torch.linalg.matrix import DenseMatrix, SparseMatrix, as_matrix_op
from pogs_tpu_torch.linalg.equil import equilibrate, sinkhorn_knopp, EquilResult
from pogs_tpu_torch.linalg.norm import norm2_est
from pogs_tpu_torch.linalg.cgls import cgls_solve

__all__ = ["DenseMatrix", "SparseMatrix", "as_matrix_op", "equilibrate", "sinkhorn_knopp",
           "EquilResult", "norm2_est", "cgls_solve"]
