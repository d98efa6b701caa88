"""Dense linear-algebra substrate (matrix operator, equilibration, norms)."""

from pogs_tpu_torch.linalg.matrix import DenseMatrix
from pogs_tpu_torch.linalg.equil import equilibrate, sinkhorn_knopp, EquilResult
from pogs_tpu_torch.linalg.norm import norm2_est

__all__ = ["DenseMatrix", "equilibrate", "sinkhorn_knopp", "EquilResult", "norm2_est"]
