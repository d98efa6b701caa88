"""Hand-written CUDA kernels and their plain versions."""

from pogs_tpu_torch.ops.fused_admm import fused_admm_loop, fused_admm_loop_ref
from pogs_tpu_torch.ops.fused_hsde import fused_hsde_solve, fused_hsde_solve_ref

__all__ = ["fused_admm_loop", "fused_admm_loop_ref", "fused_hsde_solve",
           "fused_hsde_solve_ref"]
