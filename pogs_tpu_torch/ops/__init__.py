"""Hand-written CUDA kernels and their plain versions."""

from pogs_tpu_torch.ops.fused_admm import fused_admm_loop, fused_admm_loop_ref

__all__ = ["fused_admm_loop", "fused_admm_loop_ref"]
