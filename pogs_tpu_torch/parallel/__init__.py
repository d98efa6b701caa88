"""Batched solves on one GPU: λ-sweeps, multi-RHS sweeps, warm λ-paths."""

from pogs_tpu_torch.parallel.batch import (
    batched_graph_solve, solve_lasso_path, warm_path_graph_solve,
)

__all__ = ["batched_graph_solve", "solve_lasso_path", "warm_path_graph_solve"]
