"""Meshes, sharded problems and batched solves: λ-sweeps, multi-RHS sweeps,
warm λ-paths, and batched and warm-path cone and QP solves."""

from pogs_tpu_torch.parallel.mesh import make_mesh, shard_matrix, replicate
from pogs_tpu_torch.parallel.batch import (
    batched_cone_solve, batched_graph_solve, batched_qp_solve, solve_lasso_path,
    warm_path_cone_solve, warm_path_graph_solve,
)

__all__ = ["make_mesh", "shard_matrix", "replicate",
           "batched_graph_solve", "solve_lasso_path", "warm_path_graph_solve",
           "batched_cone_solve", "warm_path_cone_solve", "batched_qp_solve"]
