"""pogs_tpu_torch — the graph-form ADMM solver on PyTorch and CUDA.

The PyTorch port of ``pogs_tpu``, for NVIDIA Hopper GPUs.  It solves
problems in *graph form*

    minimize    f(y) + g(x)       (f, g separable)
    subject to  y = A x

by ADMM with closed-form proximal operators.  On a CUDA device a dense solve
runs as one hand-written CUDA kernel (``ops/fused_admm.py``); elsewhere it
runs as an eager torch loop.  This package imports torch and numpy only.
"""

from pogs_tpu_torch.types import (
    Function,
    FunctionObj,
    FunctionVector,
    Cone,
    Status,
    SolverSettings,
    SolverResult,
)
from pogs_tpu_torch.prox import prox_eval, func_eval, proj_subgrad_eval
from pogs_tpu_torch.solver import GraphFormSolver, admm_solve
from pogs_tpu_torch.api.graph import (
    solve_graph_form,
    solve_lasso,
    solve_ridge,
    solve_elastic_net,
    solve_logistic,
    solve_huber,
    solve_svm,
    solve_nonneg_ls,
)
from pogs_tpu_torch.utils.interop import init_state_from_numpy

__version__ = "0.1.0"

__all__ = [
    "Function",
    "FunctionObj",
    "FunctionVector",
    "Cone",
    "Status",
    "SolverSettings",
    "SolverResult",
    "prox_eval",
    "func_eval",
    "proj_subgrad_eval",
    "GraphFormSolver",
    "admm_solve",
    "solve_graph_form",
    "solve_lasso",
    "solve_ridge",
    "solve_elastic_net",
    "solve_logistic",
    "solve_huber",
    "solve_svm",
    "solve_nonneg_ls",
    "init_state_from_numpy",
]
