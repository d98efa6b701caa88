"""pogs_tpu_torch — the graph-form and cone-form solvers on PyTorch and CUDA.

The PyTorch port of ``pogs_tpu``, for NVIDIA Hopper GPUs.  It solves
problems in *graph form*

    minimize    f(y) + g(x)       (f, g separable)
    subject to  y = A x

by ADMM with closed-form proximal operators, and problems in *cone form*

    minimize    c'x (+ ½ x'Px)
    subject to  b − A x ∈ K_y,   x ∈ K_x

by Douglas–Rachford on the homogeneous self-dual embedding (K_x empty) or
by the graph-form loop with the cone objective; a quadratic objective by
the host IPM or an epigraph SOC through the embedding, with an active-set
polish (``solve_qp``, ``solve_lp``, ``solve_qps`` front the QP and LP
forms; ``diff_*`` are the same solves as differentiable layers, with
implicit gradients).  On a CUDA device a dense
solve runs as one hand-written CUDA kernel (``ops/fused_admm.py`` for the
graph form, ``ops/fused_hsde.py`` for the cone form) and a λ-sweep as
another (``ops/fused_admm_batch.py``); elsewhere they run as eager torch
loops.  ``backend="native"`` solves a graph-form problem on the host
through the native C++ runtime (``pogs_tpu_torch.native``), built from the
checkout's sources at first use.  This package imports torch and numpy
only.
"""

from pogs_tpu_torch.types import (
    Function,
    FunctionObj,
    FunctionVector,
    Cone,
    ConeConstraint,
    Status,
    SolverSettings,
    SolverResult,
    # Reference-spelling function aliases (kAbs = Function.ABS, ...).
    kAbs, kExp, kHuber, kIdentity, kIndBox01, kIndEq0, kIndGe0, kIndLe0,
    kLogistic, kMaxNeg0, kMaxPos0, kNegEntr, kNegLog, kRecipr, kSquare, kZero,
)
from pogs_tpu_torch.cones.sets import ConeSet
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
from pogs_tpu_torch.solver.cone import ConeSolver
from pogs_tpu_torch.api.cone import solve_cone, solve_cone_problem, dims_to_cones, auto_rho
from pogs_tpu_torch.api.qp import solve_lp, solve_qp, solve_qps
from pogs_tpu_torch.parallel.batch import (
    batched_cone_solve, batched_qp_solve, warm_path_cone_solve,
)
# As in the JAX package, the mesh helpers are importable from the package and
# listed in ``parallel.__all__``, not in the package's ``__all__``.
from pogs_tpu_torch.parallel import make_mesh, shard_matrix, replicate  # noqa: F401
from pogs_tpu_torch.api.diff import (
    make_diff_solver,
    diff_lasso,
    diff_ridge,
    diff_elastic_net,
    diff_logistic,
    diff_nonneg_ls,
    diff_qp,
)
from pogs_tpu_torch.api.diff_cone import make_diff_cone_solver, diff_cone_solve
from pogs_tpu_torch.api.cvxpy_interface import (
    pogs_solve,
    detect_graph_form,
    register_solver as register_cvxpy_solver,
    HAS_CVXPY,
)
from pogs_tpu_torch.utils.interop import init_state_from_numpy
from pogs_tpu_torch.utils.profiling import trace, PhaseTimer, device_time
from pogs_tpu_torch.utils.checkpoint import save_state, load_state

__version__ = "0.1.0"

__all__ = [
    "Function",
    "FunctionObj",
    "FunctionVector",
    "Cone",
    "ConeConstraint",
    "ConeSet",
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
    "ConeSolver",
    "solve_cone",
    "solve_cone_problem",
    "dims_to_cones",
    "auto_rho",
    "solve_lp",
    "solve_qp",
    "solve_qps",
    "batched_cone_solve",
    "warm_path_cone_solve",
    "batched_qp_solve",
    "make_diff_solver",
    "diff_lasso",
    "diff_ridge",
    "diff_elastic_net",
    "diff_logistic",
    "diff_nonneg_ls",
    "diff_qp",
    "make_diff_cone_solver",
    "diff_cone_solve",
    "pogs_solve",
    "detect_graph_form",
    "register_cvxpy_solver",
    "HAS_CVXPY",
    "init_state_from_numpy",
    "trace",
    "PhaseTimer",
    "device_time",
    "save_state",
    "load_state",
    "kAbs", "kExp", "kHuber", "kIdentity", "kIndBox01", "kIndEq0",
    "kIndGe0", "kIndLe0", "kLogistic", "kMaxNeg0", "kMaxPos0",
    "kNegEntr", "kNegLog", "kRecipr", "kSquare", "kZero",
]
