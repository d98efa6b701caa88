"""The port's public surface against the JAX package's, and where its entry
points run by default.

Every public name of ``pogs_tpu`` but ``SolverState`` (the JAX loop-state
pytree; the port's loop returns a dict) is a public name of
``pogs_tpu_torch``, every submodule of ``pogs_tpu`` has its counterpart in
the port with the same public names (the exceptions listed with their
reasons), and importing the port loads neither JAX nor the JAX package.  Every entry point, given numpy inputs and no ``device``, puts its
work on the CUDA device: where torch has no CUDA (this CPU machine) each
one raises torch's "not compiled with CUDA" error before it returns a
result, instead of solving on the CPU.  The scan skips on a machine with a
card, where the same calls would solve.
"""

import importlib
import inspect
import os
import pkgutil
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import pogs_tpu
import pogs_tpu_torch as P
from pogs_tpu_torch.api.cvxpy_interface import solve_via_scs_data
from pogs_tpu_torch.parallel import (
    batched_graph_solve, solve_lasso_path, warm_path_graph_solve,
)
from pogs_tpu_torch.utils.interop import init_state_from_numpy

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_public_names_match_the_jax_package():
    jax_names = {n for n in dir(pogs_tpu) if not n.startswith("_")}
    assert jax_names - set(dir(P)) == {"SolverState"}
    assert set(pogs_tpu.__all__) - set(P.__all__) == {"SolverState"}
    for name in P.__all__:
        assert hasattr(P, name), name


# Public names of a JAX submodule that its counterpart lacks, each with the
# reason.
SUBMODULE_EXCEPTIONS = {
    ("pogs_tpu.solver", "SolverState"): "a JAX loop-state pytree; the port's loops keep dicts",
    ("pogs_tpu.solver.admm", "LoopState"): "a JAX loop-state pytree",
    ("pogs_tpu.solver.hsde", "HsdeState"): "a JAX loop-state pytree",
    ("pogs_tpu.solver.hsde", "cg_solve_normal"):
        "the packed-vector CG the JAX tests call; the port's CG works on split "
        "(x, y, τ) tuples (cg_solve_normal_split)",
    ("pogs_tpu.ops", "fused_admm_eligible"): "the Pallas kernel's VMEM gate; K1's plan is admm_plan",
    ("pogs_tpu.ops.fused_admm", "fused_admm_eligible"):
        "the Pallas kernel's VMEM gate; K1's plan is admm_plan",
    ("pogs_tpu.ops", "pad_to"): "the TPU lane padding of the Pallas kernels",
    ("pogs_tpu.ops.fused_admm", "pad_to"): "the TPU lane padding of the Pallas kernels",
    ("pogs_tpu.ops", "fused_hsde_eligible"):
        "TPU-only in this form (with its VMEM budget); the port's gate of the same "
        "name, without it, is ops.fused_hsde.fused_hsde_eligible",
    ("pogs_tpu.ops.fused_admm_batch", "batched_chunk_for"):
        "the Pallas kernel's VMEM lane budget; K2's are chunk_for and cluster_plan",
}


def _defined_public(mod) -> set:
    """The public names a module defines itself: its ``__all__``, the
    functions and classes whose ``__module__`` is the module, and the names
    it assigns at top level."""
    src = inspect.getsource(mod)
    names = set(getattr(mod, "__all__", ()))
    for name in dir(mod):
        val = getattr(mod, name)
        if name.startswith("_") or isinstance(val, types.ModuleType):
            continue
        if inspect.isclass(val) or inspect.isfunction(val):
            if val.__module__ == mod.__name__:
                names.add(name)
        elif re.search(rf"^{re.escape(name)}\s*(:[^=\n]*)?=", src, re.M):
            names.add(name)
    return names


def test_every_submodule_has_its_public_names():
    missing = []
    for info in pkgutil.walk_packages(pogs_tpu.__path__, "pogs_tpu."):
        jax_mod = importlib.import_module(info.name)
        port = importlib.import_module("pogs_tpu_torch" + info.name[len("pogs_tpu"):])
        missing += [(info.name, n) for n in sorted(_defined_public(jax_mod))
                    if not hasattr(port, n)]
    assert set(missing) == set(SUBMODULE_EXCEPTIONS), (
        sorted(set(missing) - set(SUBMODULE_EXCEPTIONS)),
        sorted(set(SUBMODULE_EXCEPTIONS) - set(missing)))


ALIASES = ["kAbs", "kExp", "kHuber", "kIdentity", "kIndBox01", "kIndEq0", "kIndGe0",
           "kIndLe0", "kLogistic", "kMaxNeg0", "kMaxPos0", "kNegEntr", "kNegLog",
           "kRecipr", "kSquare", "kZero"]


@pytest.mark.parametrize("name", ALIASES)
def test_reference_spelling_aliases(name):
    alias = getattr(P, name)
    assert isinstance(alias, P.Function)
    assert int(alias) == int(getattr(pogs_tpu, name))
    assert alias.name == getattr(pogs_tpu, name).name


def test_import_loads_no_jax():
    code = ("import sys, pogs_tpu_torch; "
            "assert 'jax' not in sys.modules and 'pogs_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def test_solve_graph_form_takes_backend():
    sig = inspect.signature(P.solve_graph_form)
    assert sig.parameters["backend"].default == "auto"
    assert "backend" in inspect.signature(pogs_tpu.solve_graph_form).parameters


# ---- the CPU-default scan -------------------------------------------------------

_RNG = np.random.default_rng(0)
A = _RNG.standard_normal((12, 6))
B = _RNG.standard_normal(12)
C = _RNG.standard_normal(6)
LAB = np.sign(_RNG.standard_normal(12))
LP_A = np.vstack([np.eye(6), -np.eye(6)])
LP_B = np.ones(12)
QP_P = np.eye(6)
NONNEG = [P.ConeConstraint(P.Cone.NON_NEG, range(12))]


def _fv():
    return (P.FunctionVector(P.Function.SQUARE, 12, b=B),
            P.FunctionVector(P.Function.ABS, 6, c=0.1))


ENTRY_POINTS = {
    "solve_graph_form": lambda: P.solve_graph_form(A, *_fv()),
    "solve_lasso": lambda: P.solve_lasso(A, B, 0.1),
    "solve_ridge": lambda: P.solve_ridge(A, B, 0.1),
    "solve_elastic_net": lambda: P.solve_elastic_net(A, B, 0.1, 0.1),
    "solve_logistic": lambda: P.solve_logistic(A, LAB, 0.1),
    "solve_huber": lambda: P.solve_huber(A, B),
    "solve_svm": lambda: P.solve_svm(A, LAB),
    "solve_nonneg_ls": lambda: P.solve_nonneg_ls(A, B),
    "GraphFormSolver": lambda: P.GraphFormSolver(A),
    "admm_solve": lambda: P.admm_solve(A, *_fv()),
    "ConeSolver": lambda: P.ConeSolver(LP_A, Ky=NONNEG),
    "solve_cone": lambda: P.solve_cone(LP_A, LP_B, C, Ky=NONNEG),
    "solve_cone_problem": lambda: P.solve_cone_problem(C, LP_A, LP_B, {"l": 12}),
    "solve_via_scs_data": lambda: solve_via_scs_data(
        {"c": C, "A": LP_A, "b": LP_B, "dims": {"l": 12}}, {}),
    "solve_lp": lambda: P.solve_lp(C, G=LP_A, h=LP_B),
    "solve_qp": lambda: P.solve_qp(QP_P, C, G=A, h=np.abs(B) + 1.0),
    "solve_qps": lambda: P.solve_qps(os.path.join(ROOT, "tests", "data", "HS21.QPS")),
    "batched_graph_solve": lambda: batched_graph_solve(A, *_fv(), g_c_batch=np.ones(3)),
    "warm_path_graph_solve": lambda: warm_path_graph_solve(A, *_fv(), np.ones(3)),
    "solve_lasso_path": lambda: solve_lasso_path(A, B, [0.1, 0.2]),
    "batched_cone_solve": lambda: P.batched_cone_solve(LP_A, np.ones((2, 12)), C, NONNEG),
    "warm_path_cone_solve": lambda: P.warm_path_cone_solve(LP_A, np.ones((2, 12)), C, NONNEG),
    "batched_qp_solve": lambda: P.batched_qp_solve(LP_A, QP_P, np.ones((2, 12)), C, NONNEG),
    "diff_lasso": lambda: P.diff_lasso(A, B, 0.1),
    "diff_ridge": lambda: P.diff_ridge(A, B, 0.1),
    "diff_elastic_net": lambda: P.diff_elastic_net(A, B, 0.1, 0.1),
    "diff_logistic": lambda: P.diff_logistic(A, LAB, 0.1),
    "diff_nonneg_ls": lambda: P.diff_nonneg_ls(A, B),
    "diff_qp": lambda: P.diff_qp(QP_P, C, G=A, h=np.abs(B) + 1.0),
    "diff_cone_solve": lambda: P.diff_cone_solve(LP_A, LP_B, C, NONNEG),
    "init_state_from_numpy": lambda: init_state_from_numpy(
        {"A": A, "d": B, "e": C, "norm_A": 1.0, "factor": {"op": np.eye(6)}}),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_defaults_to_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the call would solve on it")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        ENTRY_POINTS[name]()


def test_scan_covers_every_solving_entry_point():
    """Each public callable of the port that solves or sets up a solve is in
    the scan (types, prox evaluators, helpers, the cvxpy-only entry points and
    the profiling / checkpoint utilities excepted)."""
    not_solvers = {
        "Function", "FunctionObj", "FunctionVector", "Cone", "ConeConstraint", "ConeSet",
        "Status", "SolverSettings", "SolverResult", "prox_eval", "func_eval",
        "proj_subgrad_eval", "dims_to_cones", "auto_rho", "make_diff_solver",
        "make_diff_cone_solver", "pogs_solve", "detect_graph_form", "register_cvxpy_solver",
        "trace", "PhaseTimer", "device_time", "save_state", "load_state",
    }
    callables = {n for n in P.__all__ if callable(getattr(P, n)) and not n.startswith("k")}
    assert callables - not_solvers - set(ENTRY_POINTS) == set()
