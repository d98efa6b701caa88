"""CVXPY integration: graph-form fast path + conic solver plugin.

Counterpart of ``pogs_tpu/api/cvxpy_interface.py`` (itself the counterpart
of the reference's python/pogs/cvxpy.py and python/pogs_cvxpy.py).  Two
layers:

  * ``pogs_solve(problem)`` — walks the CVXPY expression tree for the 8
    graph-form patterns (lasso / ridge / elastic net / logistic / huber /
    svm / nonneg-LS / plain LS) and routes them to this package's
    graph-form solvers (on a CUDA device, the solve kernel); anything else
    goes to the conic plugin below, whose errors reach the caller.
  * ``POGS_TPU`` — a cvxpy ``ConicSolver`` subclass registered into
    ``SOLVER_MAP_CONIC`` by :func:`register_solver`, accepting
    zero/nonneg/SOC/PSD/exp cones via the standard SCS-style data, solved
    by this package's ``solve_cone_problem`` (on a CUDA device, the cone
    kernel where eligible).  CVXPY hands PSD rows in svec (√2-scaled)
    convention; we pass ``assume_svec=True`` so the solver skips its own
    scaling.

The detector reads expressions only through ``type(expr).__name__``,
``.args``, ``.is_constant()`` and ``.value``, and ``solve_via_scs_data``
takes a plain data dict, so both work without cvxpy; the rest needs it
(``HAS_CVXPY``).  A solver option ``device`` (e.g. ``"cpu"``) goes on to
the solve; by default it runs on the CUDA device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pogs_tpu_torch.api.graph import (
    solve_lasso, solve_ridge, solve_elastic_net, solve_huber,
    solve_nonneg_ls, solve_graph_form,
)
from pogs_tpu_torch.api.cone import solve_cone_problem
from pogs_tpu_torch.types import Function, FunctionVector, Status

try:
    import cvxpy as cp
    HAS_CVXPY = True
except ImportError:  # pragma: no cover - exercised in cvxpy-less envs
    cp = None
    HAS_CVXPY = False


# ---------------------------------------------------------------------------
# Expression-tree helpers.
# ---------------------------------------------------------------------------

def _tname(expr) -> str:
    return type(expr).__name__


def _is_const(expr) -> bool:
    try:
        return expr.is_constant()
    except Exception:
        return False


def _const_value(expr):
    v = expr.value if hasattr(expr, "value") else expr
    return np.asarray(v)


def _affine_Ab(expr, x):
    """expr == A @ x + k  →  (A, -k) so that expr = A@x - b. None if not."""
    if expr is x:
        n = x.shape[0] if x.shape else 1
        return np.eye(n), np.zeros(n)
    name = _tname(expr)
    if name == "AddExpression":
        lin, const = None, 0.0
        for a in expr.args:
            if _is_const(a):
                const = const + _const_value(a)
            elif lin is None:
                lin = a
            else:
                return None
        if lin is None:
            return None
        got = _affine_Ab(lin, x)
        if got is None:
            return None
        A, b = got
        return A, b - np.broadcast_to(np.asarray(const).ravel(), (A.shape[0],))
    if name in ("MulExpression", "multiply"):
        if len(expr.args) == 2:
            L, R = expr.args
            if R is x and _is_const(L):
                A = _const_value(L)
                if A.ndim == 1:
                    A = np.diag(A) if name == "multiply" else A[None, :]
                return A, np.zeros(A.shape[0])
    if name == "NegExpression":
        got = _affine_Ab(expr.args[0], x)
        if got is None:
            return None
        A, b = got
        return -A, -b
    if name == "Promote" or name == "reshape":
        return _affine_Ab(expr.args[0], x)
    return None


def _split_sum(expr):
    """Flatten a sum expression into a list of terms."""
    if _tname(expr) == "AddExpression":
        out = []
        for a in expr.args:
            out.extend(_split_sum(a))
        return out
    return [expr]


def _scaled(term):
    """term == scale * inner  →  (scale, inner)."""
    if _tname(term) in ("MulExpression", "multiply") and len(term.args) == 2:
        L, R = term.args
        if _is_const(L) and np.size(_const_value(L)) == 1:
            return float(_const_value(L)), R
        if _is_const(R) and np.size(_const_value(R)) == 1:
            return float(_const_value(R)), L
    if _tname(term) == "NegExpression":
        s, inner = _scaled(term.args[0])
        return -s, inner
    return 1.0, term


def _classify_term(term, x):
    """Classify one objective term. Returns (kind, scale, payload) or None.

    kinds: 'sumsq' (0.5-less sum of squares of affine), 'l1', 'l2sq' (on x),
    'logistic', 'huber', 'hinge'.
    """
    scale, inner = _scaled(term)
    name = _tname(inner)

    if name in ("Pnorm", "norm1") or (name == "Pnorm" and getattr(inner, "p", None) == 1):
        p = getattr(inner, "p", 1)
        if p == 1 and inner.args[0] is x:
            return ("l1", scale, None)
        return None
    if name == "QuadOverLin" or name == "sum_squares":
        arg = inner.args[0]
        if arg is x:
            return ("l2sq", scale, None)
        got = _affine_Ab(arg, x)
        if got is not None:
            return ("sumsq", scale, got)
        return None
    if name == "Sum":
        inner2 = inner.args[0]
        n2 = _tname(inner2)
        if n2 == "logistic":
            got = _affine_Ab(inner2.args[0], x)
            if got is not None:
                return ("logistic", scale, got)
        if n2 == "huber":
            got = _affine_Ab(inner2.args[0], x)
            if got is not None:
                return ("huber", scale, (got, float(getattr(inner2, "M", 1.0).value
                                                    if hasattr(getattr(inner2, "M", 1.0), "value")
                                                    else getattr(inner2, "M", 1.0))))
        if n2 in ("maximum", "pos"):
            got = _affine_Ab(inner2.args[0], x)
            if got is not None:
                return ("hinge", scale, got)
        return None
    return None


def detect_graph_form(problem) -> Optional[dict]:
    """AST pattern detection (pogs_cvxpy.py:650-1186). Returns
    {'type': ..., 'params': {...}} or None."""
    if not HAS_CVXPY:
        return None
    try:
        if type(problem.objective).__name__ != "Minimize":
            return None
        variables = problem.variables()
        if len(variables) != 1:
            return None
        x = variables[0]
        if x.ndim > 1:
            return None

        nonneg = False
        for con in problem.constraints:
            if _tname(con) == "NonNeg" and con.args[0] is x:
                nonneg = True
            elif _tname(con) == "Inequality":
                # x >= 0 spelled as 0 <= x
                lhs, rhs = con.args
                if rhs is x and _is_const(lhs) and np.all(_const_value(lhs) == 0):
                    nonneg = True
                else:
                    return None
            else:
                return None

        terms = [_classify_term(t, x) for t in _split_sum(problem.objective.expr)]
        if any(t is None for t in terms):
            return None
        kinds = {}
        for kind, scale, payload in terms:
            if kind in kinds:
                return None
            kinds[kind] = (scale, payload)

        if "sumsq" in kinds:
            s, (A, b) = kinds.pop("sumsq")
            l1 = kinds.pop("l1", None)
            l2 = kinds.pop("l2sq", None)
            if kinds:
                return None
            # normalize: s*||Ax-b||² == 0.5*||A'x-b'||² with A' = sqrt(2s)A
            if s != 0.5:
                A = np.sqrt(2 * s) * A
                b = np.sqrt(2 * s) * b
            base = {"A": A, "b": b}
            if nonneg and l1 is None and l2 is None:
                return {"type": "nonneg_ls", "params": base}
            if nonneg:
                return None
            if l1 is not None and l2 is not None:
                return {"type": "elastic_net",
                        "params": {**base, "lambda1": l1[0], "lambda2": 2 * l2[0]}}
            if l1 is not None:
                return {"type": "lasso", "params": {**base, "lambd": l1[0]}}
            if l2 is not None:
                return {"type": "ridge", "params": {**base, "lambd": 2 * l2[0]}}
            return {"type": "ls", "params": base}
        if "logistic" in kinds and not nonneg:
            s, (A, b) = kinds.pop("logistic")
            if s != 1.0 or np.any(b != 0):
                return None
            l1 = kinds.pop("l1", None)
            if kinds:
                return None
            # A rows encode -b_i a_i': solve_logistic expects (A, labels).
            return {"type": "logistic_raw",
                    "params": {"A": A, "lambd": l1[0] if l1 else 0.0}}
        if "huber" in kinds and not nonneg:
            s, ((A, b), M) = kinds.pop("huber")
            if s != 1.0:
                return None
            l1 = kinds.pop("l1", None)
            if kinds:
                return None
            return {"type": "huber",
                    "params": {"A": A, "b": b, "delta": M,
                               "lambd": l1[0] if l1 else 0.0}}
        if "hinge" in kinds and not nonneg:
            s, (A, b) = kinds.pop("hinge")
            l2 = kinds.pop("l2sq", None)
            if kinds or l2 is None:
                return None
            # hinge rows: max(0, A x - b); svm form needs A = -diag(y)X, b = -1
            if not np.allclose(b, -1.0):
                return None
            return {"type": "svm_raw",
                    "params": {"A": A, "lambd": 2 * l2[0] * (1.0 / s)}}
        return None
    except Exception:
        return None


# ---------------------------------------------------------------------------
# pogs_solve: fast path + fallback (pogs/cvxpy.py:32-92).
# ---------------------------------------------------------------------------

def pogs_solve(problem, abs_tol: float = 1e-4, rel_tol: float = 1e-4,
               max_iter: int = 2500, verbose: int = 0, fallback: bool = True,
               **kw):
    """Solve a CVXPY problem via the graph-form fast path when its structure
    matches; otherwise (``fallback=True``) through the POGS_TPU conic
    plugin, registering it first if needed.  A failure of the plugin's
    solve reaches the caller: nothing retries on another solver."""
    if not HAS_CVXPY:
        raise ImportError("cvxpy is required for pogs_solve")
    det = detect_graph_form(problem)
    common = dict(abs_tol=abs_tol, rel_tol=rel_tol, max_iter=max_iter,
                  verbose=verbose, **kw)
    if det is not None:
        p = det["params"]
        t = det["type"]
        if t == "lasso":
            res = solve_lasso(p["A"], p["b"], p["lambd"], **common)
        elif t == "ridge":
            res = solve_ridge(p["A"], p["b"], p["lambd"], **common)
        elif t == "elastic_net":
            res = solve_elastic_net(p["A"], p["b"], p["lambda1"], p["lambda2"], **common)
        elif t == "nonneg_ls" or t == "ls":
            if t == "nonneg_ls":
                res = solve_nonneg_ls(p["A"], p["b"], **common)
            else:
                res = solve_ridge(p["A"], p["b"], 0.0, **common)
        elif t == "logistic_raw":
            # rows already encode the +/- labels: a = row works with labels=-row
            A = p["A"]
            m, n = A.shape
            f = FunctionVector(Function.LOGISTIC, m)
            g = (FunctionVector(Function.ABS, n, c=p["lambd"]) if p["lambd"] > 0
                 else FunctionVector(Function.ZERO, n))
            res = solve_graph_form(A, f, g, **common)
        elif t == "huber":
            res = solve_huber(p["A"], p["b"], delta=p["delta"], lambd=p["lambd"], **common)
        elif t == "svm_raw":
            A = p["A"]
            m, n = A.shape
            f = FunctionVector(Function.MAXPOS0, m, b=-1.0)
            g = FunctionVector(Function.SQUARE, n, c=p["lambd"])
            res = solve_graph_form(A, f, g, **common)
        else:  # pragma: no cover
            res = None
        if res is not None:
            x = problem.variables()[0]
            x.value = np.asarray(res["x"])
            ok = res["status"] == int(Status.SUCCESS)
            problem._status = "optimal" if ok else "optimal_inaccurate"
            val = float(problem.objective.expr.value)
            problem._value = val
            return val
    if fallback:
        _ensure_registered()
        opts = {"device": kw["device"]} if kw.get("device") is not None else {}
        return problem.solve(solver="POGS_TPU", **opts)
    raise ValueError("problem does not match a POGS graph form")


def _ensure_registered():
    """Register the conic plugin unless cvxpy already has it; raise if it
    cannot be registered."""
    from cvxpy.reductions.solvers.defines import SOLVER_MAP_CONIC
    if "POGS_TPU" not in SOLVER_MAP_CONIC and not register_solver():
        raise RuntimeError("could not register the POGS_TPU conic solver")


# ---------------------------------------------------------------------------
# Conic solver plugin (pogs_cvxpy.py:1280-1476).
# ---------------------------------------------------------------------------

def _scs_dims_to_dict(cone_dims) -> dict:
    return {
        "f": getattr(cone_dims, "zero", 0),
        "l": getattr(cone_dims, "nonneg", getattr(cone_dims, "nonpos", 0)),
        "q": list(getattr(cone_dims, "soc", []) or []),
        "s": list(getattr(cone_dims, "psd", []) or []),
        "ep": getattr(cone_dims, "exp", 0),
        "ed": 0,
    }


def solve_via_scs_data(data, solver_opts: dict, verbose: bool = False):
    """Solve an SCS-convention conic data dict and return the SCS 3.x
    result-dict contract that cvxpy's ``SCS.invert()`` consumes.

    Standalone (no cvxpy import) so the full plugin solve contract is
    testable against recorded data dicts in environments without cvxpy
    (tests/test_torch_cvxpy_plugin_contract.py); the POGS_TPU ConicSolver
    subclass delegates here.  ``data["dims"]`` may be a cvxpy ConeDims
    object or a plain SCS dims dict.
    """
    dims = data["dims"]
    if not isinstance(dims, dict):
        dims = _scs_dims_to_dict(dims)
    A = data["A"]
    if hasattr(A, "toarray") and A.shape[0] * A.shape[1] <= 4_000_000:
        A = A.toarray()
    out = solve_cone_problem(
        data["c"], A, data["b"], dims,
        P=data.get("P"),
        abs_tol=solver_opts.get("abs_tol", 1e-4),
        rel_tol=solver_opts.get("rel_tol", 1e-4),
        max_iter=solver_opts.get("max_iter", 2500),
        verbose=1 if verbose else 0,
        assume_svec=True,
        device=solver_opts.get("device"),
    )

    # Mimic the SCS result dict that SCS.invert() expects.  cvxpy's
    # scs_conif.STATUS_MAP keys on SCS 3.x status_val integers:
    # 1 solved, 2 solved-inaccurate, -1 infeasible, -2 unbounded,
    # -4 failed.
    status_str = {
        int(Status.SUCCESS): "solved",
        int(Status.MAX_ITER): "solved (inaccurate - reached max_iters)",
        int(Status.INFEASIBLE): "infeasible",
        int(Status.UNBOUNDED): "unbounded",
    }
    status_val = {
        int(Status.SUCCESS): 1,
        int(Status.MAX_ITER): 2,
        int(Status.INFEASIBLE): -1,
        int(Status.UNBOUNDED): -2,
    }
    return {
        "x": out["x"],
        "y": out["l"],
        "s": out["s"],
        "info": {
            "status": status_str.get(out["status"], "failure"),
            "status_val": status_val.get(out["status"], -4),
            "iter": out["num_iters"],
            "pobj": out["optval"],
            "dobj": out["optval"],
            "solve_time": out["solve_time"] * 1e3,
            "setup_time": 0.0,
        },
    }


def make_solver_class():
    """Build the cvxpy ConicSolver subclass (deferred so importing this
    module never requires cvxpy)."""
    from cvxpy.reductions.solvers.conic_solvers.scs_conif import SCS

    class POGS_TPU(SCS):
        """Conic plugin reusing SCS's data conditioning (same cone format)."""

        MIP_CAPABLE = False

        def name(self):
            return "POGS_TPU"

        def import_solver(self):
            import pogs_tpu_torch  # noqa: F401

        def solve_via_data(self, data, warm_start, verbose, solver_opts,
                           solver_cache=None):
            return solve_via_scs_data(data, solver_opts, verbose)

    return POGS_TPU


def register_solver() -> bool:
    """Register POGS_TPU into cvxpy's conic solver registry.

    Returns True on success. After this, ``problem.solve(solver="POGS_TPU")``
    works.
    """
    if not HAS_CVXPY:
        return False
    try:
        from cvxpy.reductions.solvers.defines import (
            SOLVER_MAP_CONIC, CONIC_SOLVERS, INSTALLED_SOLVERS,
        )
        base = make_solver_class()
        # Register under both names: POGS_TPU, and POGS for drop-in
        # compatibility with code written against the reference.  Each
        # entry's name() reports its own key (cvxpy dispatches on it).
        for name in ("POGS_TPU", "POGS"):
            solver_cls = type(name, (base,),
                              {"name": (lambda self, _n=name: _n)})
            SOLVER_MAP_CONIC[name] = solver_cls()
            if name not in CONIC_SOLVERS:
                CONIC_SOLVERS.append(name)
            if name not in INSTALLED_SOLVERS:
                INSTALLED_SOLVERS.append(name)
        return True
    except Exception:
        return False
