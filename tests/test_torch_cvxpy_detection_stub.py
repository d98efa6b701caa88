"""cvxpy-free tests of the port's graph-form pattern detector
(``pogs_tpu_torch.api.cvxpy_interface``), mirroring
tests/test_cvxpy_detection_stub.py.

``detect_graph_form`` inspects expressions purely through
``type(expr).__name__`` / ``.args`` / ``.is_constant()`` / ``.value``, so
the full decision tree is exercisable with stub AST node classes that carry
cvxpy's type names — no cvxpy import required.  Every detection is also
held to the JAX package's detector on the same stub problem: the same
pattern and exactly the same parameters (or None for both).

Covers every pattern the reference detects (pogs_cvxpy.py:650-1186):
ls / lasso / ridge / elastic_net / nonneg_ls / logistic / huber / svm,
plus the reject paths (multiple variables, Maximize, foreign constraints,
duplicated terms).
"""

import numpy as np
import pytest
import torch

import pogs_tpu.api.cvxpy_interface as jci
import pogs_tpu_torch.api.cvxpy_interface as ci

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# Stub cvxpy AST. Class NAMES matter: the detector dispatches on
# type(expr).__name__.
# ---------------------------------------------------------------------------

class _Node:
    def __init__(self, *args):
        self.args = list(args)

    def is_constant(self):
        return False


class Variable(_Node):
    def __init__(self, n):
        super().__init__()
        self.shape = (n,)
        self.ndim = 1


class Constant(_Node):
    def __init__(self, value):
        super().__init__()
        self.value = np.asarray(value)

    def is_constant(self):
        return True


class AddExpression(_Node):
    pass


class MulExpression(_Node):
    pass


class NegExpression(_Node):
    pass


class QuadOverLin(_Node):
    """cvxpy's sum_squares lowers to quad_over_lin."""


class Pnorm(_Node):
    def __init__(self, arg, p=1):
        super().__init__(arg)
        self.p = p


class Sum(_Node):
    pass


class logistic(_Node):  # noqa: N801 - cvxpy atom names are lowercase
    pass


class huber(_Node):  # noqa: N801
    def __init__(self, arg, M=1.0):
        super().__init__(arg)
        self.M = M


class maximum(_Node):  # noqa: N801
    pass


class NonNeg(_Node):
    pass


class Inequality(_Node):
    pass


class Minimize:
    def __init__(self, expr):
        self.expr = expr


class Maximize:
    def __init__(self, expr):
        self.expr = expr


class Problem:
    def __init__(self, objective, constraints=(), variables=None):
        self.objective = objective
        self.constraints = list(constraints)
        self._vars = variables or []

    def variables(self):
        return self._vars


@pytest.fixture(autouse=True)
def _force_detection(monkeypatch):
    """detect_graph_form early-outs on HAS_CVXPY; the stub AST needs none
    of cvxpy itself, so force the flag (in both packages) for the duration
    of each test."""
    monkeypatch.setattr(ci, "HAS_CVXPY", True)
    monkeypatch.setattr(jci, "HAS_CVXPY", True)


def _detect(prob):
    """The port's detection, held to the JAX package's on the same problem."""
    got = ci.detect_graph_form(prob)
    ref = jci.detect_graph_form(prob)
    if ref is None:
        assert got is None
        return got
    assert got is not None and got["type"] == ref["type"]
    assert set(got["params"]) == set(ref["params"])
    for key, val in ref["params"].items():
        np.testing.assert_array_equal(got["params"][key], val)
    return got


def _mk_data(m=8, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n)), rng.standard_normal(m)


def _residual(A, b, x):
    """Stub for (A @ x - b) as cvxpy builds it: Add(Mul(A, x), Const(-b))."""
    return AddExpression(MulExpression(Constant(A), x), Constant(-b))


def _sumsq(expr):
    return QuadOverLin(expr)


def _scaled_term(scale, node):
    return MulExpression(Constant(scale), node)


# ------------------------------------------------------------------ patterns

def test_detect_plain_ls():
    A, b = _mk_data()
    x = Variable(5)
    prob = Problem(Minimize(_scaled_term(0.5, _sumsq(_residual(A, b, x)))),
                   variables=[x])
    got = _detect(prob)
    assert got is not None and got["type"] == "ls"
    np.testing.assert_allclose(got["params"]["A"], A)
    np.testing.assert_allclose(got["params"]["b"], b)


def test_detect_lasso():
    A, b = _mk_data()
    x = Variable(5)
    obj = AddExpression(
        _scaled_term(0.5, _sumsq(_residual(A, b, x))),
        _scaled_term(0.3, Pnorm(x, p=1)),
    )
    got = _detect(Problem(Minimize(obj), variables=[x]))
    assert got is not None and got["type"] == "lasso"
    assert got["params"]["lambd"] == pytest.approx(0.3)
    np.testing.assert_allclose(got["params"]["A"], A)


def test_detect_lasso_unnormalized_scale():
    """s·‖Ax−b‖² with s≠0.5 folds √(2s) into A and b."""
    A, b = _mk_data()
    x = Variable(5)
    obj = AddExpression(
        _scaled_term(1.0, _sumsq(_residual(A, b, x))),
        _scaled_term(0.3, Pnorm(x, p=1)),
    )
    got = _detect(Problem(Minimize(obj), variables=[x]))
    assert got is not None and got["type"] == "lasso"
    np.testing.assert_allclose(got["params"]["A"], np.sqrt(2.0) * A)
    np.testing.assert_allclose(got["params"]["b"], np.sqrt(2.0) * b)


def test_detect_ridge():
    A, b = _mk_data()
    x = Variable(5)
    obj = AddExpression(
        _scaled_term(0.5, _sumsq(_residual(A, b, x))),
        _scaled_term(0.35, _sumsq(x)),  # (λ/2)‖x‖² with λ = 0.7
    )
    got = _detect(Problem(Minimize(obj), variables=[x]))
    assert got is not None and got["type"] == "ridge"
    assert got["params"]["lambd"] == pytest.approx(0.7)


def test_detect_elastic_net():
    A, b = _mk_data()
    x = Variable(5)
    obj = AddExpression(
        _scaled_term(0.5, _sumsq(_residual(A, b, x))),
        _scaled_term(0.3, Pnorm(x, p=1)),
        _scaled_term(0.2, _sumsq(x)),
    )
    got = _detect(Problem(Minimize(obj), variables=[x]))
    assert got is not None and got["type"] == "elastic_net"
    assert got["params"]["lambda1"] == pytest.approx(0.3)
    assert got["params"]["lambda2"] == pytest.approx(0.4)


def test_detect_nonneg_ls():
    A, b = _mk_data()
    x = Variable(5)
    prob = Problem(Minimize(_scaled_term(0.5, _sumsq(_residual(A, b, x)))),
                   constraints=[NonNeg(x)], variables=[x])
    got = _detect(prob)
    assert got is not None and got["type"] == "nonneg_ls"


def test_detect_nonneg_ls_via_inequality():
    """x ≥ 0 spelled as Inequality(0, x)."""
    A, b = _mk_data()
    x = Variable(5)
    prob = Problem(Minimize(_scaled_term(0.5, _sumsq(_residual(A, b, x)))),
                   constraints=[Inequality(Constant(np.zeros(5)), x)],
                   variables=[x])
    got = _detect(prob)
    assert got is not None and got["type"] == "nonneg_ls"


def test_detect_logistic():
    A, _ = _mk_data()
    x = Variable(5)
    obj = AddExpression(
        Sum(logistic(MulExpression(Constant(A), x))),
        _scaled_term(0.1, Pnorm(x, p=1)),
    )
    got = _detect(Problem(Minimize(obj), variables=[x]))
    assert got is not None and got["type"] == "logistic_raw"
    assert got["params"]["lambd"] == pytest.approx(0.1)
    np.testing.assert_allclose(got["params"]["A"], A)


def test_detect_logistic_no_reg():
    A, _ = _mk_data()
    x = Variable(5)
    obj = Sum(logistic(MulExpression(Constant(A), x)))
    got = _detect(Problem(Minimize(obj), variables=[x]))
    assert got is not None and got["type"] == "logistic_raw"
    assert got["params"]["lambd"] == 0.0


def test_detect_huber():
    A, b = _mk_data()
    x = Variable(5)
    obj = Sum(huber(_residual(A, b, x), M=1.5))
    got = _detect(Problem(Minimize(obj), variables=[x]))
    assert got is not None and got["type"] == "huber"
    assert got["params"]["delta"] == pytest.approx(1.5)
    np.testing.assert_allclose(got["params"]["b"], b)


def test_detect_svm():
    A, _ = _mk_data()
    x = Variable(5)
    # hinge rows max(0, Ax + 1) → affine b = -1; plus (λ/2)‖x‖², λ = 1.0
    hinge_affine = AddExpression(MulExpression(Constant(A), x),
                                 Constant(np.ones(8)))
    obj = AddExpression(
        Sum(maximum(hinge_affine)),
        _scaled_term(0.5, _sumsq(x)),
    )
    got = _detect(Problem(Minimize(obj), variables=[x]))
    assert got is not None and got["type"] == "svm_raw"
    assert got["params"]["lambd"] == pytest.approx(1.0)


# -------------------------------------------------------------- reject paths

def test_reject_maximize():
    A, b = _mk_data()
    x = Variable(5)
    prob = Problem(Maximize(_scaled_term(0.5, _sumsq(_residual(A, b, x)))),
                   variables=[x])
    assert _detect(prob) is None


def test_reject_two_variables():
    A, b = _mk_data()
    x, z = Variable(5), Variable(3)
    prob = Problem(Minimize(_scaled_term(0.5, _sumsq(_residual(A, b, x)))),
                   variables=[x, z])
    assert _detect(prob) is None


def test_reject_foreign_constraint():
    A, b = _mk_data()
    x = Variable(5)

    class Equality(_Node):
        pass

    prob = Problem(Minimize(_scaled_term(0.5, _sumsq(_residual(A, b, x)))),
                   constraints=[Equality(x, Constant(np.ones(5)))],
                   variables=[x])
    assert _detect(prob) is None


def test_reject_duplicate_terms():
    A, b = _mk_data()
    x = Variable(5)
    obj = AddExpression(
        _scaled_term(0.3, Pnorm(x, p=1)),
        _scaled_term(0.2, Pnorm(x, p=1)),
        _scaled_term(0.5, _sumsq(_residual(A, b, x))),
    )
    assert _detect(Problem(Minimize(obj), variables=[x])) is None


def test_reject_nonneg_with_l1():
    A, b = _mk_data()
    x = Variable(5)
    obj = AddExpression(
        _scaled_term(0.5, _sumsq(_residual(A, b, x))),
        _scaled_term(0.3, Pnorm(x, p=1)),
    )
    prob = Problem(Minimize(obj), constraints=[NonNeg(x)], variables=[x])
    assert _detect(prob) is None


def test_reject_unknown_atom():
    x = Variable(5)

    class exp_atom(_Node):
        pass

    prob = Problem(Minimize(Sum(exp_atom(x))), variables=[x])
    assert _detect(prob) is None


def test_detector_is_none_without_cvxpy(monkeypatch):
    """The public entry point must stay silent when cvxpy truly is absent."""
    monkeypatch.setattr(ci, "HAS_CVXPY", False)
    monkeypatch.setattr(jci, "HAS_CVXPY", False)
    A, b = _mk_data()
    x = Variable(5)
    prob = Problem(Minimize(_scaled_term(0.5, _sumsq(_residual(A, b, x)))),
                   variables=[x])
    assert _detect(prob) is None


# ------------------------------------------- pogs_solve's conic route (stubs)

class _SolvingProblem(Problem):
    """A problem no graph form matches, whose ``solve`` records its
    keywords and raises ``error`` when one is given."""

    def __init__(self, error=None):
        x = Variable(5)

        class exp_atom(_Node):
            pass

        super().__init__(Minimize(Sum(exp_atom(x))), variables=[x])
        self.error = error
        self.calls = []

    def solve(self, **kw):
        self.calls.append(kw)
        if self.error is not None:
            raise self.error
        return 1.5


@pytest.fixture
def conic_registry(monkeypatch):
    """A stand-in for cvxpy's solver registry, so the conic route runs
    without cvxpy: ``register_solver`` adds POGS_TPU to it."""
    import sys
    import types
    defines = types.ModuleType("cvxpy.reductions.solvers.defines")
    defines.SOLVER_MAP_CONIC = {}
    for name in ("cvxpy", "cvxpy.reductions", "cvxpy.reductions.solvers"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, defines.__name__, defines)
    registered = []

    def register():
        registered.append(True)
        defines.SOLVER_MAP_CONIC["POGS_TPU"] = object()
        return True

    monkeypatch.setattr(ci, "register_solver", register)
    return defines.SOLVER_MAP_CONIC, registered


def test_pogs_solve_conic_route_registers_then_solves(conic_registry):
    registry, registered = conic_registry
    prob = _SolvingProblem()
    assert ci.pogs_solve(prob, device="cpu") == 1.5
    assert registered == [True] and "POGS_TPU" in registry
    assert prob.calls == [{"solver": "POGS_TPU", "device": "cpu"}]
    # Registered once: a second solve goes straight to the plugin.
    ci.pogs_solve(prob)
    assert registered == [True]
    assert prob.calls[-1] == {"solver": "POGS_TPU"}


def test_pogs_solve_plugin_failure_reaches_caller(conic_registry):
    """A failure inside the plugin (a kernel that does not build or
    launch, a solve that raises) is not retried on another solver."""
    prob = _SolvingProblem(error=RuntimeError("cone kernel failed"))
    with pytest.raises(RuntimeError, match="cone kernel failed"):
        ci.pogs_solve(prob)
    assert prob.calls == [{"solver": "POGS_TPU"}]


def test_pogs_solve_unregistrable_plugin_raises(conic_registry, monkeypatch):
    monkeypatch.setattr(ci, "register_solver", lambda: False)
    prob = _SolvingProblem()
    with pytest.raises(RuntimeError, match="could not register"):
        ci.pogs_solve(prob)
    assert prob.calls == []


def test_pogs_solve_without_fallback_rejects(conic_registry):
    prob = _SolvingProblem()
    with pytest.raises(ValueError, match="does not match"):
        ci.pogs_solve(prob, fallback=False)
    assert prob.calls == []
