"""The slice as a whole: the port's builders and GraphFormSolver against
pogs_tpu's, on the CPU (device="cpu").

With each package's own init the power-method start vectors differ
(torch.Generator vs jax.random), so ‖A‖₂ may differ within the estimate's
tolerance: the same status, iterations within 2, optval within 1e-4
relative, x within 1e-9 (float64) or 2e-5 (float32; 5e-5 for logistic).
With the JAX init state loaded (``load_init_state``) the float64 solve is
held strictly: the same iteration count and x within 1e-9.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pogs_tpu.api.graph as Japi
from pogs_tpu.solver.graph import GraphFormSolver as JSolver
from pogs_tpu.types import (Function as JF, FunctionVector as JFV,
                            SolverSettings as JSet)
import pogs_tpu_torch as P
import pogs_tpu_torch.api.graph as Papi
from pogs_tpu_torch.utils.interop import init_state_from_numpy

torch.set_num_threads(1)

_RNG = np.random.default_rng(3)
M, N = 60, 40
A0 = _RNG.standard_normal((M, N))
B0 = _RNG.standard_normal(M)
LAB = np.sign(_RNG.standard_normal(M))
LAM = 0.2 * float(np.max(np.abs(A0.T @ B0)))

BUILDERS = {
    "lasso": lambda api, A, **k: api.solve_lasso(A, B0, LAM, **k),
    "ridge": lambda api, A, **k: api.solve_ridge(A, B0, 1.0, **k),
    "elastic_net": lambda api, A, **k: api.solve_elastic_net(A, B0, LAM, 0.5, **k),
    "logistic": lambda api, A, **k: api.solve_logistic(A, LAB, 0.3, **k),
    "huber": lambda api, A, **k: api.solve_huber(A, B0, 1.0, 0.1, **k),
    "svm": lambda api, A, **k: api.solve_svm(A, LAB, 1.0, **k),
    "nonneg_ls": lambda api, A, **k: api.solve_nonneg_ls(A, B0, **k),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(BUILDERS))
def test_builder_matches(name, dtype):
    A = A0.astype(dtype)
    rj = BUILDERS[name](Japi, A, dtype=dtype)
    rp = BUILDERS[name](Papi, A, dtype=dtype, device="cpu")
    assert rp["status"] == rj["status"] == int(P.Status.SUCCESS)
    assert abs(rp["iterations"] - rj["iterations"]) <= 2
    assert rp["optval"] == pytest.approx(rj["optval"], rel=1e-4)
    assert rp["x"].dtype == dtype
    if dtype == np.float64:
        atol = 1e-9
    else:
        atol = 5e-5 if name == "logistic" else 2e-5
    np.testing.assert_allclose(rp["x"], rj["x"], atol=atol)


def _export(js):
    init = js._init_state
    return init_state_from_numpy({
        "A": np.asarray(init["A"].dense()), "d": np.asarray(init["d"]),
        "e": np.asarray(init["e"]), "norm_A": np.asarray(init["norm_A"]),
        "factor": {"op": np.asarray(init["factor"]["op"])},
    }, device="cpu")


@pytest.mark.parametrize("method", ["inverse", "cholesky"])
def test_load_init_state_strict_f64(method):
    st = JSet(abs_tol=1e-6, rel_tol=1e-6, use_fused=False)
    js = JSolver(A0, dtype=jnp.float64, direct_method=method, settings=st).init()
    ps = P.GraphFormSolver(A0, device="cpu", direct_method=method,
                           settings=P.SolverSettings(abs_tol=1e-6, rel_tol=1e-6))
    ps.load_init_state(_export(js))
    assert ps.dtype == torch.float64
    f_j = JFV(JF.SQUARE, M, b=B0)
    g_j = JFV(JF.ABS, N, c=LAM)
    f_p = P.FunctionVector(P.Function.SQUARE, M, b=B0)
    g_p = P.FunctionVector(P.Function.ABS, N, c=LAM)
    for kw in ({}, {"rho": 2.0}):
        rj = js.solve(f_j, g_j, **kw)
        rp = ps.solve(f_p, g_p, **kw)
        assert int(rp.final_iter) == int(rj.final_iter)
        assert rp.status == P.Status(int(rj.status))
        for key in ("x", "y", "mu", "nu"):
            np.testing.assert_allclose(getattr(rp, key).numpy(),
                                       np.asarray(getattr(rj, key)), atol=1e-9)
        assert float(rp.rho) == pytest.approx(float(rj.rho), rel=1e-12)


def test_x_init_nu_init_and_exact_tol_strict_f64():
    st = JSet(use_exact_tol=True, max_iter=300, use_fused=False)
    js = JSolver(A0, dtype=jnp.float64, settings=st).init()
    ps = P.GraphFormSolver(A0, device="cpu", settings=P.SolverSettings(
        use_exact_tol=True, max_iter=300))
    ps.load_init_state(_export(js))
    x_init = np.linspace(-0.1, 0.1, N)
    nu_init = np.linspace(0.2, -0.2, M)
    f_j, g_j = JFV(JF.SQUARE, M, b=B0), JFV(JF.ABS, N, c=LAM)
    f_p = P.FunctionVector(P.Function.SQUARE, M, b=B0)
    g_p = P.FunctionVector(P.Function.ABS, N, c=LAM)
    rj = js.solve(f_j, g_j, x_init=x_init, nu_init=nu_init)
    rp = ps.solve(f_p, g_p, x_init=x_init, nu_init=nu_init)
    assert int(rp.final_iter) == int(rj.final_iter)
    assert rp.status == P.Status(int(rj.status))
    np.testing.assert_allclose(rp.x.numpy(), np.asarray(rj.x), atol=1e-9)


def test_solver_front_end_contract():
    with pytest.raises(ValueError):
        P.GraphFormSolver(A0, device="cpu").solve(
            P.FunctionVector(P.Function.SQUARE, M - 1), P.FunctionVector(P.Function.ABS, N))
    # Anderson acceleration runs in the eager loop (the kernels refuse it).
    r = P.GraphFormSolver(A0, device="cpu").solve(
        P.FunctionVector(P.Function.SQUARE, M, b=B0), P.FunctionVector(P.Function.ABS, N, c=LAM),
        settings=P.SolverSettings(use_anderson=True))
    assert r.status == P.Status.SUCCESS
    # A sparse tensor stays sparse on the CPU and takes the CGLS projector.
    sparse = P.GraphFormSolver(torch.eye(3, dtype=torch.float64).to_sparse(), device="cpu")
    assert sparse.A.is_sparse and sparse.projector == "cgls"
    with pytest.raises(ValueError):
        P.GraphFormSolver(A0, device="cpu", projector="nope")
    # dtype follows the input: float64 numpy -> float64, float32 -> float32.
    assert P.GraphFormSolver(A0, device="cpu").dtype == torch.float64
    assert P.GraphFormSolver(A0.astype(np.float32), device="cpu").dtype == torch.float32
    # A tensor input sets the device when none is given.
    assert P.GraphFormSolver(torch.tensor(A0)).device.type == "cpu"
    r = P.admm_solve(torch.tensor(A0), P.FunctionVector(P.Function.SQUARE, M, b=B0),
                     P.FunctionVector(P.Function.ABS, N, c=LAM))
    assert r.status == P.Status.SUCCESS
