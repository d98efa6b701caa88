"""The port's batched front end (``pogs_tpu_torch.parallel``) against
pogs_tpu's, and Anderson acceleration in the eager loop against the JAX
loop, on the CPU (``device="cpu"``).

Both packages get the same numpy-seeded inputs and each runs its own init.
The JAX front end runs its vmapped loop (``use_fused=False``) in float64
and its Pallas kernel in interpret mode (``use_fused=True``) in float32;
the port runs its lane loop (the default on the CPU) and its batched
kernel's plain version (``use_fused=True``).  Per lane, as
tests/test_fused.py holds the Pallas kernel to the vmapped loop: the same
status, the same iteration count (within 2 in float32), x within 2e-3 and
optval within 1e-3 relative.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pogs_tpu.types import Function as JF, FunctionVector as JFV, SolverSettings as JSet
from pogs_tpu.parallel.batch import batched_graph_solve as j_batched, solve_lasso_path as j_path
from pogs_tpu.solver.anderson import anderson_init as j_aa_init, anderson_step as j_aa_step
from pogs_tpu.solver.graph import GraphFormSolver as JSolver

import pogs_tpu_torch as P
import pogs_tpu_torch.parallel.batch as pbatch
from pogs_tpu_torch.parallel import batched_graph_solve, solve_lasso_path
from pogs_tpu_torch.parallel.batch import _fused_batch_eligible
from pogs_tpu_torch.solver.anderson import anderson_init, anderson_step
from pogs_tpu_torch.utils.interop import init_state_from_numpy

torch.set_num_threads(1)

_NP = {"f32": np.float32, "f64": np.float64}
TOL = dict(abs_tol=1e-4, rel_tol=1e-3, gap_stop=False)


def _lasso(seed, m, n):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    return A, b, float(np.max(np.abs(A.T @ b)))


def _case(name, dt):
    """(A, f kwargs, g kwargs, batch kwargs, settings kwargs) of a case of
    tests/test_fused.py's batched tests."""
    if name == "sweep":
        A, b, lam_max = _lasso(0, 100, 60)
        lams = np.geomspace(0.5, 0.1, 10) * lam_max
        return A, {"b": b}, {}, {"g_c_batch": lams}, TOL
    if name == "wide":
        A, b, lam_max = _lasso(11, 40, 90)
        return A, {"b": b}, {}, {"g_c_batch": np.geomspace(0.6, 0.2, 6) * lam_max}, TOL
    if name == "instant":
        A, b, lam_max = _lasso(21, 60, 40)
        lams = np.array([10 * lam_max, 5 * lam_max] + list(np.geomspace(0.5, 0.1, 6) * lam_max))
        return A, {"b": b}, {}, {"g_c_batch": lams}, TOL
    rng = np.random.default_rng(3)
    A = rng.standard_normal((40, 20))
    batch = {"f_b_batch": rng.standard_normal((6, 40))}
    if name == "multi_rhs_ladder":
        batch["g_c_batch"] = np.linspace(0.5, 0.1, 6)
    return A, {}, {"c": 0.3}, batch, dict(abs_tol=1e-5, rel_tol=1e-5)


def _run_both(A, fkw, gkw, batch, stkw, dt, j_fused, p_fused):
    m, n = A.shape
    A = A.astype(dt)
    batch = {k: v.astype(dt) for k, v in batch.items()}
    rj = j_batched(A, JFV(JF.SQUARE, m, dtype=dt, **fkw), JFV(JF.ABS, n, dtype=dt, **gkw),
                   settings=JSet(use_fused=j_fused, **stkw), **batch)
    rp = batched_graph_solve(
        A, P.FunctionVector(P.Function.SQUARE, m, dtype=dt, **fkw),
        P.FunctionVector(P.Function.ABS, n, dtype=dt, **gkw),
        settings=P.SolverSettings(use_fused=p_fused, **stkw), device="cpu", **batch)
    return rj, rp


def _assert_lanes(rj, rp, dtype, optval_atol=0.0):
    np.testing.assert_array_equal(rp["status"].numpy(), np.asarray(rj["status"]))
    it_j, it_p = np.asarray(rj["iterations"]), rp["iterations"].numpy()
    if dtype == "f64":
        np.testing.assert_array_equal(it_p, it_j)
    else:
        assert np.max(np.abs(it_p - it_j)) <= 2
    np.testing.assert_allclose(rp["x"].numpy(), np.asarray(rj["x"]), atol=2e-3)
    np.testing.assert_allclose(rp["optval"].numpy(), np.asarray(rj["optval"]),
                               rtol=1e-3, atol=optval_atol)
    assert rp["y"].shape == np.asarray(rj["y"]).shape


@pytest.mark.parametrize("dtype,case", [
    ("f64", "sweep"), ("f64", "wide"), ("f64", "instant"), ("f64", "multi_rhs"),
    ("f64", "multi_rhs_ladder"), ("f32", "sweep"),
])
def test_batched_graph_solve_matches_jax(dtype, case):
    """f64 against the vmapped loop, f32 against the Pallas kernel; the port
    through its lane loop and through its batched kernel's plain version."""
    dt = _NP[dtype]
    A, fkw, gkw, batch, stkw = _case(case, dt)
    j_fused = dtype == "f32"
    for p_fused in (None, True):
        rj, rp = _run_both(A, fkw, gkw, batch, stkw, dt, j_fused, p_fused)
        _assert_lanes(rj, rp, dtype, optval_atol=1e-4 if case == "instant" else 0.0)
        assert rp["x"].dtype == torch.float64 if dtype == "f64" else torch.float32
    if case == "instant":
        assert float(rp["optval"][0]) > 0.1


def test_warm_lasso_path_matches_jax_scan():
    """The warm λ-path, step for step, against the JAX scan (f64: the same
    iteration counts), through the eager loop and through the solve
    kernel's plain version."""
    A, b, lam_max = _lasso(7, 100, 60)
    lams = np.geomspace(0.5, 0.05, 12) * lam_max
    st = dict(abs_tol=1e-5, rel_tol=1e-5)
    rj = j_path(A, b, lams, settings=JSet(use_fused=False, **st), warm=True)
    for use_fused in (None, True):
        rp = solve_lasso_path(A, b, lams, settings=P.SolverSettings(use_fused=use_fused, **st),
                              warm=True, device="cpu")
        np.testing.assert_array_equal(rp["iterations"].numpy(), np.asarray(rj["iterations"]))
        assert (rp["status"] == 0).all()
        np.testing.assert_allclose(rp["x"].numpy(), np.asarray(rj["x"]), atol=1e-7)
        np.testing.assert_allclose(rp["optval"].numpy(), np.asarray(rj["optval"]), rtol=1e-9)
    # Warm steps after the first are far cheaper than the cold first step.
    assert int(rp["iterations"][1:].max()) < int(rp["iterations"][0])


def test_batch_eligibility():
    """The accept/reject matrix of the batched kernel's selection (the JAX
    package's test_fused_batch_eligibility, with the port's rules: forcing
    raises on a batch the kernel cannot take, float64 is accepted when
    forced, and the default takes it for float32 on CUDA)."""
    forced = P.SolverSettings(use_fused=True)
    f32, f64 = torch.float32, torch.float64

    def ok(dt=f32, device="cuda", st=forced, c_kind="lane_scalar", e_kind="shared",
           fb_kind="shared"):
        return _fused_batch_eligible(dt, torch.device(device), st, c_kind, e_kind, fb_kind)

    assert ok()                                     # λ-sweep
    assert ok(c_kind="lane_vec")
    assert ok(c_kind="shared", fb_kind="lane_vec")  # multi-RHS
    assert ok(c_kind="lane_scalar", fb_kind="lane_vec")
    assert ok(dt=f64)                               # forced: float64 too
    assert ok(device="cpu")                         # forced: the plain version
    for bad in (dict(c_kind="shared"), dict(e_kind="lane_vec"), dict(e_kind="lane_scalar"),
                dict(st=forced.replace(use_anderson=True)),
                dict(st=forced.replace(use_exact_tol=True)),
                dict(st=forced.replace(verbose=2)), dict(dt=torch.float16)):
        with pytest.raises(ValueError):
            ok(**bad)
    auto = P.SolverSettings()
    assert ok(st=auto)
    assert not ok(st=auto, dt=f64)
    assert not ok(st=auto, device="cpu")
    assert not ok(st=auto, e_kind="lane_vec")
    assert not ok(st=auto.replace(use_anderson=True))
    assert not ok(st=P.SolverSettings(use_fused=False))


def test_per_lane_e_takes_the_lane_loop(monkeypatch):
    """A per-lane g.e is not a sweep the batched kernel takes: the lanes run
    one after another (f64: the same iterations as the JAX vmapped loop),
    and forcing the kernel raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("the batched kernel ran")

    monkeypatch.setattr(pbatch, "fused_batched_lasso_sweep", refuse)
    A, b, lam_max = _lasso(4, 50, 30)
    lams = np.linspace(0.3, 0.1, 4) * lam_max
    e_batch = np.linspace(0.0, 0.5, 4)
    kw = {"g_c_batch": lams, "g_e_batch": e_batch}
    rj, rp = _run_both(A, {"b": b}, {}, kw, TOL, np.float64, False, None)
    _assert_lanes(rj, rp, "f64")
    with pytest.raises(ValueError):
        _run_both(A, {"b": b}, {}, kw, TOL, np.float64, False, True)


def test_batched_anderson_runs_the_lane_loop(monkeypatch):
    """use_anderson is not for the kernels: a batched sweep with it runs the
    lane loop, and each lane equals the single solve from a cold start."""
    monkeypatch.setattr(pbatch, "fused_batched_lasso_sweep", None)
    A, b, lam_max = _lasso(5, 40, 20)
    lams = np.array([0.3, 0.1]) * lam_max
    st = P.SolverSettings(use_anderson=True, **TOL)
    rp = batched_graph_solve(A, P.FunctionVector(P.Function.SQUARE, 40, b=b),
                             P.FunctionVector(P.Function.ABS, 20), lams, settings=st,
                             device="cpu")
    for k, lam in enumerate(lams):
        r = P.GraphFormSolver(A, device="cpu", settings=st).solve(
            P.FunctionVector(P.Function.SQUARE, 40, b=b),
            P.FunctionVector(P.Function.ABS, 20, c=lam))
        assert int(rp["iterations"][k]) == int(r.final_iter)
        assert int(rp["status"][k]) == int(r.status) == 0
        np.testing.assert_allclose(rp["x"][k].numpy(), r.x.numpy(), atol=1e-12)


def test_anderson_step_matches_jax(rng):
    """The Anderson step against the JAX package's on a slowly contracting
    linear map (f64), and it accelerates (tests/test_anderson.py)."""
    n = 20
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    M = Q @ np.diag(np.linspace(0.1, 0.97, n)) @ Q.T
    bvec = rng.normal(size=n)
    x_star = np.linalg.solve(np.eye(n) - M, bvec)
    Mt, bt = torch.tensor(M), torch.tensor(bvec)

    x = torch.zeros(n, dtype=torch.float64)
    for _ in range(50):
        x = Mt @ x + bt
    err_plain = float(np.linalg.norm(x.numpy() - x_star))

    xp = torch.zeros(n, dtype=torch.float64)
    xj = jnp.zeros(n, jnp.float64)
    sp, sj = anderson_init(n, 5, torch.float64), j_aa_init(n, 5, jnp.float64)
    for _ in range(50):
        xp, sp = anderson_step(sp, xp, Mt @ xp + bt)
        xj, sj = j_aa_step(sj, xj, jnp.asarray(M) @ xj + jnp.asarray(bvec))
        np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=0, atol=1e-9)
    assert int(sp.k) == int(sj.k) == 50
    assert float(np.linalg.norm(xp.numpy() - x_star)) < err_plain * 1e-3


def test_anderson_solve_matches_jax_loop(rng):
    """use_anderson in the eager loop equals the JAX loop in f64 on
    tests/test_anderson.py's lasso, from the same init state: the same
    iteration count and status, x within 1e-9."""
    m, n = 60, 30
    A = rng.normal(size=(m, n))
    b = rng.normal(size=m)
    lam = 0.2 * np.max(np.abs(A.T @ b))
    jst = JSet(abs_tol=1e-7, rel_tol=1e-7, use_anderson=True)
    js = JSolver(A, dtype=jnp.float64, settings=jst).init()
    init = js._init_state
    ps = P.GraphFormSolver(A, device="cpu",
                           settings=P.SolverSettings(**dataclasses.asdict(jst)))
    ps.load_init_state(init_state_from_numpy({
        "A": np.asarray(init["A"].dense()), "d": np.asarray(init["d"]),
        "e": np.asarray(init["e"]), "norm_A": np.asarray(init["norm_A"]),
        "factor": {"op": np.asarray(init["factor"]["op"])}}, device="cpu"))
    rj = js.solve(JFV(JF.SQUARE, m, b=b), JFV(JF.ABS, n, c=lam))
    rp = ps.solve(P.FunctionVector(P.Function.SQUARE, m, b=b),
                  P.FunctionVector(P.Function.ABS, n, c=lam))
    assert int(rp.final_iter) == int(rj.final_iter)
    assert rp.status == P.Status(int(rj.status)) == P.Status.SUCCESS
    np.testing.assert_allclose(rp.x.numpy(), np.asarray(rj.x), atol=1e-9)
