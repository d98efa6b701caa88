"""The port's HSDE cone solve against pogs_tpu's, on the same seeded inputs.

* ``fused_hsde_solve_ref`` (the plain version of the CUDA cone kernel, which
  ``fused_hsde_solve`` runs on a CPU tensor) against the Pallas kernel
  ``pogs_tpu.ops.fused_hsde.fused_hsde_solve(interpret=True)`` on the seven
  cases of tests/test_fused_hsde.py, from the same SMW factor;
* ``hsde_solve`` (smw and direct, the LP Cholesky polish, Anderson, both
  certificates) against the JAX loop.

Tolerances:
  * float64: the same status and iteration count, w within 1e-9;
  * float32: the same status, iterations within 2 (torch's CPU BLAS and XLA
    sum in other orders), w within 2e-5.

The JAX exponential-cone projection unrolls 6 × 50 bisection steps, and
compiling it inside a solve loop takes a minute or more on the CPU.  Here
the JAX package's ``project_exp_primal`` is compiled once on its own (for 50
and for 80 steps) and called through ``jax.pure_callback`` from the XLA loop
and from the Pallas kernel in place of its copy of the same algorithm
(``_exp_primal_project``; tests/test_fused_hsde.py holds the two equal).
The arithmetic is the JAX package's; the compile takes seconds.
"""

import os
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pogs_tpu.types import Cone as JC, ConeConstraint as JCC, Status as JS
from pogs_tpu.cones.sets import ConeSet as JSet
import pogs_tpu.cones.sets as j_sets
import pogs_tpu.ops.fused_hsde as j_fh
from pogs_tpu.solver.hsde import hsde_solve as j_hsde, smw_setup as j_smw

import pogs_tpu_torch as P
from pogs_tpu_torch.cones.sets import ConeSet
from pogs_tpu_torch.ops import fused_hsde as pf
from pogs_tpu_torch.solver.hsde import hsde_solve

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NP = {"f32": np.float32, "f64": np.float64}
_T = {"f32": torch.float32, "f64": torch.float64}


def _by_callback(fn, default_iters):
    """``fn(v, iters)`` compiled on its own, called through pure_callback."""
    jitted = jax.jit(fn, static_argnums=1)

    def call(v, bisect_iters=default_iters):
        def host(x):
            return np.asarray(jitted(jnp.asarray(x), bisect_iters))

        return jax.pure_callback(host, jax.ShapeDtypeStruct(v.shape, v.dtype), v)

    return call


@pytest.fixture(scope="module", autouse=True)
def _jax_exp_by_callback():
    saved = (j_fh._exp_primal_project, j_sets.project_exp_primal, j_sets.project_exp_dual)
    loop_proj = _by_callback(j_sets.project_exp_primal, 50)
    j_fh._exp_primal_project = loop_proj
    j_sets.project_exp_primal = loop_proj
    j_sets.project_exp_dual = lambda v, bisect_iters=80: v + loop_proj(-v, bisect_iters)
    try:
        yield
    finally:
        j_fh._exp_primal_project, j_sets.project_exp_primal, j_sets.project_exp_dual = saved


def _cases():
    """The seven cases of tests/test_fused_hsde.py: (A, b, c, cones, tol,
    max_iter)."""
    out = {}
    out["lp"] = (np.array([[1.0, 1.0], [-1.0, 0.0], [0.0, -1.0]]), np.array([1.0, 0.0, 0.0]),
                 np.array([1.0, 2.0]), [(JC.ZERO, [0]), (JC.NON_NEG, [1, 2])], 1e-6, 2000)
    rng = np.random.default_rng(5)
    n = 9
    x0, c = rng.standard_normal(n), rng.standard_normal(n)
    out["socp"] = (np.vstack([np.zeros((1, n)), -np.eye(n)]), np.concatenate([[1.5], -x0]),
                   c, [(JC.SOC, range(n + 1))], 1e-6, 5000)
    A2 = rng.standard_normal((3, 8))
    out["wide"] = (A2, A2 @ rng.standard_normal(8), A2.T @ rng.standard_normal(3),
                   [(JC.ZERO, range(3))], 1e-6, 5000)
    out["infeasible"] = (np.array([[-1.0], [1.0]]), np.array([-1.0, 0.0]), np.array([1.0]),
                         [(JC.NON_NEG, [0, 1])], 1e-6, 5000)
    out["unbounded"] = (np.array([[-1.0]]), np.array([0.0]), np.array([-1.0]),
                        [(JC.NON_NEG, [0])], 1e-6, 5000)
    out["exp"] = (np.array([[-1.0], [0.0], [0.0]]), np.array([0.0, 1.0, float(np.e)]),
                  np.array([-1.0]), [(JC.EXP_PRIMAL, [0, 1, 2])], 1e-6, 5000)
    rng = np.random.default_rng(17)
    n = 4
    x0, c = rng.standard_normal(n), rng.standard_normal(n)
    A_exp = np.zeros((3, n))
    A_exp[0, 0] = -1.0
    A_nn = rng.standard_normal((2, n))
    A = np.vstack([np.zeros((1, n)), -np.eye(n), A_exp, A_nn])
    b = np.concatenate([[2.0], -x0, [0.0, 1.0, float(np.e)], A_nn @ x0 + 2.0])
    out["mixed"] = (A, b, c, [(JC.SOC, range(n + 1)), (JC.EXP_PRIMAL, [n + 1, n + 2, n + 3]),
                              (JC.NON_NEG, [n + 4, n + 5])], 1e-6, 8000)
    return out


CASES = _cases()
_STATUS = {"infeasible": JS.INFEASIBLE, "unbounded": JS.UNBOUNDED}


def _sets(cones, m):
    return (JSet([JCC(k, i) for k, i in cones], m),
            ConeSet([P.ConeConstraint(int(k), i) for k, i in cones], m))


def _t(v, dt):
    return torch.tensor(np.asarray(v), dtype=_T[dt])


def _assert_w(ref_w, out_w, ref, out, dt):
    assert int(ref["status"]) == int(out["status"])
    it_r, it_o = int(ref["final_iter"]), int(out["final_iter"])
    if dt == "f64":
        assert it_r == it_o
        atol = 1e-9
    else:
        assert abs(it_r - it_o) <= 2
        atol = 2e-5
    np.testing.assert_allclose(out_w, ref_w, atol=atol)


@pytest.mark.parametrize("dt,name", [("f64", k) for k in CASES]
                         + [("f32", k) for k in ("lp", "socp", "infeasible")])
def test_plain_version_matches_pallas_kernel(dt, name):
    A, b, c, cones, tol, max_iter = CASES[name]
    m, n = A.shape
    npdt = _NP[dt]
    Aj, bj, cj = (jnp.asarray(v, npdt) for v in (A, b, c))
    J, K = _sets(cones, m)
    fac = j_smw(Aj, bj, cj)
    # Wide: the kernels take the m×m (I + AAᵀ)⁻¹ and apply Woodbury.
    Kinv = fac["Kinv"] if m >= n else jnp.linalg.inv(jnp.eye(m, dtype=npdt) + Aj @ Aj.T)
    ref = j_fh.fused_hsde_solve(Aj, bj, cj, J, Kinv, fac["t_x"], fac["t_y"], fac["s_den"],
                                tol, tol, max_iter, interpret=True)
    before = pf.fused_hsde_solve.launches
    out = pf.fused_hsde_solve(_t(A, dt), _t(b, dt), _t(c, dt), K, _t(Kinv, dt),
                              _t(fac["t_x"], dt), _t(fac["t_y"], dt), _t(fac["s_den"], dt),
                              tol, tol, max_iter)
    assert pf.fused_hsde_solve.launches == before  # the plain version: no launch
    _assert_w(np.asarray(ref["w"]), out["w"].numpy(), ref, out, dt)
    np.testing.assert_allclose(out["u"].numpy(), np.asarray(ref["u"]),
                               atol=1e-9 if dt == "f64" else 2e-5)
    assert int(out["status"]) == int(_STATUS.get(name, JS.SUCCESS))


def _lp(seed=0, m=60, n=20):
    rng = np.random.default_rng(seed)
    A = np.vstack([rng.standard_normal((m, n)), np.eye(n), -np.eye(n)])
    b = A @ rng.standard_normal(n) + rng.random(A.shape[0]) + 0.1
    return A, b, rng.standard_normal(n), [(JC.NON_NEG, range(A.shape[0]))]


def _mixed_lp_socp(seed=3):
    """Zero + NonNeg + NonPos + SOC rows and a free row."""
    rng = np.random.default_rng(seed)
    n = 6
    x0 = rng.standard_normal(n)
    A = rng.standard_normal((16, n))
    s = np.concatenate([[0.0, 0.0], np.abs(rng.standard_normal(4)) + 0.2,
                        -np.abs(rng.standard_normal(3)) - 0.2, [3.0],
                        0.3 * rng.standard_normal(5), [rng.standard_normal()]])
    b = A @ x0 + s
    cones = [(JC.ZERO, [0, 1]), (JC.NON_NEG, range(2, 6)), (JC.NON_POS, range(6, 9)),
             (JC.SOC, range(9, 15))]
    return A, b, rng.standard_normal(n), cones


@pytest.mark.parametrize("case,kw", [
    ("mixed", {"strategy": "smw"}),
    ("mixed", {"strategy": "direct"}),
    ("lp_polish", {"polish": True}),
    ("infeasible", {}),
    ("unbounded", {}),
    ("mixed_max_iter", {"max_iter": 7}),
])
def test_hsde_solve_matches_jax_loop(case, kw):
    if case.startswith("mixed"):
        A, b, c, cones = _mixed_lp_socp()
    elif case.startswith("lp"):
        A, b, c, cones = _lp()
    else:
        A, b, c, cones, _, _ = CASES[case]
    kw = {"abs_tol": 1e-7, "rel_tol": 1e-7, "max_iter": 5000, **kw}
    J, K = _sets(cones, A.shape[0])
    ref = j_hsde(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c), J, **kw)
    out = hsde_solve(_t(A, "f64"), _t(b, "f64"), _t(c, "f64"), K, **kw)
    _assert_w(np.asarray(ref["w"]), out["w"].numpy(), ref, out, "f64")
    for key in ("u", "r_pri", "r_dua", "gap", "fp_resid"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-9)
    if case == "lp_polish":
        # The burst at iteration 250 certifies the LP.
        assert int(out["status"]) == 0 and int(out["final_iter"]) == 250
    if case == "mixed_max_iter":
        assert int(out["status"]) == int(JS.MAX_ITER) and int(out["final_iter"]) == 7
    if case in _STATUS:
        assert int(out["status"]) == int(_STATUS[case])


def test_hsde_anderson_matches_jax_loop():
    """Anderson's mixing weights come from a Cholesky solve of a nearly
    singular Gram (regularized by 1e-10), which amplifies the roundoff
    differences of the two BLAS: the same status and iteration count, w
    within 1e-6."""
    A, b, c, cones = _lp()
    J, K = _sets(cones, A.shape[0])
    kw = {"abs_tol": 1e-5, "rel_tol": 1e-5, "max_iter": 3000, "use_anderson": True}
    ref = j_hsde(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c), J, **kw)
    out = hsde_solve(_t(A, "f64"), _t(b, "f64"), _t(c, "f64"), K, **kw)
    assert int(out["status"]) == int(ref["status"]) == 0
    assert int(out["final_iter"]) == int(ref["final_iter"])
    np.testing.assert_allclose(out["w"].numpy(), np.asarray(ref["w"]), atol=1e-6)


def test_hsde_warm_start_matches_jax():
    A, b, c, cones = _mixed_lp_socp()
    J, K = _sets(cones, A.shape[0])
    kw = {"abs_tol": 1e-7, "rel_tol": 1e-7, "max_iter": 5000}
    cold = hsde_solve(_t(A, "f64"), _t(b, "f64"), _t(c, "f64"), K, **kw)
    u0 = cold["u"].numpy()
    b2 = b * (1 + 1e-2)
    ref = j_hsde(jnp.asarray(A), jnp.asarray(b2), jnp.asarray(c), J, u0=jnp.asarray(u0), **kw)
    out = hsde_solve(_t(A, "f64"), _t(b2, "f64"), _t(c, "f64"), K, u0=torch.tensor(u0), **kw)
    _assert_w(np.asarray(ref["w"]), out["w"].numpy(), ref, out, "f64")
    assert int(out["final_iter"]) < int(cold["final_iter"])


def test_embedding_operators_match_jax():
    """Q and Qᵀ (packed), the SMW factor and solve, and I + Q."""
    from pogs_tpu.solver.hsde import (make_q_matvec as j_q, smw_solve as j_smw_solve,
                                      dense_q as j_dense_q)
    from pogs_tpu_torch.solver.hsde import make_q_matvec, smw_setup, smw_solve, dense_q

    A, b, c, _ = _mixed_lp_socp()
    m, n = A.shape
    u = np.random.default_rng(9).standard_normal(n + m + 1)
    Aj, bj, cj, uj = (jnp.asarray(v) for v in (A, b, c, u))
    At, bt, ct, ut = (torch.tensor(v) for v in (A, b, c, u))
    for mine, ref in zip(make_q_matvec(At, bt, ct), j_q(Aj, bj, cj)):
        np.testing.assert_allclose(mine(ut).numpy(), np.asarray(ref(uj)), atol=1e-12)
    fac, jfac = smw_setup(At, bt, ct), j_smw(Aj, bj, cj)
    for key in ("Kinv", "t_x", "t_y", "s_den"):
        np.testing.assert_allclose(fac[key].numpy(), np.asarray(jfac[key]), atol=1e-12)
    w = smw_solve(fac, At, bt, ct, ut)
    np.testing.assert_allclose(w.numpy(), np.asarray(j_smw_solve(jfac, Aj, bj, cj, uj)),
                               atol=1e-12)
    M = dense_q(At, bt, ct)
    np.testing.assert_allclose(M.numpy(), np.asarray(j_dense_q(Aj, bj, cj)), atol=0)
    np.testing.assert_allclose((M @ w).numpy(), u, atol=1e-10)  # w = (I + Q)⁻¹ u


def _psd(n, kind, seed=12):
    """A dense PSD P, or a diagonal one as a dense matrix."""
    rng = np.random.default_rng(seed)
    if kind == "diagonal":
        return np.diag(rng.uniform(0.2, 2.0, n))
    M = rng.standard_normal((n, n))
    return M @ M.T / n + 0.1 * np.eye(n)


@pytest.mark.parametrize("strategy", ["smw", "direct", "cg"])
@pytest.mark.parametrize("kind", ["dense", "diagonal"])
def test_hsde_solve_with_P_matches_jax(kind, strategy):
    """P in the embedding (Q's x block, the Gram operator, the check and the
    unboundedness test), against the JAX loop's ``hsde_solve(P=…)``.  smw and
    direct at trajectory level (f64: the same status and iterations, w
    within 1e-9); cg, whose inner solves stop at a residual-tied tolerance,
    as tests/test_torch_sparse.py holds it: the same status and iterations,
    w within 2e-5·max(1, ‖w‖∞), over a short run (its eager PCG is slow)."""
    A, b, c, cones = _mixed_lp_socp()
    J, K = _sets(cones, A.shape[0])
    Pm = _psd(A.shape[1], kind)
    kw = {"abs_tol": 1e-7, "rel_tol": 1e-7, "max_iter": 60 if strategy == "cg" else 3000,
          "strategy": strategy}
    ref = j_hsde(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c), J, P=jnp.asarray(Pm), **kw)
    out = hsde_solve(_t(A, "f64"), _t(b, "f64"), _t(c, "f64"), K, P=_t(Pm, "f64"), **kw)
    if strategy == "cg":
        assert int(out["status"]) == int(ref["status"])
        assert int(out["final_iter"]) == int(ref["final_iter"])
        w_ref = np.asarray(ref["w"])
        np.testing.assert_allclose(out["w"].numpy(), w_ref,
                                   atol=2e-5 * max(1.0, np.abs(w_ref).max()))
        return
    _assert_w(np.asarray(ref["w"]), out["w"].numpy(), ref, out, "f64")
    for key in ("u", "r_pri", "r_dua", "gap", "fp_resid"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-9)


def test_embedding_operators_with_P_match_jax():
    """Q, Qᵀ, the SMW factor, I + Q and the Jacobi preconditioner with P."""
    from pogs_tpu.solver.hsde import (make_q_matvec as j_q, dense_q as j_dense_q,
                                      jacobi_inv_diag as j_jac)
    from pogs_tpu_torch.solver.hsde import make_q_matvec, smw_setup, dense_q, jacobi_inv_diag

    A, b, c, _ = _mixed_lp_socp()
    m, n = A.shape
    Pm = _psd(n, "dense")
    u = np.random.default_rng(9).standard_normal(n + m + 1)
    Aj, bj, cj, uj, Pj = (jnp.asarray(v) for v in (A, b, c, u, Pm))
    At, bt, ct, ut, Pt = (torch.tensor(v) for v in (A, b, c, u, Pm))
    for mine, ref in zip(make_q_matvec(At, bt, ct, Pt), j_q(Aj, bj, cj, Pj)):
        np.testing.assert_allclose(mine(ut).numpy(), np.asarray(ref(uj)), atol=1e-12)
    fac, jfac = smw_setup(At, bt, ct, Pt), j_smw(Aj, bj, cj, Pj)
    for key in ("Kinv", "t_x", "t_y", "s_den"):
        np.testing.assert_allclose(fac[key].numpy(), np.asarray(jfac[key]), atol=1e-12)
    np.testing.assert_allclose(dense_q(At, bt, ct, Pt).numpy(),
                               np.asarray(j_dense_q(Aj, bj, cj, Pj)), atol=0)
    np.testing.assert_allclose(jacobi_inv_diag(At, bt, ct, Pt).numpy(),
                               np.asarray(j_jac(Aj, bj, cj, Pj)), atol=1e-14)


def test_strategy_errors():
    A, b, c, cones = _lp()
    _, K = _sets(cones, A.shape[0])
    args = (_t(A, "f64"), _t(b, "f64"), _t(c, "f64"), K)
    # The cg strategy runs (slice 3), and so does a quadratic P (slice 5);
    # an unknown strategy is refused.
    out = hsde_solve(*args, strategy="cg", max_iter=20)
    assert int(out["final_iter"]) == 20 and bool(torch.isfinite(out["w"]).all())
    out = hsde_solve(*args, P=torch.eye(A.shape[1], dtype=torch.float64), max_iter=20)
    assert int(out["final_iter"]) == 20 and bool(torch.isfinite(out["w"]).all())
    with pytest.raises(ValueError):
        hsde_solve(*args, strategy="nope")


def test_eligibility_matches_jax_gate():
    from pogs_tpu.ops.fused_hsde import fused_hsde_eligible as j_eligible

    sets = {
        "soc": [(JC.SOC, range(8))],
        "exp": [(JC.EXP_PRIMAL, [0, 1, 2]), (JC.EXP_DUAL, [3, 4, 5])],
        "sdp": [(JC.SDP, [0, 1, 2])],
        "noncontiguous": [(JC.SOC, [0, 2, 4])],
        "lp": [(JC.ZERO, [0]), (JC.NON_NEG, range(1, 8))],
        "17_socs": [(JC.SOC, [i]) for i in range(17)],
    }
    for name, cones in sets.items():
        m = 1 + max(i for _, idx in cones for i in idx)
        J, K = _sets(cones, m)
        for has_P, aa in ((False, False), (True, False), (False, True)):
            want = j_eligible(m, 2, jnp.float32, J, has_P, aa)
            assert pf.fused_hsde_eligible(torch.float32, K, has_P, aa) == want, name
    _, K = _sets(sets["soc"], 8)
    assert not pf.fused_hsde_eligible(torch.float16, K, False, False)
    assert pf.segments(_sets(sets["noncontiguous"], 5)[1]) is None


def test_wrapper_raises_instead_of_falling_back():
    """The launch path (as a CUDA tensor takes it) builds and launches the
    kernel or raises; it never runs the plain version in its place."""
    A, b, c, cones = _lp()
    _, K = _sets(cones, A.shape[0])
    m, n = A.shape
    args = (_t(A, "f32"), _t(b, "f32"), _t(c, "f32"), K, torch.eye(n), torch.zeros(n),
            torch.zeros(m), torch.tensor(1.0), 1e-4, 1e-4, 10)
    before = pf.fused_hsde_solve.launches
    with pytest.raises((RuntimeError, AssertionError)):
        pf._launch(*args, None, None)
    with pytest.raises(ValueError):
        pf.fused_hsde_solve(args[0].to("meta"), *args[1:])
    with pytest.raises(ValueError):  # a Kinv of the wrong side is refused first
        pf._launch(*args[:4], torch.eye(m), *args[5:], None, None)
    with pytest.raises(TypeError):
        pf._launch(args[0].to(torch.float16), *args[1:], None, None)
    assert pf.fused_hsde_solve.launches == before


def test_cuda_source_codes_match_the_package():
    src = open(os.path.join(ROOT, "pogs_tpu_torch", "csrc", "fused_hsde.cu")).read()
    consts = dict(re.findall(r"\b(k[A-Z][A-Za-z]+) = (\d+)", src))
    assert int(consts["kSOC"]) == int(P.Cone.SOC)
    assert int(consts["kExpPrimal"]) == int(P.Cone.EXP_PRIMAL)
    assert int(consts["kExpDual"]) == int(P.Cone.EXP_DUAL)
    assert int(consts["kInfeasible"]) == int(P.Status.INFEASIBLE)
    assert int(consts["kUnbounded"]) == int(P.Status.UNBOUNDED)
    assert int(consts["kSegRow"]) == pf._SEG_ROW
    for cone, code in pf._ROW_CODE.items():
        name = {"ZERO": "kZero", "NON_NEG": "kNonNeg", "NON_POS": "kNonPos"}[cone.name]
        assert int(consts[name]) == code
    for name in ("K_ALPHA_MIN", "K_ALPHA_MAX", "K_ALPHA_GROW", "K_TAU_TOL", "K_TAU_REL",
                 "K_KAPPA_TOL", "K_CERT_CROSS", "K_CERT_CONFIRM"):
        from pogs_tpu_torch.solver import hsde as ph

        val = float(re.search(rf"\b{name} = ([0-9.e-]+)", src).group(1))
        assert val == getattr(ph, name), name


# --- The cone kernel's launch plan (ops/fused_hsde.py::hsde_plan) ----------

_SIZES = [(1, 1), (3, 2), (3, 8), (40, 12), (804, 200), (1100, 300), (8004, 2000),
          (2000, 8004), (20000, 5000)]


def _plan_segs(m):
    """An SOC and up to five exponential cones that fit m rows."""
    segs = [(P.Cone.SOC, 0, min(m, 4))]
    for i in range(min(5, (m - 4) // 3) if m > 4 else 0):
        segs.append((P.Cone.EXP_PRIMAL if i % 2 else P.Cone.EXP_DUAL, 4 + 3 * i, 3))
    return segs


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", _SIZES)
def test_plan_blocks_within_the_limit_and_owners(m, n, itemsize):
    """Blocks within the occupancy limit passed in and the SM count; every
    segment has exactly one owner, a block of the grid."""
    segs = _plan_segs(m)
    for sms, limit in ((132, 132), (132, 66), (132, 7), (132, 1), (8, 16), (132, 264)):
        plan = pf.hsde_plan(m, n, itemsize, segs, sms, limit)
        assert 1 <= plan["blocks"] <= min(sms, limit)
        assert plan["threads"] == pf.THREADS
        owners = plan["owners"]
        assert len(owners) == len(segs)
        assert all(isinstance(o, int) and 0 <= o < plan["blocks"] for o in owners)


@pytest.mark.parametrize("m,n", _SIZES)
def test_plan_depends_only_on_the_problem(m, n):
    """One problem, one plan: the same dict on every call, whatever was
    planned in between."""
    segs = _plan_segs(m)
    first = pf.hsde_plan(m, n, 4, segs, 132, 132)
    pf.hsde_plan(n, m, 8, segs[:1], 66, 3)
    assert pf.hsde_plan(m, n, 4, list(segs), 132, 132) == first


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", [(8004, 2000), (20000, 5000), (2000, 8004), (3, 2)])
def test_plan_shared_memory(m, n, itemsize):
    """At most the 232,448 bytes a block may use, whole 32-byte units (two
    16-byte vectors), and both vectors of a paired product of the longer
    side, in the working type, in one tile while they fit SMEM_VECTORS."""
    smem = pf.hsde_plan(m, n, itemsize, [], 132, 132)["smem"]
    assert 32 <= smem <= pf.SMEM_VECTORS <= 232_448
    assert smem % 32 == 0
    if 2 * max(m, n) * itemsize <= pf.SMEM_VECTORS:
        assert smem >= 2 * max(m, n) * itemsize
    else:
        assert smem == pf.SMEM_VECTORS


def _kernel_slots():
    """The partial-sum slots of csrc/fused_hsde.cu's Slot enum, in order."""
    src = open(os.path.join(ROOT, "pogs_tpu_torch", "csrc", "fused_hsde.cu")).read()
    body = re.search(r"enum Slot \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return [t.split("=")[0].strip() for t in body.split(",") if t.strip()]


@pytest.mark.parametrize("shape,nseg", [((40, 12), 0), ((40, 12), 3), ((3, 8), 0),
                                        ((3, 8), 2)])
def test_plan_barriers_and_live_slots(shape, nseg):
    """4 barriers per iteration tall, 6 wide; 2 more per check, 1 with no
    segment.  The slots reduced across blocks are those of the kernel's
    Slot enum: 7 per iteration (2 after the solve, 5 after the projection)
    and 13 per check (11 and 2), 11 with no segment; none per segment."""
    m, n = shape
    segs = [(P.Cone.SOC, 3 * i, 3) for i in range(nseg)]
    plan = pf.hsde_plan(m, n, 8, segs, 132, 132)
    assert plan["barriers_per_iter"] == (4 if m >= n else 6)
    assert plan["barriers_per_check"] == (2 if nseg else 1)
    slots = _kernel_slots()
    assert slots[-1] == "kSlots"
    per_iter = slots.index("S_CXS")
    per_check = slots.index("kSlots") - per_iter
    assert plan["slots_per_iter"] == per_iter == 7
    assert plan["slots_per_check"] == (per_check if nseg else slots.index("S_RPRI2") - per_iter)
    assert per_check == 13



# The K3 route table: µs per iteration on 1, 2, 4, 8, 16, 33, 66 and 132
# blocks, up to 1000 iterations at tolerance 0, divided by the iterations
# run (chip_smoke.py::hsde_route_table on an NVIDIA H100 80GB HBM3, 700 W).
_ROUTE_GRIDS = (1, 2, 4, 8, 16, 33, 66, 132)
_ROUTE_TABLE = [
    ('lp_3x2', 3, 2, 4, (5.7, 10.5, 10.3, 10.3, 10.3, 10.7, 10.4, 11.2)),
    ('lp_3x2', 3, 2, 8, (7.1, 11.8, 11.6, 11.5, 11.5, 11.7, 12.2, 12.5)),
    ('socp_10x9', 10, 9, 4, (7.9, 13.2, 12.8, 12.9, 13.0, 13.4, 13.1, 13.8)),
    ('socp_10x9', 10, 9, 8, (9.8, 14.9, 14.6, 14.4, 14.4, 14.9, 15.2, 15.5)),
    ('wide_eq_lp_3x8', 3, 8, 4, (9.6, 16.2, 16.3, 16.1, 16.1, 16.6, 16.4, 17.5)),
    ('wide_eq_lp_3x8', 3, 8, 8, (13.1, 20.3, 19.9, 19.9, 19.6, 20.3, 20.4, 20.9)),
    ('infeasible_2x1', 2, 1, 4, (6.8, 11.4, 11.6, 11.7, 11.0, 11.7, 11.6, 12.4)),
    ('infeasible_2x1', 2, 1, 8, (6.9, 11.5, 11.3, 11.2, 11.3, 11.7, 12.1, 12.2)),
    ('unbounded_1x1', 1, 1, 4, (9.4, 14.0, 13.9, 13.9, 13.8, 13.9, 13.9, 14.8)),
    ('unbounded_1x1', 1, 1, 8, (13.5, 18.0, 18.2, 17.9, 17.9, 18.2, 18.6, 19.3)),
    ('exp_3x1', 3, 1, 4, (14.0, 19.0, 19.0, 18.9, 19.1, 19.2, 19.2, 20.1)),
    ('exp_3x1', 3, 1, 8, (24.9, 29.8, 30.0, 29.8, 29.7, 29.9, 30.5, 31.0)),
    ('mixed_soc_exp_nonneg_10x4', 10, 4, 4, (16.3, 19.2, 18.8, 18.7, 18.6, 18.9, 19.1, 20.0)),
    ('mixed_soc_exp_nonneg_10x4', 10, 4, 8, (27.9, 30.0, 29.6, 29.8, 29.7, 30.0, 30.4, 30.5)),
    ('multi_exp_soc_27x6', 27, 6, 4, (19.8, 23.0, 20.7, 20.5, 20.5, 20.8, 20.7, 21.7)),
    ('multi_exp_soc_27x6', 27, 6, 8, (32.0, 34.6, 31.7, 31.3, 31.4, 31.7, 32.0, 32.1)),
    ('wide_eq_lp_60x300', 60, 300, 4, (36.6, 34.0, 24.4, 21.2, 19.7, 18.3, 18.8, 18.8)),
    ('wide_eq_lp_60x300', 60, 300, 8, (54.8, 42.9, 31.1, 27.4, 26.0, 24.7, 24.8, 25.1)),
    ('lp_ineq_1100x300', 1100, 300, 4, (112.0, 64.1, 37.5, 25.2, 19.7, 16.2, 15.2, 14.8)),
    ('lp_ineq_1100x300', 1100, 300, 8, (193.8, 109.2, 61.6, 39.0, 28.8, 22.2, 20.2, 19.1)),
    ('socp_ball_804x200', 804, 200, 4, (79.6, 48.1, 30.0, 21.1, 17.0, 15.8, 14.7, 15.3)),
    ('socp_ball_804x200', 804, 200, 8, (125.1, 72.9, 43.3, 29.0, 22.0, 19.4, 19.0, 18.3)),
    ('exp_primal_fixture', 5, 3, 4, (14.0, 18.9, 19.1, 18.8, 19.0, 19.4, 19.2, 20.7)),
    ('exp_primal_fixture', 5, 3, 8, (25.8, 30.9, 30.7, 30.7, 30.5, 31.0, 31.4, 31.6)),
    ('exp_dual_fixture', 5, 3, 4, (12.3, 17.2, 17.4, 17.1, 17.2, 17.6, 17.1, 18.3)),
    ('exp_dual_fixture', 5, 3, 8, (21.2, 26.1, 26.1, 26.1, 26.4, 26.3, 26.3, 26.8)),
    ('mixed_fixture', 10, 4, 4, (7.7, 12.9, 12.6, 12.3, 13.1, 13.0, 12.8, 14.0)),
    ('mixed_fixture', 10, 4, 8, (9.6, 14.4, 14.5, 14.4, 14.1, 14.4, 15.2, 15.4)),
    ('random_lp_64x48', 64, 48, 4, (10.6, 13.4, 11.1, 10.9, 11.8, 12.0, 11.4, 11.7)),
    ('random_lp_64x48', 64, 48, 8, (12.1, 14.6, 12.2, 11.6, 12.1, 12.5, 12.3, 12.7)),
    ('random_lp_90x60', 90, 60, 4, (14.5, 16.1, 13.2, 12.2, 12.6, 12.4, 12.5, 13.0)),
    ('random_lp_90x60', 90, 60, 8, (18.5, 19.2, 16.7, 15.4, 15.5, 15.5, 15.9, 16.3)),
    ('random_lp_128x96', 128, 96, 4, (15.7, 16.4, 13.4, 10.8, 10.7, 11.2, 11.3, 11.7)),
    ('random_lp_128x96', 128, 96, 8, (21.7, 18.8, 14.8, 12.0, 12.2, 12.3, 12.2, 12.8)),
    ('random_lp_200x120', 200, 120, 4, (24.3, 21.9, 16.6, 13.5, 12.5, 12.6, 12.9, 13.3)),
    ('random_lp_200x120', 200, 120, 8, (35.0, 27.8, 21.0, 16.7, 15.7, 15.5, 15.9, 16.4)),
    ('random_lp_300x200', 300, 200, 4, (38.7, 29.1, 19.8, 15.4, 13.5, 12.9, 12.7, 13.2)),
    ('random_lp_300x200', 300, 200, 8, (59.7, 41.0, 27.9, 21.0, 17.8, 16.4, 16.3, 16.9)),
]


@pytest.mark.parametrize("case,m,n,itemsize,us", _ROUTE_TABLE,
                         ids=[f"{r[0]}-f{8 * r[3]}" for r in _ROUTE_TABLE])
def test_plan_picks_a_fast_grid(case, m, n, itemsize, us):
    """At every measured size the plan's grid (on 132 SMs) is one of the
    measured grids and within 5% of the fastest: one block for the small
    cases, about 8 rows of the longest product per block beyond."""
    blocks = pf.hsde_plan(m, n, itemsize, [], 132, 132)["blocks"]
    assert blocks in _ROUTE_GRIDS
    assert us[_ROUTE_GRIDS.index(blocks)] <= 1.05 * min(us)
    assert (blocks == 1) == (2 * m * n + min(m, n) ** 2 <= pf.ONE_BLOCK_ELEMS)


@pytest.mark.parametrize("sms", [132, 114, 8])
def test_plan_one_block_rule(sms):
    """One block up to ONE_BLOCK_ELEMS matrix elements (2mn + k²); beyond,
    the fewest of sms, sms/2, sms/4, ... blocks that leave each at most
    ROWS_PER_BLOCK rows of the longest product; within the occupancy
    limit."""
    assert pf.blocks_for(64, 48, sms) == 1              # 8,448 elements
    assert pf.blocks_for(90, 60, 132) == 16             # 14,400: 90 rows
    assert pf.blocks_for(60, 90, 132) == 16
    assert pf.blocks_for(804, 200, 132) == 132
    rows = pf.ROWS_PER_BLOCK
    for m, n in _SIZES + [(70, 70), (100, 70), (128, 96), (200, 120), (300, 200)]:
        blocks = pf.blocks_for(m, n, sms)
        if 2 * m * n + min(m, n) ** 2 <= pf.ONE_BLOCK_ELEMS:
            assert blocks == 1
            continue
        ladder = [sms >> j for j in range(8) if sms >> j >= 1]
        assert blocks in ladder
        assert blocks == sms or blocks * rows >= max(m, n)
        assert blocks // 2 == 0 or (blocks // 2) * rows < max(m, n)
    assert pf.hsde_plan(100, 70, 8, [], 132, 10)["blocks"] == 10
    assert pf.hsde_plan(100, 70, 8, [], 8, 132)["blocks"] == 8
