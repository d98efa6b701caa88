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


def test_strategy_errors():
    A, b, c, cones = _lp()
    _, K = _sets(cones, A.shape[0])
    args = (_t(A, "f64"), _t(b, "f64"), _t(c, "f64"), K)
    with pytest.raises(NotImplementedError, match="slice 3"):
        hsde_solve(*args, strategy="cg")
    with pytest.raises(NotImplementedError, match="slice 5"):
        hsde_solve(*args, P=torch.eye(A.shape[1], dtype=torch.float64))
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
