"""The port's cone-form front end against pogs_tpu's, on the same inputs.

``solve_cone_problem`` on tests/conic_fixtures.py (LP, SOCP, least-squares
SOCP, SDP, exponential primal and dual, mixed), ``ConeSolver`` with a
non-empty K_x (the graph-form cone path) and with a warm start,
``dims_to_cones`` and ``auto_rho``; and the rule that routes an HSDE solve
to the cone kernel.  Both packages run on the CPU in float64 (one SOCP in
float32).  Pass: the same status, optval within 1e-4 relative, and x within
2e-5·max(1, ‖x‖∞).

The JAX exponential projection is compiled on its own and called from the
JAX solve through ``jax.pure_callback`` (see tests/test_torch_hsde.py).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pogs_tpu.types import Cone as JC, ConeConstraint as JCC, SolverSettings as JSet
import pogs_tpu.cones.sets as j_sets
from pogs_tpu.api.cone import (
    solve_cone_problem as j_solve_cone_problem, dims_to_cones as j_dims_to_cones,
    auto_rho as j_auto_rho,
)
from pogs_tpu.solver.cone import ConeSolver as JConeSolver

import pogs_tpu_torch as P
from pogs_tpu_torch.api.cone import auto_rho
from tests import conic_fixtures as fx

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _jax_exp_by_callback():
    saved = (j_sets.project_exp_primal, j_sets.project_exp_dual)
    jitted = jax.jit(saved[0], static_argnums=1)

    def proj(v, bisect_iters=50):
        return jax.pure_callback(
            lambda x: np.asarray(jitted(jnp.asarray(x), bisect_iters)),
            jax.ShapeDtypeStruct(v.shape, v.dtype), v)

    j_sets.project_exp_primal = proj
    j_sets.project_exp_dual = lambda v, bisect_iters=80: v + proj(-v, bisect_iters)
    try:
        yield
    finally:
        j_sets.project_exp_primal, j_sets.project_exp_dual = saved


def _assert_same(rj, rp, status=None):
    assert rp["status"] == rj["status"]
    if status is not None:
        assert rp["status"] == status
    assert rp["iterations"] == rj["iterations"]
    assert rp["optval"] == pytest.approx(rj["optval"], rel=1e-4, abs=1e-12)
    np.testing.assert_allclose(rp["x"], np.asarray(rj["x"]),
                               atol=2e-5 * max(1.0, float(np.abs(rj["x"]).max())))


FIXTURES = {
    "lp": fx.lp_fixture, "socp": fx.socp_fixture, "socp_ls": fx.socp_ls_fixture,
    "sdp": fx.sdp_fixture, "exp_primal": fx.exp_primal_fixture,
    "exp_dual": fx.exp_dual_fixture, "mixed": fx.mixed_fixture,
}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_solve_cone_problem_matches_jax(name):
    p = FIXTURES[name]()
    kw = {"assume_svec": True} if name == "sdp" else {}
    rj = j_solve_cone_problem(p["c"], p["A"], p["b"], p["dims"], max_iter=5000, **kw)
    rp = P.solve_cone_problem(p["c"], p["A"], p["b"], p["dims"], max_iter=5000,
                              device="cpu", **kw)
    _assert_same(rj, rp, status=0)
    for key in ("y", "l", "s"):
        np.testing.assert_allclose(rp[key], np.asarray(rj[key]), atol=1e-6)
    if "optval" in p:  # a closed form
        assert rp["optval"] == pytest.approx(p["optval"], rel=5e-3, abs=1e-3)


def test_internal_svec_transform_and_float32():
    """SDP rows transformed by the solver itself (assume_svec=False), and an
    SOCP in float32."""
    p = fx.sdp_fixture()
    rj = j_solve_cone_problem(p["c"], p["A"], p["b"], p["dims"], max_iter=5000)
    rp = P.solve_cone_problem(p["c"], p["A"], p["b"], p["dims"], max_iter=5000, device="cpu")
    _assert_same(rj, rp, status=0)
    p = fx.socp_ls_fixture()
    rj = j_solve_cone_problem(p["c"], p["A"], p["b"], p["dims"], dtype=jnp.float32)
    rp = P.solve_cone_problem(p["c"], p["A"], p["b"], p["dims"], dtype="float32",
                              device="cpu")
    assert rp["status"] == rj["status"] == 0
    assert abs(rp["iterations"] - rj["iterations"]) <= 2
    assert rp["optval"] == pytest.approx(rj["optval"], rel=1e-4)
    np.testing.assert_allclose(rp["x"], np.asarray(rj["x"]), atol=2e-5)


def test_dims_to_cones_and_auto_rho():
    dims = {"f": 2, "l": 3, "q": [4, 3], "s": [3], "ep": 2, "ed": 1}
    got = [(int(c.cone), c.indices) for c in P.dims_to_cones(dims)]
    assert got == [(int(c.cone), c.indices) for c in j_dims_to_cones(dims)]
    for name in ("lp", "socp", "mixed", "sdp"):
        p = FIXTURES[name]()
        for mode in (None, "ratio", "ratio_normA"):
            for scale in (None, 2.0):
                assert auto_rho(p["A"], p["b"], p["c"], p["dims"], mode=mode, scale=scale) \
                    == j_auto_rho(p["A"], p["b"], p["c"], p["dims"], mode=mode, scale=scale)
    with pytest.raises(ValueError):
        auto_rho(p["A"], p["b"], p["c"], p["dims"], mode="nope")


def _graph_form_case():
    """min c'x s.t. b − Ax ∈ (Zero, NonNeg), x ∈ NonNeg (K_x non-empty)."""
    rng = np.random.default_rng(8)
    m, n = 12, 6
    A = rng.standard_normal((m, n))
    x0 = np.abs(rng.standard_normal(n)) + 0.1
    b = A @ x0 + np.concatenate([np.zeros(2), rng.random(m - 2) + 0.1])
    c = np.abs(rng.standard_normal(n)) + 0.1
    return A, b, c, [(JC.ZERO, [0, 1]), (JC.NON_NEG, range(2, m))], [(JC.NON_NEG, range(n))]


def test_graph_form_cone_path_matches_jax():
    A, b, c, ky, kx = _graph_form_case()
    st = JSet(abs_tol=1e-6, rel_tol=1e-6, max_iter=3000)
    js = JConeSolver(A, Kx=[JCC(k, i) for k, i in kx], Ky=[JCC(k, i) for k, i in ky],
                     settings=st)
    ps = P.ConeSolver(A, Kx=[P.ConeConstraint(int(k), i) for k, i in kx],
                      Ky=[P.ConeConstraint(int(k), i) for k, i in ky],
                      settings=P.SolverSettings(abs_tol=1e-6, rel_tol=1e-6, max_iter=3000),
                      device="cpu")
    rj, rp = js.solve(b, c), ps.solve(b, c)
    assert int(rp.status) == int(rj.status) == 0
    assert int(rp.final_iter) == int(rj.final_iter)
    assert float(rp.optval) == pytest.approx(float(rj.optval), rel=1e-4)
    for key in ("x", "y", "mu", "nu"):
        np.testing.assert_allclose(getattr(rp, key).numpy(), np.asarray(getattr(rj, key)),
                                   atol=2e-5)


def test_warm_start_and_init_state_from_jax():
    """The JAX solver's init state carried over (utils.interop), then a cold
    solve and a warm re-solve with b·(1 + 1e-2) in both packages."""
    p = fx.mixed_fixture()
    ky = j_dims_to_cones(p["dims"])
    st = JSet(abs_tol=1e-7, rel_tol=1e-7, max_iter=5000)
    js = JConeSolver(p["A"], Ky=ky, settings=st).init()
    init = js._init_state
    exported = {"A": np.asarray(init["A"].dense()), "d": np.asarray(init["d"]),
                "e": np.asarray(init["e"]), "norm_A": np.asarray(init["norm_A"]),
                "factor": {"op": np.asarray(init["factor"]["op"])}}
    ps = P.ConeSolver(p["A"], Ky=P.dims_to_cones(p["dims"]),
                      settings=P.SolverSettings(abs_tol=1e-7, rel_tol=1e-7, max_iter=5000),
                      device="cpu")
    ps.load_init_state(P.init_state_from_numpy(exported, device="cpu"))
    its = []
    for bb, warm in ((p["b"], False), (p["b"] * (1 + 1e-2), True)):
        rj = js.solve(bb, p["c"], warm_start=warm)
        rp = ps.solve(bb, p["c"], warm_start=warm)
        assert int(rp.status) == int(rj.status) == 0
        assert int(rp.final_iter) == int(rj.final_iter)
        np.testing.assert_allclose(rp.x.numpy(), np.asarray(rj.x), atol=1e-9)
        its.append(int(rp.final_iter))
    assert its[1] < its[0]


def test_kernel_routing_rule():
    """Which loop runs an HSDE solve (ConeSolver.uses_kernel), as on a CUDA
    device: the kernel when eligible and the eager loop would not polish."""
    C, CC = P.Cone, P.ConeConstraint
    st = P.SolverSettings()

    def solver(m, n, cones, **kw):
        s = P.ConeSolver(np.ones((m, n)), Ky=cones, device="cpu", **kw)
        s.device = torch.device("cuda")  # the rule reads only the device type
        return s

    lp = [CC(C.NON_NEG, range(6))]
    soc = [CC(C.SOC, range(6))]
    assert solver(6, 3, soc).uses_kernel(st)
    assert not solver(6, 3, lp).uses_kernel(st)                 # polishes
    assert solver(6, 3, lp).uses_kernel(st.replace(polish=False))
    assert solver(6, 8, lp).uses_kernel(st)                     # wide: no polish
    assert solver(6, 3, lp, dtype="float32").uses_kernel(st.replace(polish=False))
    assert not solver(6, 3, soc).uses_kernel(st.replace(use_fused=False))
    assert not solver(6, 3, soc).uses_kernel(st.replace(use_anderson=True))
    assert not solver(6, 3, soc, strategy="direct").uses_kernel(st)
    assert not solver(6, 3, [CC(C.SDP, range(6))]).uses_kernel(st)
    assert not P.ConeSolver(np.ones((6, 3)), Kx=[CC(C.NON_NEG, [0])], Ky=soc,
                            device="cpu").uses_kernel(st)
    on_cpu = P.ConeSolver(np.ones((6, 3)), Ky=soc, device="cpu")
    assert not on_cpu.uses_kernel(st)
    assert on_cpu.uses_kernel(st.replace(use_fused=True))       # the plain version
    with pytest.raises(ValueError):
        solver(6, 3, [CC(C.SDP, range(6))]).uses_kernel(st.replace(use_fused=True))
    # The polish size caps (m, n only): within them the eager loop polishes;
    # beyond the Cholesky caps with an equality row nothing polishes and the
    # kernel runs; without one the eager loop polishes matrix-free.
    from pogs_tpu_torch.solver.hsde import polish_plan

    assert polish_plan(P.ConeSet(lp, 6), 6, 3, True) == (250, 250, 10, "chol")
    assert polish_plan(P.ConeSet(lp, 6), 6, 3, False) is None
    m = 130_000
    with_eq = P.ConeSet([CC(C.ZERO, [0]), CC(C.NON_NEG, range(1, m))], m)
    assert polish_plan(with_eq, m, 100, True) is None
    assert polish_plan(with_eq, 100_000, 100, True) == (1000, 1000, 6, "chol")
    assert polish_plan(P.ConeSet([CC(C.NON_NEG, range(m))], m), m, 100,
                       True) == (2000, 2000, 6, "cg")
    # A sparse A never takes the kernel (the cg strategy); forcing it raises.
    import scipy.sparse as sp

    sparse = P.ConeSolver(sp.csr_matrix(np.ones((6, 3))), Ky=soc, device="cpu",
                          sparse_policy="keep")
    sparse.device = torch.device("cuda")
    assert not sparse.uses_kernel(st)
    with pytest.raises(ValueError):
        P.ConeSolver(sp.csr_matrix(np.ones((6, 3))), Ky=soc, device="cpu", strategy="smw",
                     sparse_policy="keep").uses_kernel(st.replace(use_fused=True))


def test_forced_kernel_on_cpu_is_the_plain_loop():
    """use_fused=True on a CPU solver runs the kernel's plain version: the
    eager loop without polish, so it equals use_fused=False with
    polish=False, and launches nothing."""
    from pogs_tpu_torch.ops.fused_hsde import fused_hsde_solve

    p = fx.lp_fixture()
    before = fused_hsde_solve.launches
    a = P.solve_cone_problem(p["c"], p["A"], p["b"], p["dims"], device="cpu", use_fused=True)
    b = P.solve_cone_problem(p["c"], p["A"], p["b"], p["dims"], device="cpu", use_fused=False,
                             polish=False)
    assert fused_hsde_solve.launches == before
    assert a["status"] == b["status"] and a["iterations"] == b["iterations"]
    np.testing.assert_array_equal(a["x"], b["x"])


def test_not_ported_paths_raise():
    p = fx.lp_fixture()
    s = P.ConeSolver(p["A"], Ky=P.dims_to_cones(p["dims"]), device="cpu")
    # Slice 5's quadratic P is open: it solves; a P of the wrong shape, a
    # negative diagonal, a P with K_x and an unknown qp_via are refused.
    n = p["A"].shape[1]
    assert s.solve(p["b"], p["c"], P=np.eye(n)).status == P.Status.SUCCESS
    with pytest.raises(ValueError, match="P must be"):
        s.solve(p["b"], p["c"], P=np.eye(n + 1))
    with pytest.raises(ValueError, match="nonnegative"):
        s.solve(p["b"], p["c"], P=-np.ones(n))
    with pytest.raises(ValueError, match="K_x"):
        P.ConeSolver(p["A"], Kx=[P.ConeConstraint(P.Cone.NON_NEG, [0])], device="cpu").solve(
            p["b"], p["c"], P=np.eye(n))
    with pytest.raises(ValueError, match="qp_via"):
        P.ConeSolver(p["A"], device="cpu", qp_via="nope")
    # Slice 3's routes are open: the cg strategy, the CGLS projector, a
    # sparse A; an unknown projector is refused.
    assert P.ConeSolver(p["A"], device="cpu", strategy="cg").strategy == "cg"
    assert P.ConeSolver(p["A"], device="cpu", projector="cgls").projector == "cgls"
    import scipy.sparse as sp

    assert P.ConeSolver(sp.csr_matrix(p["A"]), device="cpu").A.is_sparse
    with pytest.raises(ValueError):
        P.ConeSolver(p["A"], device="cpu", projector="nope")
