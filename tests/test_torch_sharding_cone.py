"""Cone and QP solves of the port on a sharded A, and checkpoints of a
sharded solver (gloo, CPU ranks).

A sharded solve gives the port's single-device solve: the same status and
iteration count, x within 5e-4 in float32 and 1e-8 in float64.  The plans
covered are the ones ``tests/test_torch_sharding.py`` leaves out: the
column plan of both cone paths (K_x split with the columns), ``hsde_solve`` with P on either plan,
the portfolio QP through every route on either plan, checkpoints that
cross between a mesh and one device, and the refusal of the ``direct``
strategy.  The cases run in one spawned group per world size
(``tests/torch_mesh_cases.py``; blocks of unequal size among them: 15
columns and 34 rows over 2 and 4 ranks).

The JAX side of the parity tests runs here, in the parent, on
``tests/conftest.py``'s 8-device virtual CPU mesh; the ranks import no JAX.
"""

import numpy as np
import pytest
import torch

import torch_mesh_cases as C

torch.set_num_threads(1)

CASES = ["col_cone_soc", "col_cone_multi", "hsde_lp", "col_cone_lp", "hsde_p", "qp_routes",
         "direct_raises", "checkpoint"]
WORLDS = (2, 4)
PLANS = ("rows", "cols")


def _jax_lasso_solver(max_iter=None):
    """The checkpoint cases' lasso in the JAX package on one device, f64."""
    import jax.numpy as jnp
    from pogs_tpu.solver.graph import GraphFormSolver
    from pogs_tpu.types import Function, FunctionVector, SolverSettings

    A, b, lam = C.ckpt_problem()
    st = SolverSettings(abs_tol=1e-8, rel_tol=1e-8, use_fused=False,
                        **({} if max_iter is None else {"max_iter": max_iter}))
    f = FunctionVector(Function.SQUARE, A.shape[0], b=b, dtype=jnp.float64)
    g = FunctionVector(Function.ABS, A.shape[1], c=lam, dtype=jnp.float64)
    return GraphFormSolver(jnp.asarray(A), dtype=jnp.float64, settings=st), f, g


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("mesh_ckpt")


@pytest.fixture(scope="module")
def jax_cut(ckpt_dir):
    """The JAX package's lasso cut at ``CKPT_ITERS`` iterations: its
    checkpoint file, and its own continuation to tolerance."""
    solver, f, g = _jax_lasso_solver(C.CKPT_ITERS)
    solver.solve(f, g)
    path = str(ckpt_dir / "jax_cut.npz")
    solver.save_state(path)
    full, _, _ = _jax_lasso_solver()
    return path, solver.solve(f, g, settings=full.settings)


@pytest.fixture(scope="module")
def groups(ckpt_dir, jax_cut):
    """Rank 0's results of every case, per world size (spawned once)."""
    return {world: C.run_group(world, CASES, data={"jax_ckpt": jax_cut[0]}, tmp=str(ckpt_dir))
            for world in WORLDS}


def result(groups, world, name):
    r = groups[world][name]
    assert r["ok"], r.get("error")
    return r["value"]


def same_solve(v, atol, status=0):
    assert v["status"][0] == status and v["status"][1] == v["status"][0], v["status"]
    assert v["iters"][1] == v["iters"][0], v["iters"]
    np.testing.assert_allclose(v["x"][1], v["x"][0], atol=atol, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_load_no_jax(groups, world):
    assert groups[world]["_jax_loaded"] is False


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("dt,atol", [("float32", 5e-4), ("float64", 1e-8)])
def test_column_plan_hsde_soc_ball(groups, world, dt, atol):
    """The SOC ball on the column plan (a tall A, 15 columns in uneven
    blocks): the HSDE path with x split and K_y whole."""
    v = result(groups, world, "col_cone_soc")
    same_solve(v[dt], atol)
    assert v[dt]["optval"][1] == pytest.approx(v["expect"], rel=1e-3, abs=1e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_column_plan_cone_set_and_mixed_cones(groups, world):
    """SOC and exponential segments split with the columns: the sharded
    K_x's projection, dual projection and averaging equal the whole set's;
    the HSDE solve on those cones over K_y and the graph-form path on them
    over K_x equal the single-device loops at trajectory level."""
    v = result(groups, world, "col_cone_multi")
    for key in ("proj", "dual", "avg"):
        np.testing.assert_allclose(v[key][1], v[key][0], atol=1e-12, rtol=0)
    for path in ("hsde", "graph"):
        p = v[path]
        assert p["status"][0] == p["status"][1] and p["iters"][0] == p["iters"][1], path
        np.testing.assert_allclose(p["x"][1], p["x"][0], atol=1e-8, rtol=0)
        np.testing.assert_allclose(p["y"][1], p["y"][0], atol=1e-8, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("plan", PLANS)
def test_wide_hsde_on_each_plan(groups, world, plan):
    """A wide A through the HSDE path: Woodbury through the reduced Gram on
    the column plan, through the gathered one on the row plan."""
    v = result(groups, world, "hsde_lp")[plan]
    same_solve(v, 1e-8)
    np.testing.assert_allclose(v["nu"][1], v["nu"][0], atol=1e-8, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_column_plan_lp_polish(groups, world):
    """A tall LP that the eager loop polishes, on the column plan: the
    burst runs whole on the gathered A and certifies at its first point."""
    v = result(groups, world, "hsde_lp")["polish_cols"]
    same_solve(v, 1e-8)
    assert v["iters"][0] == 250


@pytest.mark.parametrize("world", WORLDS)
def test_column_plan_graph_form_lp(groups, world):
    """The 24×64 standard-form LP (K_x with an SOC across the column
    shards) on the plan ``auto_shard`` picks, solved to tolerance."""
    v = result(groups, world, "col_cone_lp")
    assert v["plan"] == "cols"
    same_solve(v, 1e-8)
    np.testing.assert_allclose(v["y"][1], v["y"][0], atol=1e-8, rtol=0)
    assert v["optval"][1] == pytest.approx(v["optval"][0], rel=1e-10)


HSDE_P_KEYS = [((20, 12), "smw", "rows"), ((20, 12), "smw", "cols"),
               ((20, 12), "cg", "rows"), ((20, 12), "cg", "cols"),
               ((12, 20), "smw", "rows"), ((12, 20), "smw", "cols")]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", HSDE_P_KEYS, ids=lambda k: f"{k[0][0]}x{k[0][1]}-{k[1]}-{k[2]}")
def test_hsde_with_P_on_each_plan(groups, world, key):
    v = result(groups, world, "hsde_p")[key]
    assert v["status"][0] == v["status"][1] and v["iters"][0] == v["iters"][1]
    np.testing.assert_allclose(v["w"][1], v["w"][0], atol=1e-8, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("route", list(C.QP_ROUTES))
def test_qp_route_on_a_sharded_A(groups, world, plan, route):
    """The portfolio QP through each route on each plan: the single-device
    route's status, iterations and x, and its optval within 1e-6 of the
    host IPM's."""
    v = result(groups, world, "qp_routes")
    r = v[(route, plan)]
    same_solve(r, 1e-8)
    np.testing.assert_allclose(r["nu"][1], r["nu"][0], atol=1e-8, rtol=0)
    ipm = v[("ipm", plan)]["optval"][0]
    assert r["optval"][1] == pytest.approx(ipm, rel=1e-6)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("route", ["socp_diag", "admm_diag"])
def test_diagonal_qp_on_a_sharded_A(groups, world, plan, route):
    """P's diagonal alone through the epigraph and the ADMM route: the
    single-device route's status, iterations and x."""
    r = result(groups, world, "qp_routes")[(route, plan)]
    same_solve(r, 1e-8)
    assert r["optval"][1] == pytest.approx(r["optval"][0], rel=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_direct_strategy_refuses_a_sharded_A(groups, world):
    """The JAX package's direct strategy on a sharded A returns MAX_ITER far
    from the optimum (GSPMD); the port refuses it on either plan."""
    for (plan, strategy), msg in result(groups, world, "direct_raises").items():
        assert msg is not None and "takes no sharded A" in msg, (plan, strategy)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("direction", ["to_one", "to_mesh"])
def test_checkpoint_crosses_mesh_and_one_device(groups, world, plan, direction):
    """A checkpoint of a cut solve resumed on the other side equals the
    solve that was never interrupted (the in-memory continuation)."""
    v = result(groups, world, "checkpoint")[(plan, direction)]
    if direction == "to_one":
        assert v["cut"]["status"] != 0  # cut at CKPT_ITERS, not converged
    a, b = v["resumed"], v["uninterrupted"]
    assert a["status"] == b["status"] == 0 and a["iters"] == b["iters"]
    np.testing.assert_allclose(a["x"], b["x"], atol=1e-8, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("plan", PLANS)
def test_jax_checkpoint_resumes_on_a_mesh(groups, jax_cut, world, plan):
    """The JAX package's one-device checkpoint resumed by a sharded port
    solver: the JAX package's own continuation (parity tolerances: status,
    iterations within 2, x within 1e-6)."""
    v = result(groups, world, "checkpoint")[(plan, "from_jax")]
    rj = jax_cut[1]
    assert v["status"] == int(rj.status) == 0
    assert abs(v["iters"] - int(rj.final_iter)) <= 2
    np.testing.assert_allclose(v["x"], np.asarray(rj.x), atol=1e-6, rtol=0)


@pytest.mark.parametrize("plan", PLANS)
def test_mesh_checkpoint_resumes_in_jax(groups, plan):
    """The port's checkpoint written on 2 ranks, resumed in the JAX package
    on one device, against the port's uninterrupted solve."""
    v = result(groups, 2, "checkpoint")[(plan, "to_one")]
    solver, f, g = _jax_lasso_solver()
    rj = solver.load_state(v["path"]).solve(f, g)
    ref = v["uninterrupted"]
    assert int(rj.status) == ref["status"] == 0
    assert abs(int(rj.final_iter) - ref["iters"]) <= 2
    np.testing.assert_allclose(np.asarray(rj.x), ref["x"], atol=1e-6, rtol=0)


def _jax_mesh(size=2):
    import jax
    from pogs_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh((size,), ("rows",), devices=jax.devices()[:size])


def test_jax_parity_column_plan_cone_solve(groups):
    """The 24×64 standard-form LP on the column plan: the JAX package on
    the 8-device virtual mesh and the port on 2 gloo ranks, f64."""
    import jax.numpy as jnp
    from pogs_tpu.parallel.mesh import shard_matrix_cols
    from pogs_tpu.solver.cone import ConeSolver
    from pogs_tpu.types import Cone, ConeConstraint, SolverSettings

    A, b, c, Kx, Ky = C.std_form_lp()

    def jc(cones):
        return [ConeConstraint(Cone(int(k.cone)), k.indices) for k in cones]

    A_sh = shard_matrix_cols(jnp.asarray(A), _jax_mesh(8))
    rj = ConeSolver(A_sh, Kx=jc(Kx), Ky=jc(Ky), dtype=jnp.float64,
                    settings=SolverSettings(abs_tol=1e-6, rel_tol=1e-6)).solve(b, c)
    v = result(groups, 2, "col_cone_lp")
    assert int(rj.status) == v["status"][1] == 0
    assert abs(int(rj.final_iter) - v["iters"][1]) <= 2
    np.testing.assert_allclose(v["x"][1], np.asarray(rj.x), atol=1e-6, rtol=0)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("route", ["socp", "admm"])
def test_jax_parity_sharded_qp(groups, plan, route):
    """The portfolio QP on a 2-device row or column plan, through the
    epigraph HSDE (no polish) and the ADMM route with its polish: the JAX
    package and the port on 2 gloo ranks, f64."""
    import jax.numpy as jnp
    from pogs_tpu.api.cone import dims_to_cones
    from pogs_tpu.parallel.mesh import shard_matrix, shard_matrix_cols
    from pogs_tpu.solver.cone import ConeSolver
    from pogs_tpu.types import SolverSettings

    q = C.portfolio_small()
    via, polish = C.QP_ROUTES[route]
    shard = shard_matrix if plan == "rows" else shard_matrix_cols
    st = SolverSettings(abs_tol=1e-7, rel_tol=1e-7, max_iter=20000, polish=polish)
    rj = ConeSolver(shard(jnp.asarray(q["A"]), _jax_mesh()), Ky=dims_to_cones(q["dims"]),
                    dtype=jnp.float64, settings=st, qp_via=via).solve(q["b"], q["c"], P=q["P"])
    v = result(groups, 2, "qp_routes")[(route, plan)]
    assert int(rj.status) == v["status"][1] == 0
    assert abs(int(rj.final_iter) - v["iters"][1]) <= 2
    np.testing.assert_allclose(v["x"][1], np.asarray(rj.x), atol=1e-6, rtol=0)
