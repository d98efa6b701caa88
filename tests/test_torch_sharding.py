"""Sharded solves of the port on ``torch.distributed`` (gloo, CPU ranks).

The counterparts of ``tests/test_sharding.py``'s contracts, at its sizes:
a sharded solve gives the single-device solve (collectives change the
schedule, not the math): the same status and iteration count, x within
5e-4 in float32 and 1e-8 in float64.  The cases run in groups of 2 and 4
spawned ranks (``tests/torch_mesh_cases.py``), one group per size for the
whole file; each group has a timeout and the parent joins with one, so a
rank that diverges fails these tests instead of hanging the run.

The JAX side of the parity tests runs here, in the parent, on
``tests/conftest.py``'s 8-device virtual CPU mesh; the ranks import no JAX.
"""

import logging

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_cases as C

DENSE_CASES = ["helpers", "row_f32", "row_f64", "col_f32", "col_f64", "mismatched",
               "mismatched_wide", "uneven", "exact_anderson", "equil_norm", "cone_soc",
               "cone_multi", "cone_graph", "cone_lp_polish", "budget", "fused_raises",
               "batch_cone", "parity_graph"]
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def groups():
    """Rank 0's results of every case, per world size (spawned once)."""
    out = {}
    for world in WORLDS:
        names = DENSE_CASES + (["batch_2d"] if world == 4 else [])
        out[world] = C.run_group(world, names)
    return out


def result(groups, world, name):
    r = groups[world][name]
    assert r["ok"], r.get("error")
    return r["value"]


def same_solve(v, atol):
    assert v["status"][0] == 0 and v["status"][1] == v["status"][0], v["status"]
    assert v["iters"][1] == v["iters"][0], v["iters"]
    np.testing.assert_allclose(v["x"][1], v["x"][0], atol=atol, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_load_no_jax(groups, world):
    assert groups[world]["_jax_loaded"] is False


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_helpers(groups, world):
    v = result(groups, world, "helpers")
    A = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
    rows = 64 // world
    np.testing.assert_array_equal(v["rows_block"], A[:rows])
    assert v["rows_lo_hi"] == (0, rows) and v["local_shape"] == (rows, 4)
    np.testing.assert_array_equal(v["rows_dense"], A)
    np.testing.assert_array_equal(v["cols_dense"], A.T)
    np.testing.assert_array_equal(v["cols_block"], A.T[:, :rows])
    # replicate broadcasts rank 0's copy.
    np.testing.assert_array_equal(v["replicated"], np.zeros(4))
    assert v["auto"] == ("rows", "cols")
    assert v["spec"] == (("rows",), (None, "rows"))
    np.testing.assert_array_equal(v["sharding_local"], A[:rows])
    # init_distributed on an initialized group is silent and idempotent.
    assert v["reinit"] == world


def test_pad_rows_to():
    from pogs_tpu_torch.parallel.mesh import pad_rows_to

    A_p, b_p, m0 = pad_rows_to(np.ones((10, 3)), np.ones(10), 8)
    assert A_p.shape == (16, 3) and b_p.shape == (16,) and m0 == 10
    assert np.all(A_p[10:] == 0) and np.all(b_p[10:] == 0)


def test_split_bounds_cover_uneven_sizes():
    from pogs_tpu_torch.parallel.mesh import split_bounds

    for total, parts in ((10, 4), (64, 8), (3, 4)):
        bounds = [split_bounds(total, parts, k) for k in range(parts)]
        assert bounds[0][0] == 0 and bounds[-1][1] == total
        assert all(bounds[k][1] == bounds[k + 1][0] for k in range(parts - 1))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,atol", [("row_f32", 5e-4), ("row_f64", 1e-8),
                                       ("col_f32", 5e-4), ("col_f64", 1e-8)])
def test_sharded_graph_solve_matches_single_device(groups, world, name, atol):
    v = result(groups, world, name)
    same_solve(v, atol)
    np.testing.assert_allclose(v["y"][1], v["y"][0], atol=atol * 10, rtol=0)
    np.testing.assert_allclose(v["nu"][1], v["nu"][0], atol=atol * 10, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,atol", [("mismatched", 5e-4), ("mismatched_wide", 1e-8)])
def test_mismatched_plan_still_correct(groups, world, name, atol):
    """A tall A on the column plan (and a wide one on rows): plans change
    cost, never the result."""
    same_solve(result(groups, world, name), atol)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("plan", ["rows", "cols"])
def test_uneven_blocks(groups, world, plan):
    """61 rows or columns split over 2 or 4 ranks: blocks of unequal size."""
    v = result(groups, world, "uneven")[plan]
    same_solve(v, 1e-8)
    np.testing.assert_allclose(v["y"][1], v["y"][0], atol=1e-8, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_graph_form_cone_path_on_a_sharded_A(groups, world):
    """K_x non-empty: the exact-tolerance graph-form loop with K_y split
    with the rows, an SOC across shards; equal to the single-device loop at
    trajectory level."""
    v = result(groups, world, "cone_graph")
    assert v["status"][0] == v["status"][1] and v["iters"][0] == v["iters"][1]
    np.testing.assert_allclose(v["x"][1], v["x"][0], atol=1e-8, rtol=0)
    np.testing.assert_allclose(v["y"][1], v["y"][0], atol=1e-8, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_exact_branch_and_anderson(groups, world):
    v = result(groups, world, "exact_anderson")
    same_solve(v["exact"], 1e-8)
    a = v["anderson"]
    assert a["status"][0] == a["status"][1] and a["iters"][0] == a["iters"][1]
    np.testing.assert_allclose(a["x"][1], a["x"][0], atol=1e-8, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_equilibration_and_norm(groups, world):
    v = result(groups, world, "equil_norm")
    d, e, nrm = v["ref"]
    for plan in ("rows", "cols"):
        ds, es, ns = v[plan]
        np.testing.assert_allclose(ds, d, rtol=1e-5)
        np.testing.assert_allclose(es, e, rtol=1e-5)
        assert ns == pytest.approx(nrm, rel=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_row_sharded_cone_solve_soc_across_shards(groups, world):
    v = result(groups, world, "cone_soc")
    for dt, atol in (("float32", 5e-4), ("float64", 1e-8)):
        same_solve(v[dt], atol)
        assert v[dt]["optval"][1] == pytest.approx(v["expect"], rel=1e-3, abs=1e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_cone_set_and_mixed_cones(groups, world):
    """SOC and exponential segments inside one shard and across shards: the
    sharded projection, dual projection and averaging hook equal
    the whole set's, and the f64 solve equals the single-device one."""
    v = result(groups, world, "cone_multi")
    for key in ("proj", "dual", "avg"):
        np.testing.assert_allclose(v[key][1], v[key][0], atol=1e-12, rtol=0)
    same_solve(v, 1e-8)


@pytest.mark.parametrize("world", WORLDS)
def test_polish_runs_whole_on_every_rank(groups, world):
    v = result(groups, world, "cone_lp_polish")
    same_solve(v, 1e-8)
    assert v["iters"][0] == 250  # the burst at the first polish point certified it


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("plan", ["rows", "cols", "rows_exact"])
def test_loop_body_collective_budget(groups, world, plan):
    """A steady-state ADMM iteration makes 2 vector all-reduces (the
    projection's product and the exact dual residual's) and 1 small one
    (every norm and dot of the iteration, stacked), as the JAX package's
    budget: at most 2 vector + 1 small, the exact branch at most 3 more."""
    c = result(groups, world, "budget")[plan]
    assert c["vector"] <= 2 and c["small"] <= 1, c
    assert c["vector"] + c["small"] <= 2 + 1 + 3, c
    assert c["broadcast"] == 0


@pytest.mark.parametrize("world", WORLDS)
def test_dr_iteration_collectives(groups, world):
    """The SMW DR iteration of a row-sharded cone solve: one vector
    all-reduce (Aᵀu_y) and three small ones (b·p_y, the fixed-point
    residual, the SOC segment across shards), plus the check's every 10th
    iteration (two products, two stacked sums)."""
    c = result(groups, world, "budget")["dr"]
    assert c["vector"] <= 1.2 + 1e-9 and c["small"] <= 3.6 + 1e-9, c


@pytest.mark.parametrize("world", WORLDS)
def test_use_fused_true_raises_on_a_sharded_A(groups, world):
    msg = result(groups, world, "fused_raises")["raised"]
    assert msg is not None and "unsharded" in msg


def test_batched_path_on_2d_mesh(groups):
    """A λ-path on a (2, 2) ('batch', 'rows') mesh: lanes split over the
    batch axis, every lane equal to the single-device path's."""
    v = result(groups, 4, "batch_2d")
    assert np.all(v["status"][0] == 0)
    for key in ("x", "y", "optval", "iterations", "status"):
        np.testing.assert_array_equal(v[key][1], v[key][0])
    assert "warm=True" in v["warm_raises"]


@pytest.mark.parametrize("world", WORLDS)
def test_batched_cone_and_qp_over_a_mesh(groups, world):
    v = result(groups, world, "batch_cone")
    assert np.all(v["cone"]["status"][0] == 0)
    for key, (ref, sh) in v["cone"].items():
        np.testing.assert_array_equal(sh, ref, err_msg=key)
    assert np.all(v["qp"]["status"][0] == 0)
    for key, (ref, sh) in v["qp"].items():
        np.testing.assert_array_equal(sh, ref, err_msg=key)


def test_batch_axis_must_be_on_the_mesh():
    from pogs_tpu_torch.parallel.batch import _lane_block

    class OneAxis:
        shape = {"rows": 2}
        axis_names = ("rows",)

        def check_axis(self, axis):
            if axis not in self.shape:
                raise ValueError(axis)

        def size(self, axis):
            return self.shape[axis]

    with pytest.raises(ValueError):
        _lane_block(OneAxis(), "batch", 8)
    assert _lane_block(None, "batch", 8) == (0, 8)

    class TwoLanes(OneAxis):
        shape = {"batch": 4}
        axis_names = ("batch",)

    with pytest.raises(ValueError, match="every rank needs a lane"):
        _lane_block(TwoLanes(), "batch", 2)


def test_init_distributed_surfaces_failure(monkeypatch, caplog):
    """A genuine init failure raises (after logging), not a silent single-
    process run; an 'already initialized' error stays silent."""
    from pogs_tpu_torch.parallel import mesh as M

    def boom(*a, **kw):
        raise RuntimeError("connection refused: tcp://10.0.0.1:1234")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with caplog.at_level(logging.ERROR):
        with pytest.raises(RuntimeError, match="connection refused"):
            M.init_distributed("tcp://10.0.0.1:1234", world_size=2, rank=0, backend="gloo")
    assert "init_process_group failed" in caplog.text

    def already(*a, **kw):
        raise RuntimeError("trying to initialize the default process group twice; "
                           "it is already initialized")

    monkeypatch.setattr(dist, "init_process_group", already)
    assert M.init_distributed("tcp://10.0.0.1:1234", world_size=2, rank=0,
                              backend="gloo") == 1
    # Without an address, a store or WORLD_SIZE it is a no-op for one process.
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert M.init_distributed() == 1


def test_collectives_raise_without_a_group():
    """A collective never runs in a degraded form: without a group it raises."""
    from pogs_tpu_torch.parallel import mesh as M

    if dist.is_initialized():
        pytest.skip("a process group is initialized in this process")
    with pytest.raises((RuntimeError, ValueError)):
        M.all_reduce(torch.ones(3), None)
    with pytest.raises(RuntimeError):
        M.make_mesh((2,))


def test_jax_parity_row_sharded_graph_solve(groups):
    """The same numpy inputs through the JAX package on the 8-device virtual
    mesh and the port on 2 gloo ranks, f64: the same status, iterations
    within 2, x within 1e-6."""
    import jax
    import jax.numpy as jnp
    from pogs_tpu.parallel.mesh import make_mesh, shard_matrix
    from pogs_tpu.solver.graph import GraphFormSolver
    from pogs_tpu.types import Function, FunctionVector, SolverSettings

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    A, b, lam = C.lasso(64, 24, 1, np.float64)
    f = FunctionVector(Function.SQUARE, 64, b=b, dtype=jnp.float64)
    g = FunctionVector(Function.ABS, 24, c=lam, dtype=jnp.float64)
    st = SolverSettings(abs_tol=1e-8, rel_tol=1e-8, use_fused=False)
    A_sh = shard_matrix(jnp.asarray(A), make_mesh((8,), ("rows",)))
    rj = GraphFormSolver(A_sh, dtype=jnp.float64, settings=st).solve(f, g)
    v = result(groups, 2, "parity_graph")
    assert int(rj.status) == v["status"][1] == 0
    assert abs(int(rj.final_iter) - v["iters"][1]) <= 2
    np.testing.assert_allclose(v["x"][1], np.asarray(rj.x), atol=1e-6, rtol=0)
