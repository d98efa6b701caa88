"""The row-sharded sparse operator (``parallel/sparse.py``) on gloo ranks.

The counterparts of ``tests/test_sharding.py``'s sparse contracts, at its
sizes: the operator against its dense oracle, the sharded sparse LP and
SOCP through the HSDE ``cg`` strategy against the single-device kept-sparse
solve (and the SOCP against its closed form and the JAX package), and a
graph-form lasso on the sharded sparse operator through CGLS.  Each group of
spawned ranks (``tests/torch_mesh_cases.py``) runs once for the file; the
cone solves, whose every CG step makes collectives, run on 2 ranks.
"""

import numpy as np
import pytest

import torch_mesh_cases as C

CASES = {2: ["sparse_op", "sparse_graph", "sparse_lp", "sparse_socp"],
         4: ["sparse_op", "sparse_graph"]}


@pytest.fixture(scope="module")
def groups():
    return {world: C.run_group(world, names) for world, names in CASES.items()}


def result(groups, world, name):
    r = groups[world][name]
    assert r["ok"], r.get("error")
    return r["value"]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_sparse_operator_matches_dense(groups, world):
    """mv / rmv / sq_mv / sq_rmv / scale / frob2 and the gathered operator
    against the dense oracle; the padding rows are inert."""
    v = result(groups, world, "sparse_op")
    Ad = C.sparse_op_matrix().toarray()
    m, n = Ad.shape
    assert v["m_orig"] == m and v["shape"][0] % world == 0 and v["shape"][1] == n
    assert v["local_shape"] == (v["shape"][0] // world, n)
    x, y, d, e = v["x"], v["y"], v["d"], v["e"]
    np.testing.assert_allclose(v["mv"][:m], Ad @ x, atol=1e-12)
    assert np.all(v["mv"][m:] == 0.0)
    np.testing.assert_allclose(v["rmv"], Ad.T @ y[:m], atol=1e-12)
    np.testing.assert_allclose(v["sq_mv"][:m], (Ad * Ad) @ x, atol=1e-12)
    np.testing.assert_allclose(v["sq_rmv"], (Ad * Ad).T @ y[:m], atol=1e-12)
    np.testing.assert_allclose(v["scaled_mv"][:m], (d[:m, None] * Ad * e[None, :]) @ x,
                               atol=1e-12)
    assert v["frob2"] == pytest.approx(float((Ad ** 2).sum()), rel=1e-12)
    np.testing.assert_array_equal(v["gathered"][:m], Ad)
    assert np.all(v["gathered"][m:] == 0.0)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_sparse_graph_solve_trajectory(groups, world):
    """A graph-form lasso on the sharded sparse operator (CGLS projector)
    equals the single-device sparse solve after 60 iterations."""
    v = result(groups, world, "sparse_graph")
    assert v["status"][0] == v["status"][1] and v["iters"][0] == v["iters"][1]
    np.testing.assert_allclose(v["x"][1], v["x"][0], atol=1e-8, rtol=0)


def test_sharded_sparse_cone_lp_matches_single(groups):
    v = result(groups, 2, "sparse_lp")
    assert v["status"] == (0, 0)
    assert v["iters"][1] == v["iters"][0]
    np.testing.assert_allclose(v["x"][1], v["x"][0], atol=1e-8, rtol=0)
    assert v["optval"][1] == pytest.approx(v["optval"][0], rel=1e-10)


def test_sharded_sparse_socp(groups):
    """min c'x s.t. ‖x − x0‖ ≤ r, the SOC over 16 rows split across ranks:
    the single-device solve and the closed form c'x0 − r‖c‖."""
    v = result(groups, 2, "sparse_socp")
    assert v["status"] == (0, 0) and v["iters"][1] == v["iters"][0]
    np.testing.assert_allclose(v["x"][1], v["x"][0], atol=1e-8, rtol=0)
    assert v["optval"][1] == pytest.approx(v["expect"], rel=1e-4, abs=1e-4)


def test_jax_parity_sharded_sparse_socp(groups):
    """The same numpy inputs through the JAX package's row-sharded sparse
    operator on the 8-device virtual mesh and the port's on 2 gloo ranks,
    f64: the same status, iterations within 2, x within 1e-6."""
    import jax
    from pogs_tpu.parallel.mesh import make_mesh
    from pogs_tpu.parallel.sparse import pad_cone_rows, shard_sparse
    from pogs_tpu.solver.cone import ConeSolver
    from pogs_tpu.types import Cone, ConeConstraint, SolverSettings

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    A, b, c, _ = C.sparse_socp()
    Ky = [ConeConstraint(Cone.SOC, range(A.shape[0]))]
    st = SolverSettings(abs_tol=1e-5, rel_tol=1e-5)
    op, _ = shard_sparse(A, make_mesh((8,), ("rows",)), dtype=np.float64)
    b_pad, Ky_pad = pad_cone_rows(b, Ky, op.shape[0])
    rj = ConeSolver(op, Ky=Ky_pad, settings=st, dtype=np.float64).solve(b_pad, c, settings=st)
    v = result(groups, 2, "sparse_socp")
    assert int(rj.status) == v["status"][1] == 0
    assert abs(int(rj.final_iter) - v["iters"][1]) <= 2
    np.testing.assert_allclose(v["x"][1], np.asarray(rj.x), atol=1e-6, rtol=0)
