"""Sharded-solve cases of ``pogs_tpu_torch``, run inside spawned CPU ranks.

``run_group(world, names)`` spawns ``world`` processes (the ``spawn``
start method), joins them into a gloo group through a ``FileStore`` in a
temporary directory, and runs the named cases of :data:`CASES` in order in
every rank.  Each case returns plain numpy data, from which the tests in
the parent assert; rank 0's results come back as a dict, a case that
raised as its traceback.  Every process group has a timeout and the parent
joins with one, so a rank that diverges fails the run instead of hanging
it.

This module imports torch, numpy, scipy and the port only: a rank never
imports JAX (the parity tests run the JAX package in the parent).
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback

import numpy as np

GROUP_TIMEOUT_S = 120
JOIN_TIMEOUT_S = 420


def lasso(m, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(dtype)
    b = rng.standard_normal(m).astype(dtype)
    lam = 0.2 * float(np.max(np.abs(A.T @ b)))
    return A, b, lam


def soc_ball(n=15, seed=9):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal(n)
    c = rng.standard_normal(n)
    r = 1.5
    A = np.vstack([np.zeros((1, n)), -np.eye(n)])
    b = np.concatenate([[r], -x0])
    return A, b, c, float(c @ x0 - r * np.linalg.norm(c))


def sparse_lp():
    import scipy.sparse as sp

    rng = np.random.default_rng(7)
    m0, n = 9, 10
    Araw = sp.random(m0, n, density=0.4, random_state=1, format="csr")
    A = sp.vstack([Araw, sp.eye(n), -sp.eye(n)]).tocsr()
    m = A.shape[0]
    x0 = rng.normal(size=n)
    b = A @ x0 + rng.random(m) + 0.1
    c = rng.normal(size=n)
    return A, b, c


def sparse_socp(n=15, seed=9):
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal(n)
    c = rng.standard_normal(n)
    r = 1.5
    A = sp.vstack([sp.csr_matrix((1, n)), -sp.eye(n)]).tocsr()
    b = np.concatenate([[r], -x0])
    return A, b, c, float(c @ x0 - r * np.linalg.norm(c))


def sparse_op_matrix():
    import scipy.sparse as sp

    m0, n = 11, 12
    Araw = sp.random(m0, n, density=0.3, random_state=4, format="csr")
    return sp.vstack([Araw, sp.eye(n), -sp.eye(n)]).tocsr()


# -- the cases ------------------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _graph_pair(ctx, A, b, lam, dtype, shard, **st_kw):
    """The single-device and the sharded solve of one lasso."""
    from pogs_tpu_torch.types import Function, FunctionVector, SolverSettings
    from pogs_tpu_torch.solver.graph import GraphFormSolver

    m, n = A.shape
    f = FunctionVector(Function.SQUARE, m, b=b)
    g = FunctionVector(Function.ABS, n, c=lam)
    tol = 1e-5 if dtype == np.float32 else 1e-8
    kw = {"abs_tol": tol, "rel_tol": tol, "use_fused": False, **st_kw}
    st = SolverSettings(**kw)
    ref = GraphFormSolver(A.astype(dtype), settings=st, device="cpu").solve(f, g)
    sh = GraphFormSolver(shard(A.astype(dtype), ctx.mesh), settings=st).solve(f, g)
    return {"status": (int(ref.status), int(sh.status)),
            "iters": (int(ref.final_iter), int(sh.final_iter)),
            "x": (_np(ref.x), _np(sh.x)), "y": (_np(ref.y), _np(sh.y)),
            "nu": (_np(ref.nu), _np(sh.nu)), "optval": (float(ref.optval), float(sh.optval))}


def case_helpers(ctx):
    import torch
    from pogs_tpu_torch.parallel import mesh as M

    A = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
    rows = M.shard_matrix(A, ctx.mesh)
    cols = M.shard_matrix_cols(A.T.copy(), ctx.mesh)
    x = M.replicate(np.full(4, float(ctx.rank)), ctx.mesh)
    sh = M.row_sharding(ctx.mesh)
    return {"rows_block": _np(rows.block.dense()), "rows_lo_hi": (rows.lo, rows.hi),
            "rows_dense": _np(rows.dense()), "cols_dense": _np(cols.dense()),
            "cols_block": _np(cols.block.dense()), "replicated": _np(x),
            "auto": (M.auto_shard(A, ctx.mesh).plan, M.auto_shard(A.T.copy(), ctx.mesh).plan),
            "spec": (sh.spec, M.col_sharding(ctx.mesh).spec),
            "sharding_local": _np(sh.local(torch.as_tensor(A))),
            "world": ctx.world, "rank": ctx.rank,
            "reinit": M.init_distributed(), "local_shape": rows.local_shape}


def case_row_f32(ctx):
    from pogs_tpu_torch.parallel.mesh import shard_matrix
    return _graph_pair(ctx, *lasso(64, 24, 1), np.float32, shard_matrix)


def case_row_f64(ctx):
    from pogs_tpu_torch.parallel.mesh import shard_matrix
    return _graph_pair(ctx, *lasso(64, 24, 1, np.float64), np.float64, shard_matrix)


def case_col_f32(ctx):
    from pogs_tpu_torch.parallel.mesh import shard_matrix_cols
    return _graph_pair(ctx, *lasso(24, 64, 11), np.float32, shard_matrix_cols)


def case_col_f64(ctx):
    from pogs_tpu_torch.parallel.mesh import shard_matrix_cols
    return _graph_pair(ctx, *lasso(24, 64, 11, np.float64), np.float64, shard_matrix_cols)


def case_mismatched(ctx):
    """A tall A on the column plan: the Gram gathers A once."""
    from pogs_tpu_torch.parallel.mesh import shard_matrix_cols
    return _graph_pair(ctx, *lasso(64, 16, 13), np.float32, shard_matrix_cols)


def case_mismatched_wide(ctx):
    """A wide A on the row plan."""
    from pogs_tpu_torch.parallel.mesh import shard_matrix
    return _graph_pair(ctx, *lasso(24, 64, 11, np.float64), np.float64, shard_matrix)


def case_uneven(ctx):
    """Blocks of unequal size: 61 rows (row plan) and 61 columns (column
    plan) over 2 or 4 ranks, f64."""
    from pogs_tpu_torch.parallel.mesh import shard_matrix, shard_matrix_cols
    return {"rows": _graph_pair(ctx, *lasso(61, 24, 7, np.float64), np.float64, shard_matrix),
            "cols": _graph_pair(ctx, *lasso(24, 61, 7, np.float64), np.float64,
                                shard_matrix_cols)}


def case_cone_graph(ctx):
    """The graph-form cone path (K_x non-empty: 0 ≤ x) on a row-sharded A,
    with an SOC of K_y across the shards' boundaries, in exact-tolerance
    mode with the post-solve check, f64, at trajectory level (150
    iterations: the exact-mode loop takes thousands on this problem)."""
    from pogs_tpu_torch.parallel.mesh import shard_matrix
    from pogs_tpu_torch.solver.cone import ConeSolver
    from pogs_tpu_torch.types import Cone, ConeConstraint, SolverSettings

    rng = np.random.default_rng(21)
    n = 10
    R = rng.standard_normal((30, n))
    x0 = 0.5 * np.abs(rng.standard_normal(n))
    soc_rows = np.vstack([np.zeros((1, n)), -np.eye(n)[:5]])  # ‖x[:5]‖ ≤ 3
    A = np.vstack([R[:20], soc_rows, R[20:], np.eye(n)])
    b = np.concatenate([R[:20] @ x0 + 1.0, [3.0], np.zeros(5), R[20:] @ x0 + 1.0,
                        np.full(n, 2.0)])
    m = A.shape[0]
    Ky = [ConeConstraint(Cone.NON_NEG, range(0, 20)), ConeConstraint(Cone.SOC, range(20, 26)),
          ConeConstraint(Cone.NON_NEG, range(26, m))]
    Kx = [ConeConstraint(Cone.NON_NEG, range(n))]
    c = rng.standard_normal(n)
    st = SolverSettings(abs_tol=1e-5, rel_tol=1e-5, max_iter=150)
    ref = ConeSolver(A, Kx=Kx, Ky=Ky, settings=st, device="cpu").solve(b, c)
    sh = ConeSolver(shard_matrix(A, ctx.mesh), Kx=Kx, Ky=Ky, settings=st).solve(b, c)
    return {"status": (int(ref.status), int(sh.status)),
            "iters": (int(ref.final_iter), int(sh.final_iter)),
            "x": (_np(ref.x), _np(sh.x)), "y": (_np(ref.y), _np(sh.y)),
            "optval": (float(ref.optval), float(sh.optval))}


def case_exact_anderson(ctx):
    """The exact-tolerance branch and Anderson acceleration, row plan, f64."""
    from pogs_tpu_torch.parallel.mesh import shard_matrix
    out = {"exact": _graph_pair(ctx, *lasso(64, 24, 5, np.float64), np.float64, shard_matrix,
                                use_exact_tol=True),
           # Anderson at trajectory level: 200 of its 1600 iterations.
           "anderson": _graph_pair(ctx, *lasso(64, 24, 5, np.float64), np.float64,
                                   shard_matrix, use_anderson=True, max_iter=200)}
    return out


def case_equil_norm(ctx):
    import torch
    from pogs_tpu_torch.linalg.equil import equilibrate
    from pogs_tpu_torch.linalg.matrix import whole
    from pogs_tpu_torch.linalg.norm import norm2_est
    from pogs_tpu_torch.parallel.mesh import shard_matrix, shard_matrix_cols

    A, _, _ = lasso(64, 16, 3, np.float64)
    ref = equilibrate(torch.as_tensor(A))
    out = {"ref": (_np(ref.d), _np(ref.e), float(norm2_est(ref.A)))}
    for name, shard in (("rows", shard_matrix), ("cols", shard_matrix_cols)):
        op = shard(A, ctx.mesh)
        eq = equilibrate(op)
        out[name] = (_np(whole(op, "m", eq.d)), _np(whole(op, "n", eq.e)), float(norm2_est(eq.A)))
    return out


def case_cone_soc(ctx):
    """A row-sharded dense SOC ball whose one segment spans every shard."""
    from pogs_tpu_torch.parallel.mesh import shard_matrix
    from pogs_tpu_torch.solver.cone import ConeSolver
    from pogs_tpu_torch.types import Cone, ConeConstraint, SolverSettings

    A, b, c, expect = soc_ball()
    Ky = [ConeConstraint(Cone.SOC, range(A.shape[0]))]
    out = {"expect": expect}
    for dt, tol in ((np.float32, 1e-5), (np.float64, 1e-9)):
        st = SolverSettings(abs_tol=tol, rel_tol=tol)
        ref = ConeSolver(A.astype(dt), Ky=Ky, settings=st, device="cpu").solve(b, c)
        sh = ConeSolver(shard_matrix(A.astype(dt), ctx.mesh), Ky=Ky, settings=st).solve(b, c)
        out[np.dtype(dt).name] = {
            "status": (int(ref.status), int(sh.status)),
            "iters": (int(ref.final_iter), int(sh.final_iter)),
            "x": (_np(ref.x), _np(sh.x)), "nu": (_np(ref.nu), _np(sh.nu)),
            "optval": (float(ref.optval), float(sh.optval))}
    return out


def case_cone_multi(ctx):
    """Several SOC and exponential segments, some inside one shard and some
    across, with nonnegative rows: the sharded cone set against the whole
    one (projection, dual projection, the equilibration averaging), and a
    full f64 solve."""
    import torch
    from pogs_tpu_torch.cones.sets import ConeSet, ShardedConeSet
    from pogs_tpu_torch.parallel.mesh import shard_matrix
    from pogs_tpu_torch.solver.cone import ConeSolver
    from pogs_tpu_torch.types import Cone, ConeConstraint, SolverSettings

    rng = np.random.default_rng(4)
    m, n = 24, 8
    # On 2 ranks the exponential cone 11-13 spans the boundary at 12; on 4
    # (boundaries 6, 12, 18) so do the SOCs 3-7 and 17-23.
    cones = [ConeConstraint(Cone.NON_NEG, range(0, 3)), ConeConstraint(Cone.SOC, range(3, 8)),
             ConeConstraint(Cone.EXP_PRIMAL, range(8, 11)),
             ConeConstraint(Cone.EXP_PRIMAL, range(11, 14)), ConeConstraint(Cone.SOC, range(14, 17)),
             ConeConstraint(Cone.SOC, range(17, 24))]
    A = rng.standard_normal((m, n))
    op = shard_matrix(A, ctx.mesh, dtype=torch.float64)
    whole_set = ConeSet(cones, m)
    sharded = ShardedConeSet(whole_set, op)
    v = torch.as_tensor(rng.standard_normal(m))
    w = torch.as_tensor(rng.random(m) + 0.5)
    proj = op.gather(sharded.project(op.local(v)))
    dual = op.gather(sharded.dual().project(op.local(v)))
    avg = op.gather(sharded.constrain_average(op.local(w)))
    # A feasible problem on these cones: b = A x0 + s0 with s0 inside K.
    x0 = rng.standard_normal(n)
    s0 = np.asarray(whole_set.project(torch.as_tensor(rng.standard_normal(m)))) + 0.0
    s0[0:3] += 1.0
    s0[3] += 2.0
    b = A @ x0 + s0
    c = -A.T @ np.asarray(whole_set.dual().project(torch.as_tensor(rng.standard_normal(m))))
    st = SolverSettings(abs_tol=1e-5, rel_tol=1e-5, max_iter=3000)
    ref = ConeSolver(A, Ky=cones, settings=st, device="cpu").solve(b, c)
    sh = ConeSolver(op, Ky=cones, settings=st).solve(b, c)
    return {"proj": (_np(whole_set.project(v)), _np(proj)),
            "dual": (_np(whole_set.dual().project(v)), _np(dual)),
            "avg": (_np(whole_set.constrain_average(w)), _np(avg)),
            "status": (int(ref.status), int(sh.status)),
            "iters": (int(ref.final_iter), int(sh.final_iter)),
            "x": (_np(ref.x), _np(sh.x)), "optval": (float(ref.optval), float(sh.optval))}


def case_cone_lp_polish(ctx):
    """A tall LP that the eager loop polishes: the burst runs whole on every
    rank on the gathered A and iterate."""
    from pogs_tpu_torch.parallel.mesh import shard_matrix
    from pogs_tpu_torch.solver.cone import ConeSolver
    from pogs_tpu_torch.types import Cone, ConeConstraint, SolverSettings

    rng = np.random.default_rng(31)
    m, n = 64, 16
    A = rng.standard_normal((m, n))
    xs = rng.standard_normal(n)
    b = A @ xs + np.abs(rng.standard_normal(m))
    c = -A.T @ np.abs(rng.standard_normal(m))
    Ky = [ConeConstraint(Cone.NON_NEG, range(m))]
    st = SolverSettings(abs_tol=1e-9, rel_tol=1e-9, max_iter=2000)
    ref = ConeSolver(A, Ky=Ky, settings=st, device="cpu").solve(b, c)
    sh = ConeSolver(shard_matrix(A, ctx.mesh), Ky=Ky, settings=st).solve(b, c)
    return {"status": (int(ref.status), int(sh.status)),
            "iters": (int(ref.final_iter), int(sh.final_iter)),
            "x": (_np(ref.x), _np(sh.x)), "optval": (float(ref.optval), float(sh.optval))}


def case_budget(ctx):
    """All-reduces per steady-state iteration, by kind: two runs of
    different length at tolerance 0, differenced."""
    from pogs_tpu_torch.parallel import mesh as M
    from pogs_tpu_torch.parallel.mesh import shard_matrix, shard_matrix_cols
    from pogs_tpu_torch.solver.cone import ConeSolver
    from pogs_tpu_torch.solver.graph import GraphFormSolver
    from pogs_tpu_torch.types import Cone, ConeConstraint, Function, FunctionVector, SolverSettings

    out = {}
    for name, shape, shard, exact in (("rows", (64, 24), shard_matrix, False),
                                      ("cols", (24, 64), shard_matrix_cols, False),
                                      ("rows_exact", (64, 24), shard_matrix, True)):
        A, b, lam = lasso(*shape, 1, np.float64)
        f = FunctionVector(Function.SQUARE, shape[0], b=b)
        g = FunctionVector(Function.ABS, shape[1], c=lam)
        counts = []
        for iters in (20, 40):
            st = SolverSettings(abs_tol=0.0, rel_tol=0.0, max_iter=iters, use_fused=False,
                                use_exact_tol=exact)
            solver = GraphFormSolver(shard(A, ctx.mesh), settings=st).init()
            M.reset_stats()
            solver.solve(f, g)
            counts.append(dict(M.stats))
        out[name] = {k: (counts[1][k] - counts[0][k]) / 20 for k in counts[0]}
    # The DR iteration of the cone solve (SMW, one SOC segment across shards).
    A, b, c, _ = soc_ball()
    Ky = [ConeConstraint(Cone.SOC, range(A.shape[0]))]
    counts = []
    for iters in (21, 41):
        st = SolverSettings(abs_tol=0.0, rel_tol=0.0, max_iter=iters, polish=False)
        solver = ConeSolver(shard_matrix(A, ctx.mesh), Ky=Ky, settings=st).init()
        M.reset_stats()
        solver.solve(b, c)
        counts.append(dict(M.stats))
    out["dr"] = {k: (counts[1][k] - counts[0][k]) / 20 for k in counts[0]}
    return out


def case_fused_raises(ctx):
    from pogs_tpu_torch.parallel.mesh import shard_matrix
    from pogs_tpu_torch.solver.graph import GraphFormSolver
    from pogs_tpu_torch.types import Function, FunctionVector, SolverSettings

    A, b, lam = lasso(64, 24, 1)
    st = SolverSettings(use_fused=True)
    try:
        GraphFormSolver(shard_matrix(A, ctx.mesh), settings=st).solve(
            FunctionVector(Function.SQUARE, 64, b=b), FunctionVector(Function.ABS, 24, c=lam))
    except ValueError as exc:
        return {"raised": str(exc)}
    return {"raised": None}


def case_batch_2d(ctx):
    """A λ-path on a (2, world/2) ('batch', 'rows') mesh against the
    single-device path (the JAX test's sizes)."""
    from pogs_tpu_torch.parallel.batch import solve_lasso_path
    from pogs_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((2, ctx.world // 2), ("batch", "rows"), device="cpu")
    A, b, _ = lasso(32, 12, 2)
    lambdas = np.linspace(0.5, 0.1, 8).astype(np.float32)
    ref = solve_lasso_path(A, b, lambdas, device="cpu")
    sh = solve_lasso_path(A, b, lambdas, mesh=mesh)
    try:
        solve_lasso_path(A, b, lambdas, mesh=mesh, warm=True)
        warm = None
    except ValueError as exc:
        warm = str(exc)
    return {key: (_np(ref[key]), _np(sh[key])) for key in ref} | {"warm_raises": warm}


def case_batch_cone(ctx):
    """batched_cone_solve and batched_qp_solve with the lanes over a
    ('batch',) mesh, against the single-device batches lane for lane."""
    from pogs_tpu_torch.parallel.batch import batched_cone_solve, batched_qp_solve
    from pogs_tpu_torch.parallel.mesh import make_mesh
    from pogs_tpu_torch.types import Cone, ConeConstraint, SolverSettings

    mesh = make_mesh((ctx.world,), ("batch",), device="cpu")
    rng = np.random.default_rng(12)
    n, K = 7, 5
    c = rng.standard_normal(n)
    A = np.vstack([np.zeros((1, n)), -np.eye(n)])
    Ky = [ConeConstraint(Cone.SOC, range(n + 1))]
    x0s = rng.standard_normal((K, n))
    bb = np.concatenate([np.full((K, 1), 1.2), -x0s], axis=1)
    st = SolverSettings(abs_tol=1e-8, rel_tol=1e-8)
    ref = batched_cone_solve(A, bb, c, Ky, settings=st, device="cpu")
    sh = batched_cone_solve(A, bb, c, Ky, settings=st, mesh=mesh)
    out = {"cone": {key: (_np(ref[key]), _np(sh[key])) for key in ref}}
    nq = 6
    B = rng.normal(size=(nq, nq))
    Pq = B @ B.T + 0.5 * np.eye(nq)
    Aq = np.vstack([np.ones((1, nq)), np.eye(nq), -np.eye(nq)])
    Kq = [ConeConstraint(Cone.ZERO, [0]), ConeConstraint(Cone.NON_NEG, range(1, 1 + 2 * nq))]
    # One lane per rank at least: a batch axis of 4 takes 4 lanes or more.
    bq = np.stack([np.concatenate([[1.0 + 0.1 * k], np.ones(2 * nq)]) for k in range(4)])
    cq = rng.normal(size=(4, nq))
    stq = SolverSettings(abs_tol=1e-7, rel_tol=1e-7, max_iter=20000)
    rq = batched_qp_solve(Aq, Pq, bq, cq, Kq, settings=stq, device="cpu")
    sq = batched_qp_solve(Aq, Pq, bq, cq, Kq, settings=stq, mesh=mesh)
    out["qp"] = {key: (rq[key], sq[key]) for key in rq}
    return out


def case_parity_graph(ctx):
    """The port's row-sharded f64 graph solve, for the JAX parity test."""
    from pogs_tpu_torch.parallel.mesh import shard_matrix
    return _graph_pair(ctx, *lasso(64, 24, 1, np.float64), np.float64, shard_matrix)


def case_sparse_op(ctx):
    import torch
    from pogs_tpu_torch.parallel.sparse import shard_sparse

    A = sparse_op_matrix()
    op, m_orig = shard_sparse(A, ctx.mesh, dtype=np.float64)
    rng = np.random.default_rng(3)
    n = A.shape[1]
    x = torch.as_tensor(rng.normal(size=n))
    y = torch.as_tensor(rng.normal(size=op.shape[0]))
    d = torch.as_tensor(rng.random(op.shape[0]) + 0.5)
    e = torch.as_tensor(rng.random(n) + 0.5)
    return {"m_orig": m_orig, "shape": op.shape, "local_shape": op.local_shape,
            "mv": _np(op.gather(op.mv(x))), "rmv": _np(op.rmv(op.local(y))),
            "sq_mv": _np(op.gather(op.sq_mv(x))), "sq_rmv": _np(op.sq_rmv(op.local(y))),
            "scaled_mv": _np(op.gather(op.scale(op.local(d), e).mv(x))),
            "frob2": float(op.frob2()), "gathered": _np(op.gather_op().to_dense()),
            "x": _np(x), "y": _np(y), "d": _np(d), "e": _np(e)}


def case_sparse_lp(ctx):
    """The sparse LP through the HSDE ``cg`` strategy, solved to tolerance
    against the single-device kept-sparse solve.  (At trajectory level the
    two part by about 1e-9 after one iteration: a CG stopped at a loose
    tolerance is sensitive to the order of its sums; the polish at
    iteration 250 lands both on the same vertex.)"""
    from pogs_tpu_torch.parallel.sparse import pad_cone_rows, shard_sparse
    from pogs_tpu_torch.solver.cone import ConeSolver
    from pogs_tpu_torch.types import Cone, ConeConstraint, SolverSettings

    A, b, c = sparse_lp()
    Ky = [ConeConstraint(Cone.NON_NEG, range(A.shape[0]))]
    st = SolverSettings(abs_tol=1e-6, rel_tol=1e-6, max_iter=1500)
    ref = ConeSolver(A, Ky=Ky, settings=st, dtype=np.float64, device="cpu",
                     sparse_policy="keep").solve(b, c)
    op, _ = shard_sparse(A, ctx.mesh, dtype=np.float64)
    b_pad, Ky_pad = pad_cone_rows(b, Ky, op.shape[0])
    sh = ConeSolver(op, Ky=Ky_pad, settings=st, dtype=np.float64).solve(b_pad, c)
    return {"status": (int(ref.status), int(sh.status)),
            "iters": (int(ref.final_iter), int(sh.final_iter)),
            "x": (_np(ref.x), _np(sh.x)), "optval": (float(ref.optval), float(sh.optval)),
            "m": A.shape[0]}


def case_sparse_socp(ctx):
    """The sparse SOC ball, row-sharded, solved to tolerance (f64): the
    single-device kept-sparse solve, the closed form, and the JAX parity
    test's port side."""
    from pogs_tpu_torch.parallel.sparse import pad_cone_rows, shard_sparse
    from pogs_tpu_torch.solver.cone import ConeSolver
    from pogs_tpu_torch.types import Cone, ConeConstraint, SolverSettings

    A, b, c, expect = sparse_socp()
    Ky = [ConeConstraint(Cone.SOC, range(A.shape[0]))]
    st = SolverSettings(abs_tol=1e-5, rel_tol=1e-5)
    ref = ConeSolver(A, Ky=Ky, settings=st, dtype=np.float64, device="cpu",
                     sparse_policy="keep").solve(b, c)
    op, _ = shard_sparse(A, ctx.mesh, dtype=np.float64)
    b_pad, Ky_pad = pad_cone_rows(b, Ky, op.shape[0])
    sh = ConeSolver(op, Ky=Ky_pad, settings=st, dtype=np.float64).solve(b_pad, c)
    return {"status": (int(ref.status), int(sh.status)),
            "iters": (int(ref.final_iter), int(sh.final_iter)),
            "x": (_np(ref.x), _np(sh.x)), "optval": (float(ref.optval), float(sh.optval)),
            "expect": expect}


def case_sparse_graph(ctx):
    """A graph-form lasso on a row-sharded sparse A (the CGLS projector), at
    trajectory level (60 iterations)."""
    import scipy.sparse as sp
    from pogs_tpu_torch.parallel.sparse import shard_sparse
    from pogs_tpu_torch.solver.graph import GraphFormSolver
    from pogs_tpu_torch.types import Function, FunctionVector, SolverSettings

    A = sp.random(40, 16, density=0.3, random_state=5, format="csr")
    rng = np.random.default_rng(5)
    b = rng.standard_normal(40)
    lam = 0.2 * float(np.max(np.abs(A.T @ b)))
    f = FunctionVector(Function.SQUARE, 40, b=b)
    g = FunctionVector(Function.ABS, 16, c=lam)
    st = SolverSettings(abs_tol=1e-8, rel_tol=1e-8, max_iter=60)
    ref = GraphFormSolver(A, settings=st, dtype=np.float64, device="cpu",
                          sparse_policy="keep").solve(f, g)
    op, m_orig = shard_sparse(A, ctx.mesh, dtype=np.float64)
    assert m_orig == 40 and op.shape[0] == 40
    sh = GraphFormSolver(op, settings=st).solve(f, g)
    return {"status": (int(ref.status), int(sh.status)),
            "iters": (int(ref.final_iter), int(sh.final_iter)),
            "x": (_np(ref.x), _np(sh.x))}


# -- the column plan of the cone paths, QPs on a sharded A, checkpoints --------

def portfolio_small():
    """``benchmarks/problems.py``'s portfolio QP at 32 assets (A 34×32)."""
    from benchmarks.problems import portfolio
    return portfolio(n_assets=32, n_factors=8, seed=3)


def std_form_lp(m=24, n=64, seed=5):
    """A standard-form LP in its K_x form, min c'x s.t. A x = b, x ∈ K_x:
    K_y = ZERO on the m rows, K_x NON_NEG but for an SOC over x[28:37],
    which spans the column shards' boundary at 32 on 2 and 4 ranks."""
    from pogs_tpu_torch.types import Cone, ConeConstraint

    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    x0 = rng.random(n) + 0.1
    x0[28] = 3.0  # inside the SOC: ‖x0[29:37]‖ < 3
    b = A @ x0
    c = rng.random(n) + 0.5
    Kx = [ConeConstraint(Cone.NON_NEG, range(0, 28)), ConeConstraint(Cone.SOC, range(28, 37)),
          ConeConstraint(Cone.NON_NEG, range(37, n))]
    Ky = [ConeConstraint(Cone.ZERO, range(m))]
    return A, b, c, Kx, Ky


def _cone_pair(ctx, A, b, c, shard, st, P=None, **kw):
    """The single-device and the sharded ConeSolver solve of one problem
    (``kw`` to both solvers): status, iterations, x, y, ν and optval."""
    from pogs_tpu_torch.solver.cone import ConeSolver

    ref = ConeSolver(A, settings=st, device="cpu", **kw).solve(b, c, P=P)
    sh = ConeSolver(shard(A, ctx.mesh), settings=st, **kw).solve(b, c, P=P)
    return {"status": (int(ref.status), int(sh.status)),
            "iters": (int(ref.final_iter), int(sh.final_iter)),
            "x": (_np(ref.x), _np(sh.x)), "y": (_np(ref.y), _np(sh.y)),
            "nu": (_np(ref.nu), _np(sh.nu)), "optval": (float(ref.optval), float(sh.optval))}


def case_col_cone_soc(ctx):
    """The SOC ball on the column plan (a tall A: its Gram gathers A once),
    f32 and f64, through the HSDE path."""
    from pogs_tpu_torch.parallel.mesh import shard_matrix_cols
    from pogs_tpu_torch.types import Cone, ConeConstraint, SolverSettings

    A, b, c, expect = soc_ball()
    Ky = [ConeConstraint(Cone.SOC, range(A.shape[0]))]
    out = {"expect": expect}
    for dt, tol in ((np.float32, 1e-5), (np.float64, 1e-9)):
        out[np.dtype(dt).name] = _cone_pair(ctx, A.astype(dt), b, c, shard_matrix_cols,
                                            SolverSettings(abs_tol=tol, rel_tol=tol), Ky=Ky)
    return out


def case_col_cone_multi(ctx):
    """SOC and exponential segments on the column plan: K_x split with the
    columns against the whole set (projection, dual projection, the
    averaging hook); the HSDE solve of those cones over K_y on a tall A
    (100 iterations) and the graph-form cone path with them over K_x on a
    wide A (60 iterations), at trajectory level: the exponential
    projection is the eager loop's slowest part on the CPU."""
    import torch
    from pogs_tpu_torch.cones.sets import ConeSet, ShardedConeSet
    from pogs_tpu_torch.parallel.mesh import shard_matrix_cols
    from pogs_tpu_torch.types import Cone, ConeConstraint, SolverSettings

    rng = np.random.default_rng(4)
    n = 24
    # On 2 ranks the exponential cone 11-13 spans the boundary at 12; on 4
    # (boundaries 6, 12, 18) so do the SOCs 3-7 and 17-23.
    cones = [ConeConstraint(Cone.NON_NEG, range(0, 3)), ConeConstraint(Cone.SOC, range(3, 8)),
             ConeConstraint(Cone.EXP_PRIMAL, range(8, 11)),
             ConeConstraint(Cone.EXP_PRIMAL, range(11, 14)), ConeConstraint(Cone.SOC, range(14, 17)),
             ConeConstraint(Cone.SOC, range(17, 24))]
    whole_set = ConeSet(cones, n)
    W = rng.standard_normal((10, n))
    op = shard_matrix_cols(W, ctx.mesh, dtype=torch.float64)
    sharded = ShardedConeSet(whole_set, op)
    v = torch.as_tensor(rng.standard_normal(n))
    w = torch.as_tensor(rng.random(n) + 0.5)
    out = {"proj": (_np(whole_set.project(v)), _np(op.gather(sharded.project(op.local(v))))),
           "dual": (_np(whole_set.dual().project(v)),
                    _np(op.gather(sharded.dual().project(op.local(v))))),
           "avg": (_np(whole_set.constrain_average(w)),
                   _np(op.gather(sharded.constrain_average(op.local(w)))))}
    # The HSDE path: the cones over K_y of a tall A, on the column plan.
    A = rng.standard_normal((n, 8))
    x0 = rng.standard_normal(8)
    s0 = np.asarray(whole_set.project(torch.as_tensor(rng.standard_normal(n)))) + 0.0
    s0[0:3] += 1.0
    s0[3] += 2.0
    b = A @ x0 + s0
    c = -A.T @ np.asarray(whole_set.dual().project(torch.as_tensor(rng.standard_normal(n))))
    out["hsde"] = _cone_pair(ctx, A, b, c, shard_matrix_cols,
                             SolverSettings(abs_tol=0.0, rel_tol=0.0, max_iter=100), Ky=cones)
    # The graph-form path: the cones over K_x of a wide A (A x = b).
    xg = np.asarray(whole_set.project(torch.as_tensor(rng.standard_normal(n)))) + 0.0
    xg[0:3] += 1.0
    Kz = [ConeConstraint(Cone.ZERO, range(10))]
    out["graph"] = _cone_pair(ctx, W, W @ xg, rng.random(n), shard_matrix_cols,
                              SolverSettings(abs_tol=1e-6, rel_tol=1e-6, max_iter=60),
                              Kx=cones, Ky=Kz)
    return out


def case_hsde_lp(ctx):
    """Inequality LPs through the HSDE path, f64: a wide one (12×30) on
    each plan, SMW by Woodbury through the reduced 12×12 Gram on the
    column plan and through the gathered one on the row plan; and
    ``cone_lp_polish``'s tall one (64×16) on the column plan, whose
    interior-point burst runs whole on every rank on the gathered A."""
    from pogs_tpu_torch.parallel.mesh import shard_matrix, shard_matrix_cols
    from pogs_tpu_torch.types import Cone, ConeConstraint, SolverSettings

    rng = np.random.default_rng(2)
    A = rng.standard_normal((12, 30))
    b = A @ rng.standard_normal(30) + rng.random(12) + 0.1
    c = -A.T @ (rng.random(12) + 0.1)
    Ky = [ConeConstraint(Cone.NON_NEG, range(12))]
    st = SolverSettings(abs_tol=1e-8, rel_tol=1e-8, max_iter=3000)
    out = {plan: _cone_pair(ctx, A, b, c, shard, st, Ky=Ky)
           for plan, shard in (("rows", shard_matrix), ("cols", shard_matrix_cols))}
    rng = np.random.default_rng(31)
    A = rng.standard_normal((64, 16))
    b = A @ rng.standard_normal(16) + np.abs(rng.standard_normal(64))
    c = -A.T @ np.abs(rng.standard_normal(64))
    out["polish_cols"] = _cone_pair(
        ctx, A, b, c, shard_matrix_cols, SolverSettings(abs_tol=1e-9, rel_tol=1e-9, max_iter=2000),
        Ky=[ConeConstraint(Cone.NON_NEG, range(64))])
    return out


def case_col_cone_lp(ctx):
    """The 24×64 standard-form LP (K_x = NON_NEG with an SOC across the
    column shards) through the graph-form cone path on the column plan that
    ``auto_shard`` picks, to tolerance, f64."""
    from pogs_tpu_torch.parallel.mesh import auto_shard
    from pogs_tpu_torch.types import SolverSettings

    A, b, c, Kx, Ky = std_form_lp()
    out = _cone_pair(ctx, A, b, c, auto_shard, SolverSettings(abs_tol=1e-6, rel_tol=1e-6),
                     Kx=Kx, Ky=Ky)
    out["plan"] = auto_shard(A, ctx.mesh).plan
    return out


def case_hsde_p(ctx):
    """``hsde_solve`` with a dense P on the row and the column plan, tall
    and wide through SMW (60 iterations), tall through cg (20), against
    the single-device loop at trajectory level (tolerance 0, f64): the
    whole w.  (The inner CG's tolerance follows the fixed-point residual:
    in the first ten DR iterations it stops loosely enough for the order
    of its sums to show at 1e-8, as on the row plan without P.)"""
    import torch
    from pogs_tpu_torch.cones.sets import ConeSet
    from pogs_tpu_torch.linalg.matrix import part, whole
    from pogs_tpu_torch.parallel.mesh import shard_matrix, shard_matrix_cols
    from pogs_tpu_torch.solver.hsde import hsde_solve
    from pogs_tpu_torch.types import Cone, ConeConstraint

    rng = np.random.default_rng(17)
    out = {}
    for shape in ((20, 12), (12, 20)):
        m, n = shape
        A = rng.standard_normal(shape)
        b = rng.standard_normal(m) + 1.0
        c = rng.standard_normal(n)
        B = rng.standard_normal((n, n))
        P = torch.as_tensor(B @ B.T / n)
        Ky = ConeSet([ConeConstraint(Cone.NON_NEG, range(m))], m)
        for strategy, iters in (("smw", 60), ("cg", 20)) if m > n else (("smw", 60),):
            kw = {"abs_tol": 0.0, "rel_tol": 0.0, "max_iter": iters}
            ref = hsde_solve(torch.as_tensor(A), torch.as_tensor(b), torch.as_tensor(c), Ky,
                             P=P, strategy=strategy, **kw)
            for plan, shard in (("rows", shard_matrix), ("cols", shard_matrix_cols)):
                op = shard(A, ctx.mesh)
                _, n_loc = op.local_shape
                sh = hsde_solve(op, part(op, "m", torch.as_tensor(b)),
                                part(op, "n", torch.as_tensor(c)), Ky, P=P, strategy=strategy,
                                **kw)
                w = sh["w"]
                w_whole = torch.cat([whole(op, "n", w[:n_loc]), whole(op, "m", w[n_loc:-1]),
                                     w[-1:]])
                out[(shape, strategy, plan)] = {
                    "status": (int(ref["status"]), int(sh["status"])),
                    "iters": (int(ref["final_iter"]), int(sh["final_iter"])),
                    "w": (_np(ref["w"]), _np(w_whole))}
    return out


QP_ROUTES = {"ipm": ("socp", True), "socp": ("socp", False), "admm": ("admm", True),
             "admm_nopolish": ("admm", False)}


def case_qp_routes(ctx):
    """The portfolio QP (34×32) on the row and the column plan through each
    QP route, f64, against the single-device route; and with P's diagonal
    alone (the diagonal forms of the epigraph factor and the x-prox)
    through the ``socp`` and ``admm`` routes."""
    from pogs_tpu_torch.parallel.mesh import shard_matrix, shard_matrix_cols
    from pogs_tpu_torch.api.cone import dims_to_cones
    from pogs_tpu_torch.types import SolverSettings

    q = portfolio_small()
    Ky = dims_to_cones(q["dims"])
    out = {}
    for route, (via, polish) in QP_ROUTES.items():
        st = SolverSettings(abs_tol=1e-7, rel_tol=1e-7, max_iter=20000, polish=polish)
        for plan, shard in (("rows", shard_matrix), ("cols", shard_matrix_cols)):
            out[(route, plan)] = _cone_pair(ctx, q["A"], q["b"], q["c"], shard, st, P=q["P"],
                                            Ky=Ky, qp_via=via)
            if route in ("socp", "admm"):
                out[(route + "_diag", plan)] = _cone_pair(
                    ctx, q["A"], q["b"], q["c"], shard, st, P=np.diag(q["P"]).copy(), Ky=Ky,
                    qp_via=via)
    return out


def case_direct_raises(ctx):
    """The direct strategy (and its inverse variant) refuses a sharded A on
    either plan."""
    from pogs_tpu_torch.parallel.mesh import shard_matrix, shard_matrix_cols
    from pogs_tpu_torch.solver.cone import ConeSolver
    from pogs_tpu_torch.types import Cone, ConeConstraint

    A, b, c, _ = soc_ball()
    Ky = [ConeConstraint(Cone.SOC, range(A.shape[0]))]
    out = {}
    for plan, shard in (("rows", shard_matrix), ("cols", shard_matrix_cols)):
        for strategy in ("direct", "inverse"):
            try:
                ConeSolver(shard(A, ctx.mesh), Ky=Ky, strategy=strategy).solve(b, c)
                out[(plan, strategy)] = None
            except ValueError as exc:
                out[(plan, strategy)] = str(exc)
    return out


CKPT_ITERS = 40


def ckpt_problem():
    """The checkpoint cases' lasso (f64) and settings: a first solve cut at
    ``CKPT_ITERS`` iterations, then a resumed one to tolerance."""
    A, b, lam = lasso(64, 24, 19, np.float64)
    return A, b, lam


def _ckpt_solver(A, b, lam, mesh=None, shard=None, max_iter=None):
    from pogs_tpu_torch.solver.graph import GraphFormSolver
    from pogs_tpu_torch.types import Function, FunctionVector, SolverSettings

    st = SolverSettings(abs_tol=1e-8, rel_tol=1e-8, use_fused=False,
                        **({} if max_iter is None else {"max_iter": max_iter}))
    f = FunctionVector(Function.SQUARE, A.shape[0], b=b)
    g = FunctionVector(Function.ABS, A.shape[1], c=lam)
    solver = (GraphFormSolver(A, settings=st, device="cpu") if shard is None
              else GraphFormSolver(shard(A, mesh), settings=st))
    return solver, f, g


def _res(r):
    return {"status": int(r.status), "iters": int(r.final_iter), "x": _np(r.x),
            "optval": float(r.optval)}


def case_checkpoint(ctx):
    """Checkpoints across a mesh and one device, both plans, f64:

    * ``to_one``: a sharded solve cut at ``CKPT_ITERS`` iterations is saved
      (rank 0 writes) and resumed in a fresh single-device solver; the
      sharded solver's own continuation is the uninterrupted solve;
    * ``to_mesh``: the reverse, a single-device checkpoint resumed in a
      fresh sharded solver, against the single-device continuation;
    * ``from_jax``: a checkpoint the JAX package wrote on one device (the
      parent's, ``ctx.data["jax_ckpt"]``) resumed in a sharded solver.

    The file of ``to_one`` stays for the parent to resume in the JAX
    package."""
    import torch
    from pogs_tpu_torch.parallel.mesh import all_reduce, shard_matrix, shard_matrix_cols

    A, b, lam = ckpt_problem()
    out = {}
    for plan, shard in (("rows", shard_matrix), ("cols", shard_matrix_cols)):
        path = os.path.join(ctx.tmp, f"ckpt_{plan}_{ctx.world}.npz")
        sh, f, g = _ckpt_solver(A, b, lam, ctx.mesh, shard, max_iter=CKPT_ITERS)
        cut = sh.solve(f, g)
        sh.save_state(path)
        one, _, _ = _ckpt_solver(A, b, lam)
        resumed = one.load_state(path).solve(f, g)
        cont = sh.solve(f, g, settings=one.settings)
        out[(plan, "to_one")] = {"cut": _res(cut), "resumed": _res(resumed),
                                 "uninterrupted": _res(cont), "path": path}
        # The reverse: every rank runs the single-device solve, rank 0's
        # file is the one read.
        one, _, _ = _ckpt_solver(A, b, lam, max_iter=CKPT_ITERS)
        one.solve(f, g)
        path1 = os.path.join(ctx.tmp, f"ckpt1_{plan}_{ctx.world}.npz")
        if ctx.rank == 0:
            one.save_state(path1)
        all_reduce(torch.zeros(1), None, "small")
        sh, _, _ = _ckpt_solver(A, b, lam, ctx.mesh, shard)
        resumed = sh.load_state(path1).solve(f, g)
        cont = one.solve(f, g, settings=sh.settings)
        out[(plan, "to_mesh")] = {"resumed": _res(resumed), "uninterrupted": _res(cont)}
        jax_ckpt = ctx.data.get("jax_ckpt")
        if jax_ckpt is not None:
            sh, _, _ = _ckpt_solver(A, b, lam, ctx.mesh, shard)
            out[(plan, "from_jax")] = _res(sh.load_state(jax_ckpt).solve(f, g))
    return out


def _per_rank(ctx, value):
    """Every rank's ``value`` (a number), as a list in rank order."""
    import torch
    from pogs_tpu_torch.parallel.mesh import all_reduce

    t = torch.zeros(ctx.world, dtype=torch.float64, device=ctx.mesh.device)
    t[ctx.rank] = float(value)
    return all_reduce(t, None).cpu().tolist()


def case_card_row(ctx):
    """On the card (two ranks sharing it under gloo): a row-sharded lasso in
    f32 and f64 against the single-device eager loop, and no kernel
    launch (a sharded single solve runs the eager loop)."""
    from pogs_tpu_torch.ops.fused_admm import fused_admm_loop
    from pogs_tpu_torch.parallel.mesh import shard_matrix
    from pogs_tpu_torch.solver.graph import GraphFormSolver
    from pogs_tpu_torch.types import Function, FunctionVector, SolverSettings

    out = {}
    for dt, tol in ((np.float32, 1e-4), (np.float64, 1e-8)):
        A, b, lam = lasso(200, 100, 3, dt)
        f = FunctionVector(Function.SQUARE, 200, b=b)
        g = FunctionVector(Function.ABS, 100, c=lam)
        st = SolverSettings(abs_tol=tol, rel_tol=tol, use_fused=False)
        ref = GraphFormSolver(A, settings=st, device=ctx.mesh.device).solve(f, g)
        before = fused_admm_loop.launches
        sh = GraphFormSolver(shard_matrix(A, ctx.mesh), settings=st).solve(f, g)
        out[np.dtype(dt).name] = {
            "status": (int(ref.status), int(sh.status)),
            "iters": (int(ref.final_iter), int(sh.final_iter)),
            "x": (_np(ref.x), _np(sh.x)), "launches": fused_admm_loop.launches - before,
            "device": str(sh.x.device)}
    return out


def case_card_batches(ctx):
    """On the card, a (world, 1) ('batch', 'rows') mesh: a λ-sweep through
    one K2 launch per rank and a cone batch through one K3 launch per lane
    of the rank, each lane equal to the single-device run's (launches of
    the comparison runs not counted)."""
    from pogs_tpu_torch.ops.fused_admm_batch import fused_batched_lasso_sweep as k2
    from pogs_tpu_torch.ops.fused_hsde import fused_hsde_solve as k3
    from pogs_tpu_torch.parallel.batch import batched_cone_solve, solve_lasso_path
    from pogs_tpu_torch.parallel.mesh import make_mesh
    from pogs_tpu_torch.types import Cone, ConeConstraint, SolverSettings

    dev = ctx.mesh.device
    mesh = make_mesh((ctx.world, 1), ("batch", "rows"), device=dev)
    A, b, lam = lasso(200, 100, 4)
    lambdas = (np.linspace(1.0, 0.5, 16) * lam).astype(np.float32)
    st = SolverSettings(abs_tol=1e-4, rel_tol=5e-4)
    A_c, b_c, c_c, _ = soc_ball()
    rng = np.random.default_rng(6)
    bb = b_c[None, :] * (1.0 + 0.02 * rng.standard_normal((4, 1)))
    Ky = [ConeConstraint(Cone.SOC, range(A_c.shape[0]))]
    st_c = SolverSettings(abs_tol=1e-6, rel_tol=1e-6)
    k2_0, k3_0 = k2.launches, k3.launches
    sweep = solve_lasso_path(A, b, lambdas, settings=st, mesh=mesh)
    cone = batched_cone_solve(A_c, bb, c_c, Ky, settings=st_c, mesh=mesh)
    k2_n, k3_n = k2.launches - k2_0, k3.launches - k3_0
    ref = solve_lasso_path(A, b, lambdas, settings=st, device=dev)
    ref_c = batched_cone_solve(A_c, bb, c_c, Ky, settings=st_c, device=dev)
    return {"k2": _per_rank(ctx, k2_n), "k3": _per_rank(ctx, k3_n),
            "sweep": {key: (_np(ref[key]), _np(sweep[key])) for key in ref},
            "cone": {key: (_np(ref_c[key]), _np(cone[key])) for key in ref_c}}


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


# -- the group ------------------------------------------------------------------

class Ctx:
    """A rank's view: its rank, the world size, its 1-D ('rows',) mesh, a
    directory every rank of the group sees (``tmp``) and the parent's
    ``data``."""

    def __init__(self, rank, world, mesh, tmp, data):
        self.rank, self.world, self.mesh = rank, world, mesh
        self.tmp, self.data = tmp, data


def _worker(rank, world, store_path, names, out_path, device, data):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from pogs_tpu_torch.parallel import mesh as M

    M.init_distributed(store=dist.FileStore(store_path, world), world_size=world, rank=rank,
                       backend="gloo", timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    ctx = Ctx(rank, world, M.make_mesh((world,), ("rows",), device=device),
              os.path.dirname(store_path), data)
    results = {}
    for name in names:
        t0 = time.perf_counter()
        try:
            results[name] = {"ok": True, "value": CASES[name](ctx)}
        except Exception:  # the parent reports it, with the case's name
            results[name] = {"ok": False, "error": traceback.format_exc()}
        results[name]["seconds"] = time.perf_counter() - t0
    results["_jax_loaded"] = "jax" in __import__("sys").modules
    if rank == 0:
        with open(out_path, "wb") as fh:
            pickle.dump(results, fh)
    dist.destroy_process_group()


def run_group(world: int, names, device: str = "cpu", data=None, tmp=None) -> dict:
    """Run the named cases in ``world`` spawned gloo ranks whose mesh holds
    its tensors on ``device``; rank 0's results.  ``data`` (plain values)
    reaches every case as ``ctx.data``; ``tmp``, a directory, is
    ``ctx.tmp`` (a temporary one by default), where cases may leave files
    for the parent."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as scratch:
        tmp = tmp or scratch
        store = os.path.join(tmp, f"store_{world}")
        out = os.path.join(tmp, f"results_{world}.pkl")
        env = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            procs = [ctx.Process(target=_worker,
                                 args=(r, world, store, list(names), out, device, data or {}))
                     for r in range(world)]
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        if hung:
            raise TimeoutError(f"{len(hung)} of {world} ranks still ran after {JOIN_TIMEOUT_S} s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"ranks exited with {codes}")
        with open(out, "rb") as fh:
            return pickle.load(fh)
