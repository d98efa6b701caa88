"""The solve kernel, the batched kernel and the cone kernel on the card
against their plain versions.

Marked ``cuda``: every test skips where torch sees no CUDA device.  On a
machine with one:  python -m pytest tests/test_torch_cuda.py -q

Tolerances, kernel against its plain version on the same card and inputs
(per lane for the batched kernel): the same status, iterations within 2
(the kernel sums in another order), optval within 1e-4 relative, x12 and z
within 5e-5·max(1, ‖·‖∞).  The cone kernel (K3) against its plain version:
at trajectory level the same status, iterations within 2, w within
1e-5·max(1, ‖w‖∞) in float32 and 1e-9·max(1, ‖w‖∞) in float64; float32
runs of 800 or more plain-version iterations against the float64 solve
(see ``test_cone_kernel_matches_plain``).  The differentiable layers in
float64, their forwards through K1 and K3 against the eager forwards: the
same status and iterations, x within 1e-12·max(1, ‖x‖∞), the gradients
within rtol 1e-8.
"""

import ctypes
import importlib.util
import os

import numpy as np
import pytest
import torch

import pogs_tpu_torch as P
from pogs_tpu_torch.ops import fused_admm as pf
from pogs_tpu_torch.ops import fused_admm_batch as pb
from pogs_tpu_torch.ops import fused_hsde as ph
from pogs_tpu_torch.parallel import batched_graph_solve

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """chip_smoke.py, loaded by path, for its cone problem generators."""
    spec = importlib.util.spec_from_file_location("_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(A, f, g, dtype):
    from pogs_tpu_torch.prox.vector import scale_f, scale_g

    solver = P.GraphFormSolver(A, dtype=dtype, device="cuda").init()
    st = solver._init_state

    def cast(fv):
        return fv.replace_params(*(p.to(device="cuda", dtype=dtype) for p in fv.params))

    return st, scale_f(cast(f), st["d"]), scale_g(cast(g), st["e"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [(60, 40), (30, 70)], ids=["tall", "wide"])
def test_kernel_matches_plain(cuda, shape, dtype):
    rng = np.random.default_rng(7)
    m, n = shape
    A = rng.standard_normal(shape)
    f = P.FunctionVector(P.Function.SQUARE, m, b=rng.standard_normal(m))
    g = P.FunctionVector(P.Function.ABS, n, c=0.4)
    st, f_s, g_s = _inputs(A, f, g, dtype)
    z0 = torch.zeros(m + n, dtype=dtype, device=cuda)
    args = (st["A"], st["factor"]["op"], st["norm_A"], f.h, tuple(f_s.params),
            g.h, tuple(g_s.params), P.SolverSettings(max_iter=500), z0, z0, 1.0)
    before = pf.fused_admm_loop.launches
    out = pf.fused_admm_loop(*args)
    ref = pf.fused_admm_loop_ref(*args)
    torch.cuda.synchronize()
    assert pf.fused_admm_loop.launches == before + 1
    assert int(out["status"]) == int(ref["status"]) == 0
    assert abs(int(out["final_iter"]) - int(ref["final_iter"])) <= 2
    assert float(out["optval"]) == pytest.approx(float(ref["optval"]), rel=1e-4)
    for key in ("x12", "z"):
        lim = 5e-5 * max(1.0, float(ref[key].abs().max()))
        assert float((out[key] - ref[key]).abs().max()) <= lim


def test_main_path_launches_kernel_once_per_solve(cuda):
    rng = np.random.default_rng(1)
    A = rng.standard_normal((80, 50)).astype(np.float32)
    b = rng.standard_normal(80).astype(np.float32)
    before = pf.fused_admm_loop.launches
    r = P.solve_lasso(A, b, 0.2 * float(np.max(np.abs(A.T @ b))))
    assert pf.fused_admm_loop.launches == before + 1
    assert r["status"] == int(P.Status.SUCCESS)


def _admm_args(cuda, A, f, g, dtype, settings):
    st, f_s, g_s = _inputs(A, f, g, dtype)
    m, n = A.shape
    z0 = torch.zeros(m + n, dtype=dtype, device=cuda)
    return (st["A"], st["factor"]["op"], st["norm_A"], f.h, tuple(f_s.params), g.h,
            tuple(g_s.params), settings, z0, z0, 1.0), st["At"]


def _admm_lasso(cuda, shape, dtype, seed=7, settings=None):
    rng = np.random.default_rng(seed)
    m, n = shape
    A = rng.standard_normal(shape)
    b = rng.standard_normal(m)
    f = P.FunctionVector(P.Function.SQUARE, m, b=b)
    g = P.FunctionVector(P.Function.ABS, n, c=0.1 * float(np.max(np.abs(A.T @ b))))
    return _admm_args(cuda, A, f, g, dtype, settings or P.SolverSettings(max_iter=1000))


def _admm_plan(args):
    A = args[0]
    return pf.launch_plan(pf._lib(), A.device, A.dtype, A.shape[0], A.shape[1], args[3],
                          args[5])


def _assert_admm_match(args, At):
    """K1 against its plain version as test_kernel_matches_plain holds it:
    the same status, iterations within 2, optval within 1e-4, x12 and z
    within 5e-5·max(1, ‖·‖∞); one launch."""
    before = pf.fused_admm_loop.launches
    out = pf.fused_admm_loop(*args, At=At)
    ref = pf.fused_admm_loop_ref(*args)
    torch.cuda.synchronize()
    assert pf.fused_admm_loop.launches == before + 1
    assert int(out["status"]) == int(ref["status"])
    assert abs(int(out["final_iter"]) - int(ref["final_iter"])) <= 2
    assert float(out["optval"]) == pytest.approx(float(ref["optval"]), rel=1e-4)
    for key in ("x12", "z"):
        lim = 5e-5 * max(1.0, float(ref[key].abs().max()))
        assert float((out[key] - ref[key]).abs().max()) <= lim
    return out, ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [(60, 40), (40, 60), (500, 300), (300, 500)],
                         ids=["one_block_tall", "one_block_wide", "many_blocks_tall",
                              "many_blocks_wide"])
def test_admm_plan_grids_match_plain(cuda, shape, dtype):
    """The plan's own grid: one block (barriers are __syncthreads) below the
    threshold, many blocks beyond, tall and wide."""
    args, At = _admm_lasso(cuda, shape, dtype)
    plan = _admm_plan(args)
    assert (plan["blocks"] == 1) == (max(shape) < 100)
    assert plan["barriers_per_iter"] == 3
    out, ref = _assert_admm_match(args, At)
    assert int(ref["status"]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("blocks", [1, 16])
def test_admm_forced_grids_match_plain(cuda, blocks, dtype, monkeypatch):
    """The bench size on grids the plan does not pick: one block (its 500
    rows of A in four groups of at most 128) and 16 blocks."""
    monkeypatch.setattr(pf, "blocks_for", lambda m, n, sms: blocks)
    args, At = _admm_lasso(cuda, (500, 300), dtype)
    assert _admm_plan(args)["blocks"] == blocks
    _assert_admm_match(args, At)


@pytest.mark.parametrize("shared", [True, False], ids=["shared_side", "four_barriers"])
def test_admm_logistic_shared_side_matches_plain(cuda, shared, monkeypatch):
    """Logistic 2000x1000 in f64 with every block computing all 2000
    logistic proxes (4 per thread; forced, the plan keeps 4 barriers there)
    and in the four-barrier order."""
    monkeypatch.setattr(pf, "shared_side_for", lambda iterative: shared)
    rng = np.random.default_rng(11)
    A = rng.standard_normal((2000, 1000))
    f = P.FunctionVector(P.Function.LOGISTIC, 2000, a=-np.sign(rng.standard_normal(2000)))
    g = P.FunctionVector(P.Function.ABS, 1000, c=0.2)
    args, At = _admm_args(cuda, A, f, g, torch.float64, P.SolverSettings(max_iter=1000))
    plan = _admm_plan(args)
    assert plan["shared_side"] == shared and plan["blocks"] > 1
    assert plan["barriers_per_iter"] == (3 if shared else 4)
    _assert_admm_match(args, At)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [(90, 37), (37, 90)], ids=["tall", "wide"])
def test_admm_column_tiles_match_plain(cuda, shape, dtype, monkeypatch):
    """Products in column tiles, as every problem whose vectors do not fit
    in shared memory runs them: 256 (f32) or 512 (f64) bytes of shared
    memory, 64 columns per tile, on 3 blocks."""
    itemsize = 4 if dtype == torch.float32 else 8
    monkeypatch.setattr(pf, "SMEM_BUDGET", 64 * itemsize)
    monkeypatch.setattr(pf, "blocks_for", lambda m, n, sms: 3)
    args, At = _admm_lasso(cuda, shape, dtype)
    plan = _admm_plan(args)
    assert plan["xs"] == 64 < max(shape)
    assert not plan["shared_side"] and plan["blocks"] == 3
    _assert_admm_match(args, At)


def test_admm_plan_smem_matches_the_kernel(cuda):
    """admm_plan's shared memory is what the kernel lays out."""
    lib = pf._lib()
    for m, n in ((60, 40), (40, 60), (500, 300), (300, 500), (5000, 2500), (20000, 5000),
                 (2_000_000, 20)):
        for itemsize in (4, 8):
            for sms in (132, 8):
                plan = pf.admm_plan(m, n, itemsize, sms, sms)
                assert lib.pogs_fused_admm_smem_bytes(
                    int(itemsize == 8), m, n, plan["xs"],
                    int(plan["shared_side"]), int(plan["one_pass"]),
                    plan["blocks"]) == plan["smem"]


def _one_pass_fallbacks(out):
    """The spectral fallbacks of a one-pass solve: its passes over A beyond
    one an iteration, the first iteration's plain Aᵀ pass and two per check,
    at most one per spectral slot (k > 0, k % 50 == 0)."""
    iters = int(out["final_iter"]) + 1
    extra = int(out["a_passes"]) - iters - 1 - 2 * int(out["checks"])
    assert 0 <= extra <= (iters - 1) // 50
    return extra


def _forced_plain(monkeypatch):
    monkeypatch.setattr(pf, "one_pass_for", lambda m, n, itemsize, iterative=0: False)


@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive_rho", "fixed_rho"])
def test_admm_one_pass_matches_plain(cuda, adaptive, monkeypatch):
    """A tall f32 lasso beyond the one pass's boundary (6000x3000: 108 MB of
    A and Ginv) with adaptive ρ on and off.  With ρ fixed every step keeps
    its candidate: a_passes is exactly iterations + 1 (the plain Aᵀ pass at
    k = 0) + 2 × checks, and the same problem on the plain route makes
    2 × iterations + 2 × checks."""
    args, At = _admm_lasso(cuda, (6000, 3000), torch.float32,
                           settings=P.SolverSettings(max_iter=2000, adaptive_rho=adaptive))
    plan = _admm_plan(args)
    assert plan["one_pass"] and plan["barriers_per_iter"] == 3 and plan["blocks"] > 1
    out, ref = _assert_admm_match(args, At)
    assert int(ref["status"]) == 0 and int(out["checks"]) >= 1
    fallbacks = _one_pass_fallbacks(out)
    if not adaptive:
        assert fallbacks == 0
        iters = int(out["final_iter"]) + 1
        assert int(out["a_passes"]) == iters + 1 + 2 * int(out["checks"])
        _forced_plain(monkeypatch)
        plain, _ = _assert_admm_match(args, At)
        iters = int(plain["final_iter"]) + 1
        assert int(plain["a_passes"]) == 2 * iters + 2 * int(plain["checks"])


def test_admm_one_pass_counts_its_passes(cuda, monkeypatch):
    """At tolerance 0 (no check, no spectral step) a_passes is exactly
    iterations + 1 on the one pass and 2 × iterations on the plain route,
    the same problem forced off it; the two routes agree."""
    args, At = _admm_lasso(cuda, (6000, 3000), torch.float32,
                           settings=P.SolverSettings(abs_tol=0.0, rel_tol=0.0, max_iter=60))
    out, _ = _assert_admm_match(args, At)
    assert int(out["final_iter"]) == 59 and int(out["checks"]) == 0
    assert int(out["a_passes"]) == 60 + 1
    _forced_plain(monkeypatch)
    assert not _admm_plan(args)["one_pass"]
    plain, _ = _assert_admm_match(args, At)
    assert int(plain["a_passes"]) == 2 * 60 and int(plain["checks"]) == 0
    lim = 5e-5 * max(1.0, float(plain["x12"].abs().max()))
    assert float((out["x12"] - plain["x12"]).abs().max()) <= lim


# A logistic f in f32 at 5000x2500 (‖x12‖∞ = 9.13): the plain route parts
# from the plain version's x12 and z by 5.39e-5 and 5.91e-5·‖·‖∞, the one
# pass by 5.18e-5 and 4.52e-5 (an NVIDIA H100 80GB HBM3), beyond the file's
# 5e-5; this limit holds both with room.
LOGISTIC_F32_LIMIT = 1e-4


def test_admm_one_pass_logistic_matches_plain(cuda, monkeypatch):
    """A logistic f beyond the boundary, forced onto the one pass (the plan
    keeps an iterative f prox off it): the candidates' y-side prox is the
    guarded Newton iteration, run three times a row.  Both routes against
    the plain version: the same status, iterations within 2, optval within
    1e-4, x12 and z within LOGISTIC_F32_LIMIT·max(1, ‖·‖∞)."""
    rng = np.random.default_rng(11)
    A = rng.standard_normal((5000, 2500))
    f = P.FunctionVector(P.Function.LOGISTIC, 5000, a=-np.sign(rng.standard_normal(5000)))
    g = P.FunctionVector(P.Function.ABS, 2500, c=0.2)
    args, At = _admm_args(cuda, A, f, g, torch.float32, P.SolverSettings(max_iter=1000))
    ref = pf.fused_admm_loop_ref(*args)
    assert int(ref["status"]) == 0
    assert not _admm_plan(args)["one_pass"]
    plain = pf.fused_admm_loop(*args, At=At)
    monkeypatch.setattr(pf, "one_pass_for", lambda m, n, itemsize, iterative=0: True)
    assert _admm_plan(args)["one_pass"]
    out = pf.fused_admm_loop(*args, At=At)
    dist = {}
    for route, o in (("plain", plain), ("one_pass", out)):
        assert int(o["status"]) == int(ref["status"])
        assert abs(int(o["final_iter"]) - int(ref["final_iter"])) <= 2
        assert float(o["optval"]) == pytest.approx(float(ref["optval"]), rel=1e-4)
        for key in ("x12", "z"):
            scale = max(1.0, float(ref[key].abs().max()))
            dist[route, key] = float((o[key] - ref[key]).abs().max()) / scale
    assert max(dist.values()) <= LOGISTIC_F32_LIMIT, dist
    _one_pass_fallbacks(out)


def test_admm_one_pass_max_iter(cuda):
    """A max_iter stop on the one pass: MAX_ITER after 7 iterations, one
    pass each and the first iteration's plain Aᵀ pass."""
    args, At = _admm_lasso(cuda, (6000, 3000), torch.float32,
                           settings=P.SolverSettings(max_iter=7))
    out, _ = _assert_admm_match(args, At)
    assert int(out["status"]) == int(P.Status.MAX_ITER) and int(out["final_iter"]) == 6
    assert int(out["a_passes"]) == 8 + 2 * int(out["checks"])


@pytest.mark.parametrize("shape,blocks", [((90, 37), 3), ((90, 37), 132), ((61, 61), 1),
                                          ((500, 300), 132), ((2001, 999), 16)],
                         ids=["ragged_3", "ragged_132", "square_1", "bench_132", "odd_16"])
def test_admm_one_pass_forced_matches_plain(cuda, shape, blocks, monkeypatch):
    """The one pass forced onto f32 shapes the plan keeps in L2: rows that
    do not start on 16 bytes (n = 37, 61, 999), blocks with no rows or an
    odd count, one block, and the x side spread over more blocks than it
    has elements."""
    monkeypatch.setattr(pf, "one_pass_for", lambda m, n, itemsize, iterative=0: m >= n)
    monkeypatch.setattr(pf, "blocks_for", lambda m, n, sms: blocks)
    args, At = _admm_lasso(cuda, shape, torch.float32)
    plan = _admm_plan(args)
    assert plan["one_pass"] and plan["blocks"] == blocks
    out, _ = _assert_admm_match(args, At)
    _one_pass_fallbacks(out)


def test_admm_one_pass_refuses_f64(cuda):
    """The one pass is built for f32 alone: a launch that asks for it in
    f64 is refused, and so is the occupancy query."""
    lib = pf._lib()
    per_sm = ctypes.c_int(0)
    assert lib.pogs_fused_admm_blocks_per_sm(1, cuda.index or 0, 0, 1,
                                             ctypes.byref(per_sm)) != 0
    assert lib.pogs_fused_admm_blocks_per_sm(1, cuda.index or 0, 0, 0,
                                             ctypes.byref(per_sm)) == 0


def _sweep_args(cuda, shape, dtype, K, seed=7):
    rng = np.random.default_rng(seed)
    m, n = shape
    A = rng.standard_normal(shape)
    b = rng.standard_normal(m)
    lam_max = float(np.max(np.abs(A.T @ b)))
    f = P.FunctionVector(P.Function.SQUARE, m, b=b)
    g = P.FunctionVector(P.Function.ABS, n)
    st, f_s, g_s = _inputs(A, f, g, dtype)
    lams = np.geomspace(0.5, 0.1, K) * lam_max
    cb = torch.tensor(np.repeat(lams[:, None], n, axis=1), dtype=dtype, device=cuda)
    return (st["A"], st["factor"]["op"], st["norm_A"], f.h, tuple(f_s.params), g.h,
            tuple(g_s.params), cb, P.SolverSettings(max_iter=500), 1.0)


def _assert_lanes_match(out, ref):
    assert torch.equal(out["status"], ref["status"])
    assert int((out["final_iter"] - ref["final_iter"]).abs().max()) <= 2
    rel = (out["optval"] - ref["optval"]).abs() / ref["optval"].abs().clamp(min=1e-12)
    assert float(rel.max()) <= 1e-4
    lim = 5e-5 * max(1.0, float(ref["x12"].abs().max()))
    assert float((out["x12"] - ref["x12"]).abs().max()) <= lim


def _force_plan(monkeypatch, C, in_smem=True):
    """Run the resident kernel on clusters of C blocks, whatever
    cluster_plan would pick."""
    layout = pb.cluster_layout
    monkeypatch.setattr(pb, "route_for", lambda m, n, itemsize, K: "resident")
    monkeypatch.setattr(pb, "cluster_plan",
                        lambda m, n, itemsize: layout(m, n, itemsize, C, in_smem))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [(60, 40), (30, 70)], ids=["tall", "wide"])
def test_batch_kernel_matches_plain(cuda, shape, dtype, monkeypatch):
    """The resident kernel (csrc/fused_admm_batch.cu) on its plan against
    the plain version."""
    monkeypatch.setattr(pb, "route_for", lambda m, n, itemsize, K: "resident")
    args = _sweep_args(cuda, shape, dtype, 6)
    before = pb.fused_batched_lasso_sweep.launches
    out = pb.fused_batched_lasso_sweep(*args)
    ref = pb.fused_batched_lasso_sweep_ref(*args)
    torch.cuda.synchronize()
    assert pb.fused_batched_lasso_sweep.launches == before + 1
    _assert_lanes_match(out, ref)


@pytest.mark.parametrize("C", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("shape", [(90, 50), (45, 100)], ids=["tall", "wide"])
def test_batch_kernel_cluster_sizes_match_plain(cuda, shape, C, monkeypatch):
    """The resident kernel with its plan forced onto clusters of 1 to 16
    blocks (the 16-block cluster leaves some blocks fewer rows, the last
    block of 90 rows on 16 none), f64, against the plain version."""
    _force_plan(monkeypatch, C)
    args = _sweep_args(cuda, shape, torch.float64, 11)
    out = pb.fused_batched_lasso_sweep(*args)
    ref = pb.fused_batched_lasso_sweep_ref(*args)
    torch.cuda.synchronize()
    _assert_lanes_match(out, ref)


def test_batch_kernel_global_slices_match_plain(cuda):
    """At 1000x600 f32 no cluster holds A's and Ginv's slices in shared
    memory: the plan is 16 blocks reading them from global memory."""
    plan = pb.cluster_plan(1000, 600, 4)
    assert plan["C"] == 16 and not plan["in_smem"]
    assert pb.route_for(1000, 600, 4, 5) == "resident"
    args = _sweep_args(cuda, (1000, 600), torch.float32, 5)
    before = pb.fused_batched_lasso_sweep.launches_by_route["resident"]
    out = pb.fused_batched_lasso_sweep(*args)
    ref = pb.fused_batched_lasso_sweep_ref(*args)
    torch.cuda.synchronize()
    assert pb.fused_batched_lasso_sweep.launches_by_route["resident"] == before + 1
    _assert_lanes_match(out, ref)


def test_batch_cluster_plan_matches_the_kernel(cuda):
    """cluster_plan and the kernel's twin pick the same plan, and lay out
    the same heights and shared memory for every cluster size."""
    lib = pb._lib()
    for m, n in ((60, 40), (40, 60), (120, 80), (500, 300), (300, 500), (1000, 600),
                 (2000, 1200), (5000, 2500), (7, 3000), (3000, 7)):
        for itemsize in (4, 8):
            assert pb._twin_plan(lib, m, n, itemsize, 0, True) == pb.cluster_plan(m, n, itemsize)
            for C in pb.CLUSTER_SIZES:
                for in_smem in (True, False):
                    assert (pb._twin_plan(lib, m, n, itemsize, C, in_smem)
                            == pb.cluster_layout(m, n, itemsize, C, in_smem))


def test_batch_cluster_that_does_not_fit_raises(cuda, monkeypatch):
    """A plan whose shared memory the card refuses raises before anything
    runs: no launch is counted, nothing falls back."""
    _force_plan(monkeypatch, 1)
    args = _sweep_args(cuda, (500, 300), torch.float32, 4)
    before = pb.fused_batched_lasso_sweep.launches
    with pytest.raises(RuntimeError):
        pb.fused_batched_lasso_sweep(*args)
    assert pb.fused_batched_lasso_sweep.launches == before


def test_batched_graph_solve_launches_the_batch_kernel_once(cuda):
    rng = np.random.default_rng(1)
    A = rng.standard_normal((80, 50)).astype(np.float32)
    b = rng.standard_normal(80).astype(np.float32)
    lams = np.geomspace(0.5, 0.1, 12) * float(np.max(np.abs(A.T @ b)))
    before_k2, before_k1 = pb.fused_batched_lasso_sweep.launches, pf.fused_admm_loop.launches
    r = batched_graph_solve(A, P.FunctionVector(P.Function.SQUARE, 80, b=b),
                            P.FunctionVector(P.Function.ABS, 50), lams)
    assert pb.fused_batched_lasso_sweep.launches == before_k2 + 1
    assert pf.fused_admm_loop.launches == before_k1
    assert (r["status"] == 0).all() and r["x"].shape == (12, 50)


def test_batch_results_do_not_depend_on_lanes_per_block(cuda, monkeypatch):
    """Every lane's sums run in one fixed order whatever the cluster holds,
    so Kc = 1, 2, 4 and 8 give bit-identical lanes (the last cluster of 13
    lanes is short for each)."""
    monkeypatch.setattr(pb, "route_for", lambda m, n, itemsize, K: "resident")
    args = _sweep_args(cuda, (60, 40), torch.float32, 13)
    outs = []
    for kc in pb.LANE_CHUNKS:
        monkeypatch.setattr(pb, "chunk_for", lambda K, clusters, kc=kc: kc)
        outs.append(pb.fused_batched_lasso_sweep(*args))
    torch.cuda.synchronize()
    for out in outs[1:]:
        for key in ("x12", "y12", "optval", "final_iter", "status", "rho"):
            assert torch.equal(out[key], outs[0][key]), key


@pytest.mark.parametrize("shape", [(90, 50), (45, 100)], ids=["tall", "wide"])
def test_batch_lanes_bit_equal_across_K_and_chunks(cuda, shape, monkeypatch):
    """At a fixed plan (clusters of 4), a lane's results do not depend on K
    or Kc: the first 3 lanes of 13, run at Kc = 1, 2, 4 and 8, and the same
    3 lanes alone, bit for bit."""
    _force_plan(monkeypatch, 4)
    args = _sweep_args(cuda, shape, torch.float32, 13)
    outs = []
    for kc in pb.LANE_CHUNKS:
        monkeypatch.setattr(pb, "chunk_for", lambda K, clusters, kc=kc: kc)
        outs.append(pb.fused_batched_lasso_sweep(*args))
        outs.append(pb.fused_batched_lasso_sweep(*args[:7], args[7][:3], *args[8:]))
    torch.cuda.synchronize()
    for out in outs[1:]:
        for key in ("x12", "y12", "optval", "final_iter", "status", "rho"):
            assert torch.equal(out[key][:3], outs[0][key][:3]), key


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [(60, 40), (30, 70), (70, 13)], ids=["tall", "wide", "ragged"])
def test_stream_kernel_matches_plain(cuda, shape, dtype, monkeypatch):
    """The streaming kernel (csrc/fused_admm_sweep.cu), forced at a small
    size, against the plain version: 40 lanes, so a full group of 32 and a
    group of 8; the ragged shape pads A's 13 columns to 16 bytes."""
    monkeypatch.setattr(pb, "route_for", lambda m, n, itemsize, K: "stream")
    args = _sweep_args(cuda, shape, dtype, 40)
    before = dict(pb.fused_batched_lasso_sweep.launches_by_route)
    out = pb.fused_batched_lasso_sweep(*args)
    ref = pb.fused_batched_lasso_sweep_ref(*args)
    torch.cuda.synchronize()
    assert pb.fused_batched_lasso_sweep.launches_by_route["stream"] == before["stream"] + 1
    assert torch.equal(out["status"], ref["status"])
    assert int((out["final_iter"] - ref["final_iter"]).abs().max()) <= 2
    rel = (out["optval"] - ref["optval"]).abs() / ref["optval"].abs().clamp(min=1e-12)
    assert float(rel.max()) <= 1e-4
    lim = 5e-5 * max(1.0, float(ref["x12"].abs().max()))
    assert float((out["x12"] - ref["x12"]).abs().max()) <= lim


def test_stream_results_do_not_depend_on_K(cuda, monkeypatch):
    """The streaming kernel's decomposition does not depend on K: K = 8 and
    the first 8 lanes of K = 40 give the same status and iterations, and x
    within 1e-6 relative."""
    monkeypatch.setattr(pb, "route_for", lambda m, n, itemsize, K: "stream")
    args = _sweep_args(cuda, (60, 40), torch.float32, 40)
    full = pb.fused_batched_lasso_sweep(*args)
    part = pb.fused_batched_lasso_sweep(*args[:7], args[7][:8], *args[8:])
    torch.cuda.synchronize()
    assert torch.equal(part["status"], full["status"][:8])
    assert torch.equal(part["final_iter"], full["final_iter"][:8])
    lim = 1e-6 * max(1.0, float(full["x12"][:8].abs().max()))
    assert float((part["x12"] - full["x12"][:8]).abs().max()) <= lim


def _cone_cases():
    C, CC = P.Cone, P.ConeConstraint
    rng = np.random.default_rng(3)
    m, n = 40, 12
    A = rng.standard_normal((m, n))
    lp = (A, A @ rng.standard_normal(n) + rng.random(m) + 0.1, rng.standard_normal(n),
          [CC(C.NON_NEG, range(m))])
    soc = (np.vstack([np.zeros((1, 9)), -np.eye(9)]),
           np.concatenate([[1.5], -rng.standard_normal(9)]), rng.standard_normal(9),
           [CC(C.SOC, range(10))])
    exp = (np.array([[-1.0], [0.0], [0.0]]), np.array([0.0, 1.0, float(np.e)]),
           np.array([-1.0]), [CC(C.EXP_PRIMAL, [0, 1, 2])])
    infeasible = (np.array([[-1.0], [1.0]]), np.array([-1.0, 0.0]), np.array([1.0]),
                  [CC(C.NON_NEG, [0, 1])])
    unbounded = (np.array([[-1.0]]), np.array([0.0]), np.array([-1.0]), [CC(C.NON_NEG, [0])])
    return {"lp": (lp, 0), "socp": (soc, 0), "exp": (exp, 0),
            "infeasible": (infeasible, 1), "unbounded": (unbounded, 2)}


def _cone_args(cuda, A, b, c, cones, dtype, tol, max_iter):
    solver = P.ConeSolver(A, Ky=cones, dtype=dtype, device=cuda).init()
    st = solver._init_state
    b_s = torch.as_tensor(b, dtype=dtype, device=cuda) * st["d"]
    c_s = torch.as_tensor(c, dtype=dtype, device=cuda) * st["e"]
    fac = solver.smw_factor(b_s, c_s)
    return (st["A"], b_s, c_s, solver.Ky, st["factor"]["op"], fac["t_x"], fac["t_y"],
            fac["s_den"], tol, tol, max_iter), st["At"]


def _assert_trajectory(out, ref, dtype):
    """The same status, iterations within 2, w within 1e-5 (f32) or 1e-9
    (f64) of max(1, ‖w‖∞)."""
    assert int(out["status"]) == int(ref["status"])
    assert abs(int(out["final_iter"]) - int(ref["final_iter"])) <= 2
    rel = 1e-5 if dtype == torch.float32 else 1e-9
    lim = rel * max(1.0, float(ref["w"].abs().max()))
    assert float((out["w"] - ref["w"]).abs().max()) <= lim


def _assert_optimum(args, out, ref):
    """chip_smoke.py::optimum_check: the kernel held to the f64 solve of the
    same scaled problem, with the plain version's status and the f64
    solve's, c'x within 1e-3·max(1, |c'x|) and x = w_x/τ within
    1e-2·max(1, ‖x‖∞) of the f64 solve's; iterations not held."""
    f64 = _chip_smoke().f64_solve(args[:8], args[8], args[10])
    c_s, n = args[2].double(), args[0].shape[1]
    x_k = (out["w"][:n] / out["w"][-1]).double()
    x_r = f64["w"][:n] / f64["w"][-1]
    ov_k, ov_r = float(c_s @ x_k), float(c_s @ x_r)
    assert int(out["status"]) == int(ref["status"]) == int(f64["status"])
    assert abs(ov_k - ov_r) <= 1e-3 * max(1.0, abs(ov_r))
    assert float((x_k - x_r).abs().max()) <= 1e-2 * max(1.0, float(x_r.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["lp", "socp", "exp", "infeasible", "unbounded"])
def test_cone_kernel_matches_plain(cuda, case, dtype):
    """Every f64 run and every f32 run shorter than 800 plain-version
    iterations at trajectory level.  The kernel sums in another order than
    torch, and in f32 runs of 800 or more iterations that roundoff parts
    the trajectories: the 40x12 LP ends at 1130 to 1200 iterations by the
    summation order alone, and the kernel's order follows its grid, so
    neither its iterations nor its iterate can be held to the plain
    version's.  Those runs are held to the f64 solve of the same problem,
    as chip_smoke.py's phase 10 holds them (``_assert_optimum``)."""
    (A, b, c, cones), status = _cone_cases()[case]
    args, At = _cone_args(cuda, A, b, c, cones, dtype, 1e-6, 5000)
    before = ph.fused_hsde_solve.launches
    out = ph.fused_hsde_solve(*args, At=At)
    ref = ph.fused_hsde_solve_ref(*args)
    torch.cuda.synchronize()
    assert ph.fused_hsde_solve.launches == before + 1
    assert int(ref["status"]) == status
    if dtype == torch.float32 and int(ref["final_iter"]) >= 800:
        _assert_optimum(args, out, ref)
    else:
        _assert_trajectory(out, ref, dtype)


def test_cone_kernel_six_exp_cones_and_an_soc(cuda):
    """Six exponential cones (three primal, three dual) and an SOC, f64 at
    trajectory level: every cone's warp projection on the card."""
    A, b, c, cones = _chip_smoke().multi_exp_problem(P)
    args, At = _cone_args(cuda, A, b, c, cones, torch.float64, 1e-7, 5000)
    out = ph.fused_hsde_solve(*args, At=At)
    ref = ph.fused_hsde_solve_ref(*args)
    torch.cuda.synchronize()
    assert int(ref["status"]) == 0
    _assert_trajectory(out, ref, torch.float64)


def _plan_blocks(args):
    A = args[0]
    return ph.launch_plan(ph._lib(), A.device, A.dtype, A.shape[0], A.shape[1],
                          ph.segments(args[3]))["blocks"]


@pytest.mark.parametrize("route", ["one_block", "many_blocks"])
def test_cone_kernel_routes_match_plain(cuda, route):
    """The plan's own grid, f64 at trajectory level: the multi-exponential
    problem runs as one block (barriers are __syncthreads), socp_ball
    804x200 on many blocks (SOC segments on their owner blocks)."""
    cs = _chip_smoke()
    if route == "one_block":
        A, b, c, cones = cs.multi_exp_problem(P)
        tol = 1e-7
    else:
        p = cs.cone_problems()[0].socp_ball()
        A, b, c, cones = p["A"], p["b"], p["c"], P.dims_to_cones(p["dims"])
        tol = 1e-4
    args, At = _cone_args(cuda, A, b, c, cones, torch.float64, tol, 5000)
    blocks = _plan_blocks(args)
    assert (blocks == 1) == (route == "one_block")
    out = ph.fused_hsde_solve(*args, At=At)
    ref = ph.fused_hsde_solve_ref(*args)
    torch.cuda.synchronize()
    assert int(ref["status"]) == 0
    _assert_trajectory(out, ref, torch.float64)


@pytest.mark.parametrize("blocks", [3, 8])
def test_cone_kernel_exp_owners_on_several_blocks(cuda, blocks, monkeypatch):
    """The multi-exponential problem forced onto several blocks, so its
    seven segments have different owners; f64 at trajectory level."""
    monkeypatch.setattr(ph, "blocks_for", lambda m, n, sms: blocks)
    A, b, c, cones = _chip_smoke().multi_exp_problem(P)
    args, At = _cone_args(cuda, A, b, c, cones, torch.float64, 1e-7, 5000)
    assert _plan_blocks(args) == blocks
    out = ph.fused_hsde_solve(*args, At=At)
    ref = ph.fused_hsde_solve_ref(*args)
    torch.cuda.synchronize()
    _assert_trajectory(out, ref, torch.float64)


@pytest.mark.parametrize("case", ["socp_ball_804x200", "wide_eq_lp_60x300"])
def test_cone_kernel_column_tiles_match_plain(cuda, case, monkeypatch):
    """Products in several column tiles, as every problem with more than
    12,288 (f64) or 24,576 (f32) rows or columns runs them: 1 KiB of
    staging puts socp_ball's in up to 13 tiles and the wide LP's (Woodbury)
    in up to 5; f64 at trajectory level."""
    cs = _chip_smoke()
    if case == "socp_ball_804x200":
        p = cs.cone_problems()[0].socp_ball()
        A, b, c, cones = p["A"], p["b"], p["c"], P.dims_to_cones(p["dims"])
        tol = 1e-4
    else:
        A, b, c, cones = cs.wide_eq_problem(P, 60, 300)
        tol = 1e-7
    monkeypatch.setattr(ph, "SMEM_VECTORS", 1024)
    args, At = _cone_args(cuda, A, b, c, cones, torch.float64, tol, 5000)
    plan = ph.launch_plan(ph._lib(), args[0].device, torch.float64, *A.shape,
                          ph.segments(args[3]))
    assert plan["smem"] == 1024 < 2 * max(A.shape) * 8
    out = ph.fused_hsde_solve(*args, At=At)
    ref = ph.fused_hsde_solve_ref(*args)
    torch.cuda.synchronize()
    assert int(ref["status"]) == 0
    _assert_trajectory(out, ref, torch.float64)


def test_cone_solver_launches_the_cone_kernel_once(cuda):
    (A, b, c, cones), _ = _cone_cases()["socp"]
    before = (ph.fused_hsde_solve.launches, pf.fused_admm_loop.launches)
    r = P.ConeSolver(A, Ky=cones, device=cuda).solve(b, c)
    assert (ph.fused_hsde_solve.launches, pf.fused_admm_loop.launches) == \
        (before[0] + 1, before[1])
    assert r.status == P.Status.SUCCESS
    # A separable-only tall LP with polish on takes the eager loop.
    (A, b, c, cones), _ = _cone_cases()["lp"]
    P.ConeSolver(A, Ky=cones, device=cuda).solve(b, c)
    assert ph.fused_hsde_solve.launches == before[0] + 1


# -- slice 3: the sparse route on the card ------------------------------------

def _sparse_lasso():
    """benchmarks/sparse_bench.py's lasso at 2000×1000, 1% dense."""
    return _chip_smoke().sparse_lasso_problem(2000, 1000, 0.01)


def test_sparse_operator_on_the_card(cuda):
    """cuSPARSE products of the CSR pair against the CPU operator's."""
    from pogs_tpu_torch.linalg.matrix import as_matrix_op

    A, _, _ = _chip_smoke().sparse_lasso_problem(3000, 1700, 0.01)
    rng = np.random.default_rng(0)
    d, e = torch.tensor(rng.random(3000) + 0.5), torch.tensor(rng.random(1700) + 0.5)
    x, y = torch.tensor(rng.standard_normal(1700)), torch.tensor(rng.standard_normal(3000))
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        cpu = as_matrix_op(A, dtype).scale(d.to(dtype), e.to(dtype))
        gpu = as_matrix_op(A, dtype, cuda).scale(d.to(cuda, dtype), e.to(cuda, dtype))
        assert gpu.M.crow_indices().dtype == torch.int32 and gpu.device.type == "cuda"
        for name, v in (("mv", x), ("rmv", y), ("sq_mv", x), ("sq_rmv", y)):
            ref = getattr(cpu, name)(v.to(dtype))
            got = getattr(gpu, name)(v.to(cuda, dtype)).cpu()
            torch.testing.assert_close(got, ref, atol=tol * max(1.0, float(ref.abs().max())),
                                       rtol=0)
        assert float(gpu.frob2()) == pytest.approx(float(cpu.frob2()), rel=tol)


def _lasso_kkt(A, b, lam, x):
    return _chip_smoke().sparse_kkt(A, b, lam, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_kept_sparse_lasso_on_the_card(cuda, dtype):
    """The kept route (CSR + CGLS, eager) on the card against the f64 CPU
    solve: SUCCESS, the lasso KKT check, objectives within 1e-2 relative
    (f32) or 1e-6 (f64, iterations within 2), and no kernel launched."""
    A, b, lam = _sparse_lasso()
    st = P.SolverSettings(abs_tol=1e-4, rel_tol=1e-4, max_iter=2500)
    f = P.FunctionVector(P.Function.SQUARE, A.shape[0], b=b)
    g = P.FunctionVector(P.Function.ABS, A.shape[1], c=lam)
    before = pf.fused_admm_loop.launches
    r = P.GraphFormSolver(A, dtype=dtype, device=cuda, sparse_policy="keep").solve(
        f, g, settings=st)
    ref = P.GraphFormSolver(A, dtype=torch.float64, device="cpu").solve(f, g, settings=st)
    assert pf.fused_admm_loop.launches == before
    assert r.status == ref.status == P.Status.SUCCESS
    x, x_ref = r.x.double().cpu().numpy(), ref.x.numpy()

    def obj(x):
        return 0.5 * float(np.sum((A @ x - b) ** 2)) + lam * float(np.abs(x).sum())

    assert _lasso_kkt(A, b, lam, x) < 1e-2
    rel = 1e-2 if dtype == torch.float32 else 1e-6
    assert obj(x) == pytest.approx(obj(x_ref), rel=rel)
    if dtype == torch.float64:
        assert abs(int(r.final_iter) - int(ref.final_iter)) <= 2


def test_auto_route_launches_the_solve_kernel_once(cuda):
    """sparse_policy="auto" on CUDA densifies a sparse A within the 1 GiB
    budget: one K1 launch per solve, and the answer of the kept route."""
    A, b, lam = _sparse_lasso()
    before = pf.fused_admm_loop.launches
    r = P.solve_lasso(A, b, lam, dtype=torch.float32)
    assert pf.fused_admm_loop.launches == before + 1
    kept = P.solve_lasso(A, b, lam, dtype=torch.float32, sparse_policy="keep")
    assert pf.fused_admm_loop.launches == before + 1
    assert r["status"] == kept["status"] == 0
    assert _lasso_kkt(A, b, lam, r["x"]) < 1e-2
    assert r["optval"] == pytest.approx(kept["optval"], rel=1e-2)


def test_cg_cone_solve_on_the_card(cuda):
    """A sparse LP kept sparse (the cg strategy, eager) on the card against
    the same solve on the CPU (f64: the same status, iterations within
    max(10, 2%), optval within 1e-4 relative) with no K3 launch; densified
    by the auto rule without polish, one K3 launch, held to its plain
    version on the CPU at trajectory level (iterations within 2, optval
    within 1e-6 relative)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(42)
    A0 = rng.normal(size=(10, 5))
    b0 = A0 @ rng.random(5) + rng.random(10)
    c = rng.normal(size=5)
    A = sp.csr_matrix(np.vstack([A0, np.eye(5), -np.eye(5)]))
    b = np.concatenate([b0, 3 * np.ones(5), 3 * np.ones(5)])
    dims = {"l": A.shape[0]}
    kw = dict(abs_tol=1e-4, rel_tol=1e-4, max_iter=20000, dtype="float64", polish=False)
    before = ph.fused_hsde_solve.launches
    kept = P.solve_cone_problem(c, A, b, dims, sparse_policy="keep", **kw)
    ref = P.solve_cone_problem(c, A, b, dims, sparse_policy="keep", device="cpu", **kw)
    assert ph.fused_hsde_solve.launches == before
    assert kept["status"] == ref["status"] == 0
    assert abs(kept["iterations"] - ref["iterations"]) <= max(10, 0.02 * ref["iterations"])
    assert kept["optval"] == pytest.approx(ref["optval"], rel=1e-4)
    dense = P.solve_cone_problem(c, A, b, dims, **kw)
    assert ph.fused_hsde_solve.launches == before + 1
    plain = P.solve_cone_problem(c, A.toarray(), b, dims, device="cpu", use_fused=True, **kw)
    assert dense["status"] == plain["status"] == 0
    assert abs(dense["iterations"] - plain["iterations"]) <= 2
    assert dense["optval"] == pytest.approx(plain["optval"], rel=1e-6)


# -- slice 5: the QP front ends and the cone batches on the card --------------

def _cvxqp1_s():
    """CVXQP1_S (benchmarks/maros_meszaros.py) as solve_qp's arguments and
    ConeSolver's lowering (equalities, then x ≤ ub, then −x ≤ −lb)."""
    p = _chip_smoke().maros().cvxqp_problem(1, 100, 1.1590718e4)
    n, m_eq = 100, 50
    A_bar = np.vstack([p["A"], np.eye(n), -np.eye(n)])
    b_bar = np.concatenate([p["rhs"], p["ub"], -p["lb"]])
    cones = [P.ConeConstraint(P.Cone.ZERO, range(m_eq)),
             P.ConeConstraint(P.Cone.NON_NEG, range(m_eq, A_bar.shape[0]))]
    return p, A_bar, b_bar, cones


def test_cone_kernel_on_a_qp_extension_matches_plain(cuda):
    """K3 on CVXQP1_S's epigraph extension (one SOC segment of r + 2 rows),
    f64, from the sub-solver's own init, against its plain version at
    trajectory level."""
    p, A_bar, b_bar, cones = _cvxqp1_s()
    solver = P.ConeSolver(A_bar, Ky=cones, dtype=torch.float64, device=cuda)
    before = ph.fused_hsde_solve.launches
    res = solver.solve(b_bar, p["c"], P=p["Q"],
                       settings=P.SolverSettings(polish=False, max_iter=600))
    assert ph.fused_hsde_solve.launches == before + 1
    sub = solver._qp_sub
    r = sub.m - A_bar.shape[0] - 2
    assert sub.Ky.constraints[-1].cone == P.Cone.SOC and len(sub.Ky.constraints[-1]) == r + 2
    b_ext = np.concatenate([b_bar, [1.0, -1.0], np.zeros(r)])
    c_ext = np.concatenate([p["c"], [1.0]])
    args, At = _cone_args(cuda, sub._A_raw, b_ext, c_ext, sub.Ky.constraints, torch.float64,
                          1e-4, 600)
    out = ph.fused_hsde_solve(*args, At=At)
    ref = ph.fused_hsde_solve_ref(*args)
    torch.cuda.synchronize()
    _assert_trajectory(out, ref, torch.float64)
    assert int(res.final_iter) == int(out["final_iter"])


def test_staged_qp_solve_on_the_card(cuda, monkeypatch):
    """The staged route (the host IPM patched out): K3 segments of 500
    iterations with the PDAS polish after each reach CVXQP1_S's published
    optimum."""
    import pogs_tpu_torch.solver.cone as cone_mod

    monkeypatch.setattr(cone_mod.ConeSolver, "_try_qp_ipm", lambda self, *a: None)
    p, _, _, _ = _cvxqp1_s()
    before = ph.fused_hsde_solve.launches
    r = P.solve_qp(p["Q"], p["c"], A=p["A"], b=p["rhs"], lb=p["lb"], ub=p["ub"],
                   abs_tol=1e-6, rel_tol=1e-6, max_iter=40000, dtype="float64", device=cuda)
    segments = ph.fused_hsde_solve.launches - before
    assert r["status"] == 0 and segments >= 1
    assert r["iterations"] <= segments * cone_mod.K_QP_SEGMENT_ITERS
    assert abs(r["optval"] - 1.1590718e4) <= 1e-6 * 1.1590718e4


def test_batched_cone_lanes_match_single_solves(cuda):
    """batched_cone_solve launches K3 once per lane, and each lane equals a
    ConeSolver solve of its own b."""
    problems, _ = _chip_smoke().cone_problems()
    soc = problems.socp_ball(n=50, n_balls=4)
    cones = P.dims_to_cones(soc["dims"])
    K = 4
    bs = soc["b"][None, :] * (1.0 + 0.02 * np.random.default_rng(8).standard_normal((K, 1)))
    st = P.SolverSettings(abs_tol=1e-5, rel_tol=1e-5, max_iter=20000)
    before = ph.fused_hsde_solve.launches
    out = P.batched_cone_solve(soc["A"], bs, soc["c"], cones, settings=st, device=cuda)
    assert ph.fused_hsde_solve.launches == before + K
    for k in range(K):
        r = P.ConeSolver(soc["A"], Ky=cones, settings=st, device=cuda).solve(bs[k], soc["c"])
        assert r.status == P.Status.SUCCESS and int(out["status"][k]) == 0
        assert int(r.final_iter) == int(out["iterations"][k])
        lim = 1e-9 * max(1.0, float(r.x.abs().max()))
        assert float((r.x - out["x"][k]).abs().max()) <= lim


# ---------------------------------------------------------------------------
# The differentiable layers: forward solves through K1 and K3.
# ---------------------------------------------------------------------------

def _layer_grads(layer, args, w, fused):
    """x, aux and the gradients of w·x w.r.t. every argument, with the
    forward through the kernel (fused=None, on CUDA) or the eager loop."""
    leaves = [a.detach().clone().requires_grad_() for a in args]
    x, aux = layer(*leaves, fused)
    grads = torch.autograd.grad(torch.dot(w, x), leaves)
    return x.detach(), aux, grads


def _assert_routes_agree(kernel, eager):
    (x_k, aux_k, g_k), (x_e, aux_e, g_e) = kernel, eager
    assert int(aux_k["status"]) == int(aux_e["status"]) == 0
    assert int(aux_k["iterations"]) == int(aux_e["iterations"])
    assert float((x_k - x_e).abs().max()) <= 1e-12 * max(1.0, float(x_e.abs().max()))
    for a, b in zip(g_k, g_e):
        torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-10)


def test_diff_lasso_forward_through_k1_matches_eager(cuda):
    """diff_lasso in f64: one K1 launch per forward, the same solve as the
    eager loop on the card, and the same gradients w.r.t. A, b and λ."""
    from pogs_tpu_torch.api.diff import diff_lasso

    rng = np.random.default_rng(5)
    A = torch.as_tensor(rng.standard_normal((120, 60)), device=cuda)
    b = torch.as_tensor(rng.standard_normal(120), device=cuda)
    lam = 0.2 * (A.T @ b).abs().max()
    w = torch.as_tensor(rng.standard_normal(60), device=cuda)
    st = P.SolverSettings(abs_tol=1e-8, rel_tol=1e-8, max_iter=20000)

    def layer(A_, b_, lam_, fused):
        return diff_lasso(A_, b_, lam_, settings=st.replace(use_fused=fused))

    before = pf.fused_admm_loop.launches
    kernel = _layer_grads(layer, (A, b, lam), w, None)
    assert pf.fused_admm_loop.launches == before + 1
    eager = _layer_grads(layer, (A, b, lam), w, False)
    assert pf.fused_admm_loop.launches == before + 1
    _assert_routes_agree(kernel, eager)


def test_diff_cone_solve_forward_through_k3_matches_eager(cuda):
    """diff_cone_solve on socp_ball (n = 50) in f64: one K3 launch per
    forward, the same solve as the eager loop, the same gradients w.r.t. A,
    b and c."""
    from pogs_tpu_torch.api.diff_cone import diff_cone_solve

    problems, _ = _chip_smoke().cone_problems()
    soc = problems.socp_ball(n=50, n_balls=4)
    cones = P.dims_to_cones(soc["dims"])
    A, b, c = (torch.as_tensor(soc[k], device=cuda) for k in ("A", "b", "c"))
    w = torch.as_tensor(np.random.default_rng(6).standard_normal(A.shape[1]), device=cuda)

    def layer(A_, b_, c_, fused):
        return diff_cone_solve(A_, b_, c_, cones,
                               settings=P.SolverSettings(abs_tol=1e-8, rel_tol=1e-8,
                                                         max_iter=20000, use_fused=fused))

    before = ph.fused_hsde_solve.launches
    kernel = _layer_grads(layer, (A, b, c), w, None)
    assert ph.fused_hsde_solve.launches == before + 1
    eager = _layer_grads(layer, (A, b, c), w, False)
    assert ph.fused_hsde_solve.launches == before + 1
    _assert_routes_agree(kernel, eager)


def test_diff_qp_forward_through_k1_matches_eager(cuda):
    """diff_qp (n = 30, 15 inequalities, 15 equalities) in f64: K1 on the
    QP's prox mix (SQUARE rows from Lᵀ, shifted INDLE0 and INDEQ0 rows, ZERO
    with a linear term), one launch per forward, the same solve as the eager
    loop, the same gradients w.r.t. P, q, G, h, A and b."""
    from pogs_tpu_torch.api.diff import diff_qp

    rng = np.random.default_rng(7)
    n, mi, me = 30, 15, 15
    M = rng.standard_normal((n, n))
    G = rng.standard_normal((mi, n))
    Aeq = rng.standard_normal((me, n))
    x0 = rng.standard_normal(n)
    args = tuple(torch.as_tensor(v, device=cuda) for v in (
        M @ M.T / n + np.eye(n), rng.standard_normal(n), G,
        G @ x0 + rng.random(mi) + 0.1, Aeq, Aeq @ x0))
    w = torch.as_tensor(rng.standard_normal(n), device=cuda)
    st = P.SolverSettings(abs_tol=1e-8, rel_tol=1e-8, max_iter=20000)

    def layer(P_, q_, G_, h_, A_, b_, fused):
        return diff_qp(P_, q_, G=G_, h=h_, A=A_, b=b_, settings=st.replace(use_fused=fused))

    before = pf.fused_admm_loop.launches
    kernel = _layer_grads(layer, args, w, None)
    assert pf.fused_admm_loop.launches == before + 1
    eager = _layer_grads(layer, args, w, False)
    assert pf.fused_admm_loop.launches == before + 1
    _assert_routes_agree(kernel, eager)


def test_checkpoint_resume_through_k1(cuda, tmp_path):
    """chip_smoke phase 25 on the card: the bench lasso (500x300 f32) solved
    with K1, checkpointed, resumed in a fresh solver (the state restored on
    the card in float32) and solved again with K1: SUCCESS within
    max(3, first // 5) iterations, optval within 1e-5 relative; a
    checkpoint of another matrix is refused."""
    smoke = _chip_smoke()
    A, b, lam = smoke.make_lasso(500, 300)
    st = P.SolverSettings(abs_tol=1e-4, rel_tol=1e-3)
    f = P.FunctionVector(P.Function.SQUARE, 500, b=b, dtype=np.float32)
    g = P.FunctionVector(P.Function.ABS, 300, c=lam, dtype=np.float32)
    before = pf.fused_admm_loop.launches
    s1 = P.GraphFormSolver(A, settings=st)
    r1 = s1.solve(f, g)
    path = tmp_path / "bench.npz"
    s1.save_state(path)
    s2 = P.GraphFormSolver(A, settings=st).load_state(path)
    assert s2._z.device.type == "cuda" and s2._z.dtype == torch.float32
    r2 = s2.solve(f, g)
    assert pf.fused_admm_loop.launches == before + 2
    assert r1.status == r2.status == P.Status.SUCCESS
    assert int(r2.final_iter) <= max(3, int(r1.final_iter) // 5)
    assert float(r2.optval) == pytest.approx(float(r1.optval), rel=1e-5)
    with pytest.raises(ValueError, match="different matrix"):
        P.GraphFormSolver(smoke.make_lasso(500, 300, seed=43)[0]).load_state(path)


def test_scs_data_solve_through_k3(cuda):
    """chip_smoke phase 26 on the card: solve_via_scs_data on socp_ball
    (n = 50) in f64, one K3 launch, equal to solve_cone_problem on the same
    data (status, iterations, x within 1e-12) and in the SCS result schema."""
    from pogs_tpu_torch.api.cvxpy_interface import solve_via_scs_data

    smoke = _chip_smoke()
    problems, _ = smoke.cone_problems()
    soc = problems.socp_ball(n=50, n_balls=4)
    m, n = soc["A"].shape
    opts = dict(abs_tol=1e-6, rel_tol=1e-6, max_iter=20000)
    before = ph.fused_hsde_solve.launches
    res = solve_via_scs_data({k: soc[k] for k in ("c", "A", "b", "dims")}, opts)
    assert ph.fused_hsde_solve.launches == before + 1
    direct = P.solve_cone_problem(soc["c"], soc["A"], soc["b"], soc["dims"], **opts)
    assert smoke.scs_schema_ok(res, m, n)
    assert res["info"]["status_val"] == 1 and direct["status"] == 0
    assert res["info"]["iter"] == direct["iterations"]
    np.testing.assert_allclose(res["x"], direct["x"], rtol=0, atol=1e-12)


# ---- slice 8: two gloo ranks sharing the card ------------------------------------

@pytest.fixture(scope="module")
def card_group():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch_mesh_cases as C

    return C.run_group(2, ["card_row", "card_batches"], device="cuda:0")


def _case(group, name):
    r = group[name]
    assert r["ok"], r.get("error")
    return r["value"]


def test_row_sharded_solve_on_the_card(card_group):
    """Phase 28 (a) at 200x100: two ranks on cuda:0, the row plan against
    the single-device eager loop; no K1 launch."""
    v = _case(card_group, "card_row")
    for dt, atol in (("float32", 5e-4), ("float64", 1e-8)):
        r = v[dt]
        assert r["device"].startswith("cuda")
        assert r["status"] == (0, 0) and r["iters"][0] == r["iters"][1], r
        np.testing.assert_allclose(r["x"][1], r["x"][0], atol=atol, rtol=0)
        assert r["launches"] == 0


def test_batches_over_a_mesh_on_the_card(card_group):
    """Phase 28 (e) at 200x100 K = 16 and the 16-row SOC ball K = 4: one K2
    launch per rank, one K3 launch per lane of each rank, every lane equal
    to the single-device run's."""
    v = _case(card_group, "card_batches")
    assert v["k2"] == [1.0, 1.0] and v["k3"] == [2.0, 2.0]
    for part in ("sweep", "cone"):
        assert np.all(v[part]["status"][0] == 0)
        for key, (ref, sh) in v[part].items():
            np.testing.assert_array_equal(sh, ref, err_msg=f"{part} {key}")
