"""The port's fused_batched_lasso_sweep against pogs_tpu's Pallas kernel
(interpret mode on the CPU), on bit-identical scaled inputs.

The JAX package makes the init state (equilibrated A, Ginv, ‖A‖₂) and the
scaled objective; ``init_state_from_numpy`` carries them over.  On CPU
tensors the port's wrapper runs the kernel's plain version, an eager loop
over (K, ·) tensors.  Sizes are those of tests/test_fused.py's batched
cases.

Tolerances, per lane:
  * float64: the same status and iteration count, x12 and optval within 1e-9;
  * float32: the same status, iterations within 2 (sums run in another
    order in torch's CPU BLAS and in XLA), optval within 1e-4 relative,
    x12 within 2e-5.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pogs_tpu.types import Function as JF, FunctionVector as JFV, SolverSettings as JSet
from pogs_tpu.prox.vector import scale_f as j_scale_f, scale_g as j_scale_g
from pogs_tpu.linalg.equil import equilibrate as j_equilibrate
from pogs_tpu.linalg.norm import norm2_est as j_norm2_est
from pogs_tpu.projector.direct import DirectProjector as JProj
from pogs_tpu.ops.fused_admm_batch import fused_batched_lasso_sweep as j_sweep

import pogs_tpu_torch as P
from pogs_tpu_torch.ops import fused_admm_batch as pb
from pogs_tpu_torch.utils.interop import init_state_from_numpy

torch.set_num_threads(1)

_NP = {"f32": np.float32, "f64": np.float64}
TOL = dict(abs_tol=1e-4, rel_tol=1e-3, gap_stop=False)


@jax.jit
def _j_init(A):
    """The JAX package's init (as its jitted batched front end runs it)."""
    eq = j_equilibrate(A)
    return eq.A, eq.d, eq.e, j_norm2_est(eq.A), JProj().init(eq.A, s=1.0)["op"]


def _inputs(A, b, g_c, dt, fb_batch=None):
    """Scaled inputs from the JAX init, for both packages: (jax args, port
    args).  ``g_c`` is the (K, n) per-lane c of g = ABS; f = SQUARE(b)."""
    m, n = A.shape
    eA, ed, ee, nA, Ginv = _j_init(jnp.asarray(A, dt))
    f = JFV(JF.SQUARE, m, b=b, dtype=dt)
    g = JFV(JF.ABS, n, dtype=dt)
    fpar = tuple(jnp.asarray(p, dt) for p in j_scale_f(f, ed).params)
    gpar = tuple(jnp.asarray(p, dt) for p in j_scale_g(g, ee).params)
    cb = np.asarray(g_c, dt)
    jargs = (eA, Ginv, nA, f.h, fpar, g.h, gpar, jnp.asarray(cb))
    state = init_state_from_numpy({"A": np.asarray(eA), "d": np.asarray(ed),
                                   "e": np.asarray(ee), "norm_A": np.asarray(nA),
                                   "factor": {"op": np.asarray(Ginv)}}, device="cpu")
    pargs = (state["A"], state["factor"]["op"], state["norm_A"], f.h,
             tuple(torch.tensor(np.asarray(p)) for p in fpar), g.h,
             tuple(torch.tensor(np.asarray(p)) for p in gpar), torch.tensor(cb))
    fbj = None if fb_batch is None else jnp.asarray(np.asarray(fb_batch, dt))
    fbp = None if fb_batch is None else torch.tensor(np.asarray(fb_batch, dt))
    return jargs, pargs, fbj, fbp


def _both(A, b, g_c, st, dt, fb_batch=None):
    jargs, pargs, fbj, fbp = _inputs(A, b, g_c, dt, fb_batch)
    ref = j_sweep(*jargs, st, jnp.asarray(1.0, dt), interpret=True, fb_batch=fbj)
    out = pb.fused_batched_lasso_sweep(*pargs, P.SolverSettings(**vars(st)), 1.0,
                                       fb_batch=fbp)
    return ref, out


def _assert_match(ref, out, dtype):
    it_r = np.asarray(ref["final_iter"])
    it_o = out["final_iter"].numpy()
    np.testing.assert_array_equal(out["status"].numpy(), np.asarray(ref["status"]))
    if dtype == "f64":
        np.testing.assert_array_equal(it_o, it_r)
        np.testing.assert_allclose(out["optval"].numpy(), np.asarray(ref["optval"]),
                                   rtol=0, atol=1e-9)
        atol = 1e-9
    else:
        assert np.max(np.abs(it_o - it_r)) <= 2
        np.testing.assert_allclose(out["optval"].numpy(), np.asarray(ref["optval"]),
                                   rtol=1e-4)
        atol = 2e-5
    np.testing.assert_allclose(out["x12"].numpy(), np.asarray(ref["x12"]), atol=atol)
    np.testing.assert_allclose(out["y12"].numpy(), np.asarray(ref["y12"]), atol=atol)
    for key in ("optval", "rho"):
        assert out[key].shape == (it_o.shape[0],)


def _sweep(seed, m, n, K, hi, lo):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    lam_max = float(np.max(np.abs(A.T @ b)))
    lams = np.geomspace(hi, lo, K) * lam_max
    return A, b, np.repeat(lams[:, None], n, axis=1)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_batch_kernel_tall(dtype):
    A, b, cb = _sweep(0, 100, 60, 10, 0.5, 0.1)
    ref, out = _both(A, b, cb, JSet(**TOL), _NP[dtype])
    _assert_match(ref, out, dtype)
    assert (out["status"] == 0).all()


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_batch_kernel_wide(dtype):
    A, b, cb = _sweep(11, 40, 90, 6, 0.6, 0.2)
    ref, out = _both(A, b, cb, JSet(**TOL), _NP[dtype])
    _assert_match(ref, out, dtype)


@pytest.mark.parametrize("ladder", [False, True], ids=["shared_c", "lambda_ladder"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_batch_kernel_multi_rhs(dtype, ladder):
    rng = np.random.default_rng(3)
    m, n, K = 40, 20, 6
    A = rng.standard_normal((m, n))
    B = rng.standard_normal((K, m))
    lams = np.linspace(0.5, 0.1, K) if ladder else np.full(K, 0.3)
    ref, out = _both(A, np.zeros(m), np.repeat(lams[:, None], n, axis=1),
                     JSet(abs_tol=1e-5, rel_tol=1e-5), _NP[dtype], fb_batch=B)
    _assert_match(ref, out, dtype)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_batch_kernel_instant_convergence_optval(dtype):
    """λ ≥ λ_max drives x* = 0 on the first lanes, which converge at once:
    their optval is the objective of the firing iterate, not the 0.0 the
    latch starts from."""
    rng = np.random.default_rng(21)
    m, n, K = 60, 40, 8
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    lam_max = float(np.max(np.abs(A.T @ b)))
    lams = np.array([10 * lam_max, 5 * lam_max]
                    + list(np.geomspace(0.5, 0.1, K - 2) * lam_max))
    ref, out = _both(A, b, np.repeat(lams[:, None], n, axis=1), JSet(**TOL), _NP[dtype])
    _assert_match(ref, out, dtype)
    assert float(out["optval"][0]) > 0.1


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_batch_kernel_max_iter(dtype):
    A, b, cb = _sweep(5, 60, 40, 5, 0.5, 0.1)
    ref, out = _both(A, b, cb, JSet(max_iter=5), _NP[dtype])
    _assert_match(ref, out, dtype)
    assert (out["status"] == int(P.Status.MAX_ITER)).all()
    assert (out["final_iter"] == 4).all()


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_batch_kernel_chunk_independence(dtype):
    """A lane's results do not depend on the other lanes of its batch: the
    first 3 of 10 lanes against a 3-lane run of the same λ."""
    A, b, cb = _sweep(0, 100, 60, 10, 0.5, 0.1)
    _, pargs, _, _ = _inputs(A, b, cb, _NP[dtype])
    st = P.SolverSettings(**TOL)
    full = pb.fused_batched_lasso_sweep(*pargs, st, 1.0)
    part = pb.fused_batched_lasso_sweep(*pargs[:-1], pargs[-1][:3], st, 1.0)
    atol = 1e-9 if dtype == "f64" else 2e-5
    assert torch.equal(part["status"], full["status"][:3])
    assert torch.equal(part["final_iter"], full["final_iter"][:3])
    np.testing.assert_allclose(part["x12"].numpy(), full["x12"][:3].numpy(), atol=atol)
    np.testing.assert_allclose(part["optval"].numpy(), full["optval"][:3].numpy(),
                               rtol=1e-9 if dtype == "f64" else 1e-5)


def test_batch_wrapper_checks_and_raises():
    """Malformed input is refused; a CUDA launch where there is no CUDA
    raises, and nothing runs the plain version in its place."""
    A, b, cb = _sweep(0, 12, 8, 3, 0.5, 0.1)
    _, pargs, _, _ = _inputs(A, b, cb, np.float32)
    st = P.SolverSettings()
    before = pb.fused_batched_lasso_sweep.launches
    with pytest.raises(ValueError):
        pb.fused_batched_lasso_sweep(*pargs[:-1], pargs[-1][:, :5], st, 1.0)
    with pytest.raises(ValueError):
        pb.fused_batched_lasso_sweep(*pargs, st, 1.0, fb_batch=torch.zeros(2, 12))
    with pytest.raises(ValueError):
        pb._launch(*pargs, st.replace(use_anderson=True), 1.0, None, None)
    with pytest.raises(ValueError):
        pb.fused_batched_lasso_sweep(pargs[0].to("meta"), *pargs[1:], st, 1.0)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            pb._launch(*pargs, st, 1.0, None, None)
    assert pb.fused_batched_lasso_sweep.launches == before


def test_chunk_rule():
    """Lanes per cluster: the smallest of 1, 2, 4 and 8 whose clusters all
    fit the card at once (the card's count of the plan's clusters), else 8."""
    assert pb.chunk_for(128, 16) == 8       # the bench sweep on clusters of 8
    assert pb.chunk_for(64, 16) == 4        # a rank's half of it over a (2, 1) mesh
    assert pb.chunk_for(16, 16) == 1
    assert pb.chunk_for(17, 16) == 2
    assert pb.chunk_for(33, 16) == 4
    assert pb.chunk_for(128, 15) == 8       # no lane count fits one wave
    assert pb.chunk_for(128, 8) == 8        # clusters of 16: at most 8 on the card
    assert pb.chunk_for(500, 132) == 4      # clusters of 1
    assert pb.chunk_for(1, 1) == 1


# (m, n): (plan in f32, plan in f64) as (C, slices in shared memory), or
# None where even the global-memory plan's staging overflows.
_PLANS = {
    (120, 80): ((1, True), (2, True)),
    (500, 300): ((8, True), (16, True)),
    (300, 500): ((8, True), (16, False)),
    (1000, 600): ((16, False), (16, False)),
    (2000, 1200): ((16, False), None),
}


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("shape", list(_PLANS), ids=[f"{m}x{n}" for m, n in _PLANS])
def test_cluster_plan(shape, dtype):
    """The resident kernel's plan: C of 1 to 16 blocks whose owned rows of
    A (HA), elements of x (HX) and rows of Ginv (HG) cover each exactly
    once, within 232,448 bytes of shared memory; the smallest C that holds
    the slices, else 16 reading them from global memory.  The bench sweep
    (500x300, f32 and f64) and the wide 300x500 f32 case are held whole in
    shared memory.  The plan takes no K."""
    import inspect

    assert list(inspect.signature(pb.cluster_plan).parameters) == ["m", "n", "itemsize"]
    m, n = shape
    k = min(m, n)
    itemsize = np.dtype(_NP[dtype]).itemsize
    want = _PLANS[shape][dtype == "f64"]
    plan = pb.cluster_plan(m, n, itemsize)
    if want is None:
        assert plan is None
        assert pb.cluster_layout(m, n, itemsize, 16, False)["smem"] > pb.SMEM_LIMIT
        assert pb.route_for(m, n, itemsize, 8) == "stream"
        return
    C, in_smem = want
    assert (plan["C"], plan["in_smem"]) == want
    assert C in pb.CLUSTER_SIZES and plan["smem"] <= pb.SMEM_LIMIT == 232_448
    HA, HX, HG = plan["HA"], plan["HX"], plan["HG"]
    assert (C - 1) * HA < m <= C * HA and (C - 1) * HX < n <= C * HX
    assert HG == (HX if m >= n else HA) and (C - 1) * HG < k <= C * HG
    if in_smem:
        # The slices themselves fit, and no smaller cluster holds them.
        assert itemsize * (HA * n + HG * k) < plan["smem"]
        for smaller in pb.CLUSTER_SIZES[:pb.CLUSTER_SIZES.index(C)]:
            assert pb.cluster_layout(m, n, itemsize, smaller)["smem"] > pb.SMEM_LIMIT
    else:
        assert pb.cluster_layout(m, n, itemsize, 16, True)["smem"] > pb.SMEM_LIMIT
    if shape in ((500, 300), (300, 500)) and dtype == "f32" or shape == (500, 300):
        assert in_smem
    # The same plan and route whatever K rides on it.
    assert len({pb.route_for(m, n, itemsize, K) for K in (1, 8, 128, 10_000)}) == 1


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("shape", [(500, 300), (5000, 2500)], ids=["bench", "real"])
def test_sweep_plan(shape, dtype):
    """The streaming kernel's decomposition on a 132-SM grid: 16-byte
    column groups (256 columns f32, 128 f64), row slices of whole ring
    stages that cover each matrix once with at most one item per block, and
    the ring within the 227 KB of shared memory a Hopper block may use.  The
    plan takes no K: K = 8 and K = 128 share it and differ only in their
    lane groups of 32."""
    m, n = shape
    itemsize = np.dtype(_NP[dtype]).itemsize
    grid = 132
    tc = pb.sweep_tile_cols(itemsize)
    assert tc == (256 if dtype == "f32" else 128)
    assert pb.SWEEP_LANES == 32
    assert [-(-K // pb.SWEEP_LANES) for K in (8, 32, 33, 128)] == [1, 1, 2, 4]
    smem = pb.sweep_smem_bytes(itemsize)
    assert smem == (73_728 if dtype == "f32" else 81_920) <= 227 * 1024
    plan = pb.sweep_plan(m, n, itemsize, grid)
    k = min(m, n)
    for H, (R, C) in zip(plan, ((m, n), (n, m), (k, k))):
        S = -(-R // H)
        assert H % pb.SWEEP_ROWS_PER_STAGE == 0 and H >= pb.SWEEP_ROWS_PER_STAGE
        assert (S - 1) * H < R <= S * H
        assert S * -(-C // tc) <= grid
    if shape == (5000, 2500) and dtype == "f32":
        assert plan == (400, 432, 208)


# chip_smoke.py phase 7's route table on NVIDIA H100 80GB HBM3, 700.00 W
# (the resident kernel on thread block clusters): lasso sweeps below L2, ms
# per call of each kernel, timed in turns.
_ROUTE_TIMES = [
    # (m, n, itemsize, K, resident ms, streaming ms)
    (120, 80, 4, 8, 0.853, 2.028),
    (120, 80, 4, 32, 0.824, 2.659),
    (120, 80, 4, 64, 0.835, 3.896),
    (120, 80, 4, 128, 0.755, 7.361),
    (250, 150, 4, 8, 1.234, 2.851),
    (250, 150, 4, 32, 1.172, 3.884),
    (250, 150, 4, 64, 1.225, 6.255),
    (250, 150, 4, 128, 1.358, 11.859),
    (350, 210, 4, 8, 1.272, 3.094),
    (350, 210, 4, 32, 1.427, 4.104),
    (350, 210, 4, 64, 1.504, 7.454),
    (350, 210, 4, 128, 1.997, 14.887),
    (500, 300, 4, 8, 1.572, 3.417),
    (500, 300, 4, 32, 1.802, 4.706),
    (500, 300, 4, 64, 2.318, 8.893),
    (500, 300, 4, 128, 3.863, 17.327),
    (1000, 600, 4, 8, 4.987, 5.18),
    (1000, 600, 4, 32, 5.511, 7.313),
    (1000, 600, 4, 64, 9.786, 13.849),
    (1000, 600, 4, 128, 14.679, 26.426),
    (2000, 1200, 4, 8, 18.402, 8.558),
    (2000, 1200, 4, 32, 20.778, 13.171),
    (2000, 1200, 4, 64, 36.141, 24.129),
    (2000, 1200, 4, 128, 55.467, 46.378),
    (500, 300, 8, 8, 1.952, 3.505),
    (500, 300, 8, 32, 2.887, 4.579),
    (500, 300, 8, 64, 4.898, 8.587),
    (300, 500, 4, 16, 2.236, 4.563),
]
# Cells whose two times lie within 3% of each other, where either pick is
# right: none in this table (the closest, 1000x600 f32 at K = 8, 3.9%).
_ROUTE_TIES: set = set()


@pytest.mark.parametrize("m,n,itemsize,K,resident_ms,stream_ms", _ROUTE_TIMES)
def test_route_rule(m, n, itemsize, K, resident_ms, stream_ms):
    """The rule picks the kernel that was faster on the card for that size,
    dtype and K (a tie within 3%, named in _ROUTE_TIES, is held to
    neither)."""
    faster = "resident" if resident_ms < stream_ms else "stream"
    if (m, n, itemsize, K) in _ROUTE_TIES:
        assert abs(resident_ms - stream_ms) <= 0.03 * min(resident_ms, stream_ms)
    else:
        assert pb.route_for(m, n, itemsize, K) == faster


def test_route_rule_bounds():
    """The resident kernel while its plan holds the slices in shared memory,
    or reads at most GLOBAL_SLICE_BYTES of them a block from L2; the
    streaming kernel otherwise, and so beyond the 50 MB L2; never by K."""
    assert pb.route_for(5000, 2500, 4, 32) == "stream"     # 125 MB
    assert pb.route_for(5000, 2500, 4, 1000) == "stream"
    assert pb.route_for(2500, 5000, 8, 1) == "stream"
    assert pb.route_for(500, 300, 8, 128) == "resident"
    assert pb.route_for(500, 300, 4, 8) == "resident"
    assert pb.route_for(2000, 1200, 8, 8) == "stream"      # no f64 plan
    assert pb.route_for(2000, 1200, 4, 128) == "stream"    # 960,000 bytes a block
    assert pb.route_for(1000, 600, 4, 8) == "resident"     # 242,400 bytes a block
    # Tall A of 600 columns on the global path: the route turns where a
    # block's slices pass the bound.
    n, m = 600, 1000
    while pb.route_for(m + 1, n, 4, 8) == "resident":
        m += 1
    for rows in (m, m + 1):
        plan = pb.cluster_plan(rows, n, 4)
        assert plan["C"] == 16 and not plan["in_smem"]
        fits = 4 * (plan["HA"] * n + plan["HG"] * n) <= pb.GLOBAL_SLICE_BYTES
        assert fits == (rows == m)
    # Beyond the L2 (4 (2 m n + n^2) > 50 MiB) the slice bound has turned.
    assert 4 * (2 * m * n + n * n) < 50 * 2**20
    n = 1000
    m = (50 * 2**20 // 4 - n * n) // (2 * n) + 1
    assert pb.cluster_plan(m, n, 4) is not None and pb.route_for(m, n, 4, 8) == "stream"
    # A wide A of 64 rows: the staged (n, 8) vectors set the widest plan.
    n = 64
    while pb.cluster_plan(64, n + 1, 4) is not None:
        n += 1
    assert pb.route_for(64, n, 4, 8) == "resident"
    assert pb.route_for(64, n + 1, 4, 8) == "stream"


def test_sweep_layouts():
    """What the wrapper hands the streaming kernel: per-lane rows lanes
    innermost in groups of 32 (padding lanes zero), and matrices whose rows
    start on 16 bytes."""
    v = torch.arange(40 * 3, dtype=torch.float32).reshape(40, 3)
    out = pb._lanes_inner(v, 2)
    assert out.shape == (2, 3, 32) and out.is_contiguous()
    assert torch.equal(out[0].T, v[:32])
    assert torch.equal(out[1, :, :8].T, v[32:])
    assert not out[1, :, 8:].any()
    M = torch.ones(5, 13, dtype=torch.float32)
    P4 = pb._pad_cols(M, 4)
    assert P4.shape == (5, 16) and torch.equal(P4[:, :13], M) and not P4[:, 13:].any()
    M2 = torch.ones(5, 14, dtype=torch.float64)
    assert pb._pad_cols(M2, 2) is M2
