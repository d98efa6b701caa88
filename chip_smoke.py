#!/usr/bin/env python3
"""Drive the PyTorch port (pogs_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line of its own:
  1. device: the card's name and power limit (as nvidia-smi reports them),
     the torch and CUDA versions;
  2. build: nvcc builds the four kernels from pogs_tpu_torch/csrc/, one nvcc
     per source, started together (or says that a library was cached), with
     each kernel's registers, shared memory and spills, and beside them the
     host C++ compiler builds the native runtime (pogs_tpu_torch.native);
  3. the solve kernel (K1) against its plain version (the eager loop) on the
     card, on the same scaled inputs from the port's init: tall bench lasso
     500x300, wide 300x500, logistic 200x100, nonneg LS with gap_stop,
     max_iter=5, the bench lasso in float64, and the benchmark's lasso
     10000x5000 on the one pass (the only case on it), each with its launch
     plan's blocks, barriers per iteration and route, and its passes over A;
     then K1's route table (lasso
     problems from 60x40 to 5000x2500, tall and wide, f32 and f64, on 1 to
     132 blocks, and the plan's grid without the shared side; logistic
     2000x1000 with and without it; tall f32 lasso problems from 5000x2500
     to 20000x2500 on the one pass and on the plain products; a fixed count of
     iterations at tolerance 0, per iteration run);
  4. the main path: pogs_tpu_torch.solve_lasso on the bench problem (f32,
     cuda), which must succeed, pass the lasso KKT check, and launch K1
     exactly once per solve;
  5. a real size: lasso 5000x2500 f32 through GraphFormSolver, timed per
     solve with CUDA events, for K1 and for the eager loop, with K1's bound
     and its share of the per-iteration stream of A, Aᵀ and Ginv at 3.35
     TB/s;
  6. a warm λ-path of 3 solves on one solver, K1 against the eager loop;
  7. both kernels of the batched solve (K2: the streaming cooperative kernel
     and the resident cluster kernel) against their plain version on the
     card, lane for lane, and their times in turns: bench.py's λ-sweep
     (500x300 f32, K = 128), wide 300x500 (K = 16), multi-RHS with a λ
     ladder (K = 8), max_iter=5, the sweep in float64, each case line with
     the resident kernel's plan (cluster size C, lanes per cluster Kc,
     clusters, whether its slices sit in shared memory) and its µs per
     iteration of the slowest lane; the bench sweep also at each Kc; the
     float64 sweep also on 8-block clusters reading the slices from global
     memory; K and chunk independence of the resident kernel bit for bit
     (8 lanes of the K = 128 run against 8-lane runs at the rule's Kc and
     at Kc = 8) and K independence of the streaming one (the same 8 lanes
     alone); then both kernels in turns on lasso sweeps below L2 from
     120x80 to 2000x1200 at K = 8 to 128 and wide 300x500 at K = 16, beside
     route_for's pick;
  8. the batched path: pogs_tpu_torch.parallel.batched_graph_solve on the
     bench sweep (K = 128 f32, rel_tol 5e-4; the resident kernel) and at
     5000x2500 (K = 32; the streaming kernel), one K2 launch per call through
     the kernel route_for picks, every lane SUCCESS and within the lasso KKT
     check; K2 against K sequential cold K1 solves from the same init, with
     its bound and time per iteration; at 5000x2500 the streaming kernel
     against its plain version, and the resident kernel's time (null: its
     vector staging has no plan in shared memory at that width);
  9. the warm λ-path: solve_lasso_path(warm=True) over 12 λ on the bench
     problem, 12 K1 launches, iterations within 2 of the eager loop's;
 10. the cone kernel (K3) against its plain version (the eager HSDE loop with
     the SMW solve) on the card, on the same scaled inputs from the port's
     cone init: the seven cases of tests/test_fused_hsde.py (LP, tall SOCP,
     wide equality LP, infeasible, unbounded, exp cone, mixed
     SOC + exp + NonNeg), six exp cones and an SOC in f64, a wide equality
     LP 60x300 in f64, lp_ineq 1100x300, socp_ball 804x200 in f32 and f64,
     and max_iter=5, each with its launch plan's blocks and barriers; the
     six-exp case on 1, 3 and 8 blocks, socp_ball on 1 and 132, socp_ball
     and the wide LP with their products in several column tiles, lp_ineq
     f32 on 45, 92 and 132 blocks against the f64 solve; then K3's route
     table (every case and five random LPs from 64x48 to 300x200 on 1 to
     132 blocks, 1000 iterations at tolerance 0);
 11. the main cone path: pogs_tpu_torch.solve_cone_problem on socp_ball, the
     exp-primal, exp-dual and mixed conic fixtures, lp_ineq without polish
     (one K3 launch each), lp_ineq with the default polish (no K3 launch:
     the eager loop polishes), and an infeasible and an unbounded LP; each
     optval against an independent value (closed form, HiGHS, or the eager
     path with a cone residual);
 12. a real size: socp_ball(n=2000) 8004x2000 f32 through ConeSolver with
     K3, timed per solve, with its bound and its time per iteration against
     the stream of A, Aᵀ and Kinv at 3.35 TB/s, and the eager loop on the
     same init;
 13. a warm start: b·(1 + 1e-3) re-solved with warm_start=True, K3 and the
     eager loop;
 14. the sparse lasso of benchmarks/sparse_bench.py at 2000x1000 and
     10000x5000, 1% dense, f32 at abs/rel tol 1e-4: kept sparse (CSR +
     CGLS, the eager loop) in f32 and f64, and densified by
     sparse_policy="auto" (one K1 launch per solve); warm time per solve by
     route, iterations, CGLS steps (needed, and frozen by the chunked done
     check) and the guard each CGLS ended on, SUCCESS, the lasso KKT check
     and objectives within 1e-2 of one another; the densified solve held
     to the eager loop on the same init at trajectory level; at 2000x1000
     the done flag read every 2 (the setting) against every 5 CGLS steps;
 15. the rcv1-sized lasso of benchmarks/real_data_benchmark.py (20242x47236,
     1.53 M nonzeros, f32) through solve_lasso, which keeps it sparse:
     status, iterations, wall time, ms per ADMM iteration, CGLS steps and
     the KKT check (max_iter cut if a probe says the solve would pass a
     minute), and one mv and one rmv alone against their bound;
 16. benchmarks/sparse_bench.py's LP (1400x300) and a sparse SOCP
     (socp_ball 804x200, 800 nonzeros) in f64, kept (the cg strategy,
     eager) and densified by the auto rule (one K3 launch each, polish
     off), each held to the eager solve of its dense twin; ms per DR
     iteration and PCG steps.
 17. the QP main path: CVXQP1_M (benchmarks/maros_meszaros.py, n = 1000,
     500 equalities, 0.1 ≤ x ≤ 10) in f64 through solve_qp on the card by
     three routes: the default (the host IPM; whether it certified, its
     Newton steps and time), the staged HSDE route with the IPM patched
     out (SUCCESS, optval within 1e-6 of 1.0875115673e6, KKT residuals at
     the tolerance; K3 launches, segments, DR iterations, and the time in
     K3, the polish, the eigh, the sub-solver's init and the rest), and
     polish=False at max_iter 1000 (one K3 launch held to its plain version
     on the same scaled extension: the same status, iterations within 2, x
     within 1e-8·max(1, ‖x‖∞)), with K3's plan there;
 18. qp_via="admm" on CVXQP1_S and HS21 against their published optima;
 19. batched_cone_solve on socp_ball 804x200 f64 with K = 8 perturbed b
     (8 K3 launches), lanes 0 and 7 against the eager plain version and
     every lane against a ConeSolver solve of its b; warm_path_cone_solve
     on lp_ineq 1100x300 f64 over 6 drifting b against cold solves;
 20. batched_qp_solve on CVXQP1_S with K = 16 perturbed q and the JAX
     package's one polish per lane: polished lanes within 1e-6 of a
     per-lane solve_qp, no rejected lane called SUCCESS, the polished
     count reported; then the staged single-QP route (IPM patched out) on
     every lane, SUCCESS within 1e-6, and on lane 0, the lane with the
     most segments and the unpolished lanes K3 against the plain version
     (the same status and segment totals);
 21. solve_qps on tests/data/HS21.QPS: SUCCESS, objective −99.96;
 22. the differentiable graph-form layers in f64: diff_lasso on the bench
     lasso at the layer's defaults (one K1 launch per forward, the forward
     held to the eager one, dλ and a directional derivative in A against
     central differences through K1 forwards), at 2000x1000 (the gmres
     route) against the dense route, and diff_qp (n = 100, 50
     inequalities, 50 equalities) on a batch of 16 q (16 K1 launches, each
     element equal to its own call, dx/dq against differences); each with
     its forward (K1 ms) and its backward split into the fixed-point
     Jacobian, the linear solve and the parameter VJP (CUDA events);
 23. the differentiable cone layer in f64: diff_cone_solve on socp_ball
     804x200 (one K3 launch per forward, held to the eager forward at tol
     1e-4; the b gradient against central differences through K3 forwards
     at tol 1e-7), the exp-primal fixture (K3; optimum e), and lp_ineq
     1100x300 with the default polish (the eager loop, no K3), timed as in
     22;
 24. profiling: the port's trace() (torch.profiler) around a warm one-shot
     solve_lasso at the bench size (500x300 f32), which must hold a K1
     kernel event, and around the bench diff_lasso's forward and backward
     (phase 22's problem), each window's length, the union of its CUDA
     kernels' time and the card's idle share; before any trace, equilibrate,
     norm2_est and the projector's init at 500x300 timed one by one and in
     sequence with device_time (CUDA events) and PhaseTimer's summary of
     five one-shot solves (setup / init / solve / result); after the traces,
     each part traced and the split again.  Traces go to chiprun_out/traces/;
 25. checkpoint / resume: the bench lasso solved with K1, save_state,
     load_state into a fresh solver, solved again with K1 (SUCCESS within
     max(3, first // 5) iterations, optval within 1e-5), and a checkpoint of
     another matrix refused;
 26. the cvxpy plugin's path: solve_via_scs_data on socp_ball 804x200 f64 in
     SCS form (one K3 launch), equal to solve_cone_problem on the same data
     (status, iterations, x within 1e-12) and in the SCS result schema;
 27. the native host runtime: its build time (phase 2), then solve_lasso(..., backend="native") against
     the device one-shot on the bench lasso and at 128x256: both SUCCESS,
     optval within 1e-3, each route's one-shot wall time;
 28. multi-device solves on torch.distributed: two spawned ranks share
     cuda:0 under gloo (a FileStore, a group timeout; the kernels built by
     phase 2 before they spawn) and run (a) the bench lasso row-sharded in
     f32 and f64 and (b) a wide 300x500 lasso on the column plan auto_shard
     picks, each against the single-device eager loop (status, iterations,
     x within 5e-4 / 1e-8), (c) 5000x2500 row-sharded, 100 iterations, ms
     per iteration beside the single-device eager loop, (d) shard_sparse
     with pad_cone_rows, the cg strategy in f64, against the single-device
     kept-sparse solve: the SOCP and the LP of tests/test_sharding.py
     solved to tolerance (status, iterations, x within 1e-8, optval; the
     SOCP also against its closed form), and at sparse_bench's LP 1400x300
     the sharded operator's products against the single-device one's and
     3 DR iterations timed, (e) a (batch = 2, rows = 1) mesh: the bench
     λ-sweep, K = 128, one K2 launch per rank, and batched_cone_solve on
     socp_ball 804x200 f64 with K = 8, four K3 launches per rank, every lane
     equal to the single-device run's; (g) cone form on the column plan:
     socp_ball 804x200 f64 through the HSDE path (SMW on the mismatched
     plan, K_y whole) solved to tolerance, and lp_eq's standard-form LP in
     its K_x form at m = 1000, n = 10000 f64 (80 MB; K_y = ZERO, K_x =
     NON_NEG split with the columns of the plan auto_shard picks) through
     the graph-form cone path, held at trajectory level for
     ``LP_HOLD_ITERS`` iterations (``--mesh-lp-full``, with
     ``--mesh-only``, solves it to tolerance instead); (h) the portfolio
     QP, 1000 assets and 30 factors (A 1002x1000, P 1000x1000), on the row
     and the column plan through qp_via="socp" with the polish (the host
     IPM first), "socp" without it (the epigraph extension's DR, sharded
     as A is) and "admm", each optval within 1e-6 of the first route's;
     (i) checkpoints across the mesh and one device: a lasso cut on two
     ranks, saved and resumed on one device, and the reverse, each equal
     to the uninterrupted solve.  (g) to (i) are held to the
     single-device eager solve (status, iterations, x within 1e-8), made
     once on rank 0 for both plans; then (f) the row plan on an NCCL
     group of one rank.  It prints the all-reduces per ADMM and DR
     iteration (count and bytes), ms per iteration of the sharded and the
     single-device solves (for each case of (g) and (h) too, with its
     all-reduces per iteration), µs per all_reduce by size, and the spawn
     time.  Two ranks on one card measure the software path (gloo stages
     through the host), not scaling.
Phases 14 to 16 run with the launch counts reset, and must launch K1 and
K3 (the densified routes); so do phases 17 to 21, which must launch K3,
and phases 22 and 23, and 24 to 27, which must launch K1 and K3; 24 runs
after 25 to 27, since a profiler session slows the eager launches that
follow it in the same process.  Phase 28 counts its launches in its ranks
(K2 and K3).  ``--mesh-only`` runs phases 1, 2 and 28, ``--batch-only``
phases 1, 2, 7 and 8.  Then the
kernels' summary line, the card's name and power limit, and last
{"ok": true, "device": {...}}.

Any failure raises and exits non-zero before the last line.  Exits 1 when
no CUDA device is present.  The bench problem generator is that of
bench.py (seed 42; A ~ N(0,1); 90%-sparse x_true; λ = 0.1‖Aᵀb‖∞); the cone
problems come from benchmarks/problems.py and tests/conic_fixtures.py,
the sparse ones are those of benchmarks/sparse_bench.py and
benchmarks/real_data_benchmark.py, seeded as there; the QPs come from
benchmarks/maros_meszaros.py and tests/data/HS21.QPS.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH_TOL = dict(abs_tol=1e-4, rel_tol=1e-3, gap_stop=False)
# The batched path's tolerance.  At bench.py's rel_tol 1e-3 one lane of the
# sweep (λ = 0.504 λ_bench) ends SUCCESS with a lasso KKT violation of 1.04e-2
# of its λ, in the kernel and in its plain version alike; at 5e-4 every lane
# passes the bench's 1e-2 check.
SWEEP_TOL = dict(abs_tol=1e-4, rel_tol=5e-4, gap_stop=False)


def emit(obj):
    print(json.dumps(obj), flush=True)


def make_lasso(m, n, seed=42):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    x_true = rng.standard_normal(n)
    x_true[rng.random(n) < 0.9] = 0.0
    b = A @ x_true + 0.1 * rng.standard_normal(m)
    lam = 0.1 * np.max(np.abs(A.T @ b))
    return A.astype(np.float32), b.astype(np.float32), float(lam)


def lasso_kkt_lanes(A, b, lams, X):
    """Max lasso KKT violation relative to λ (bench.py's check), for every
    lane (row of X, with its λ) at once."""
    A64 = A.astype(np.float64)
    X = np.asarray(X, np.float64)
    lam = np.asarray(lams, np.float64)[:, None]
    grad = (A64 @ X.T - b.astype(np.float64)[:, None]).T @ A64
    viol = np.where(np.abs(X) > 1e-5, np.abs(grad + lam * np.sign(X)),
                    np.maximum(np.abs(grad) - lam, 0.0))
    return viol.max(axis=1) / lam[:, 0]


def lasso_kkt(A, b, lam, x):
    """Max lasso KKT violation relative to λ of one solution."""
    return float(lasso_kkt_lanes(A, b, [lam], np.asarray(x)[None, :])[0])


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call of fn() on the card (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    if not line:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(line, flush=True)
    emit({"phase": "device", "nvidia_smi": line,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    return line


KERNELS = ("fused_admm", "fused_admm_batch", "fused_admm_sweep", "fused_hsde")
# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes per
# second, and FLOP/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def phase_build():
    """nvcc on the four kernels (started together) and, beside them in a
    thread, the host compiler on the native runtime; returns the native
    build's {"library", "seconds"} (phase 27 reports it)."""
    import threading

    from pogs_tpu_torch import native
    from pogs_tpu_torch.ops import _build

    native_build = {}

    def build_native():
        t = time.perf_counter()
        try:
            native_build["library"] = native.build()
        except Exception as exc:  # re-raised below, after the kernels' build
            native_build["error"] = exc
        native_build["seconds"] = time.perf_counter() - t

    cached = {name: _build.library_path(name).exists() for name in KERNELS}
    thread = threading.Thread(target=build_native)
    thread.start()
    t0 = time.perf_counter()
    try:
        _build.load_all(KERNELS)
    finally:
        thread.join()
    secs = time.perf_counter() - t0
    if "error" in native_build:
        raise native_build["error"]
    libs = {}
    for name in KERNELS:
        log = _build.BUILD_LOGS.get(name, "")
        libs[name] = {
            "library": str(_build.library_path(name)),
            "ptxas": ("cached: built by an earlier run, no compiler output" if cached[name]
                      else [ln.strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln
                            or "Compiling entry" in ln]),
        }
    emit({"phase": "build", "seconds": secs, "libraries": libs,
          "native": {"library": os.path.relpath(str(native_build["library"]), ROOT),
                     "seconds": native_build["seconds"]}})
    return native_build


def _wrappers():
    from pogs_tpu_torch.ops.fused_admm import fused_admm_loop
    from pogs_tpu_torch.ops.fused_admm_batch import fused_batched_lasso_sweep
    from pogs_tpu_torch.ops.fused_hsde import fused_hsde_solve

    return {"fused_admm_loop": fused_admm_loop,
            "fused_batched_lasso_sweep": fused_batched_lasso_sweep,
            "fused_hsde_solve": fused_hsde_solve}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0
    by_route = _wrappers()["fused_batched_lasso_sweep"].launches_by_route
    for route in by_route:
        by_route[route] = 0


def read_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def bound_ms(n_bytes, flops, dtype):
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the FLOPs over the CUDA-core peak of the type."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def solve_work(m, n, iters, exact, itemsize, lanes=1, lane_in=0, lane_out=0):
    """Bytes and FLOPs of graph-form solves on an (m, n) A.  Inputs are read
    once (A, Ginv, the f and g parameters, and lane_in elements per lane),
    outputs written once (lane_out elements per lane).  Every executed
    iteration projects (2 (2mn + k^2) FLOPs); ``exact`` counts the exact
    residual checks (4mn each) the run needed at least: one per converged
    solve.  The other checks near tolerance are data-dependent and left
    out, so the bound is a floor."""
    k = min(m, n)
    n_bytes = itemsize * (m * n + k * k + 5 * (m + n) + lanes * (lane_in + lane_out))
    flops = 2 * (2 * m * n + k * k) * iters + 4 * m * n * exact
    return n_bytes, flops


def scaled_inputs(torch, P, A, f, g, dtype):
    """The kernel's inputs from the port's own init on the card."""
    from pogs_tpu_torch.prox.vector import scale_f, scale_g

    solver = P.GraphFormSolver(A, dtype=dtype, device="cuda").init()
    st = solver._init_state
    dev = torch.device("cuda")

    def cast(fv):
        return fv.replace_params(*(p.to(device=dev, dtype=dtype) for p in fv.params))

    f_s = scale_f(cast(f), st["d"])
    g_s = scale_g(cast(g), st["e"])
    return st, f_s, g_s


# The kernel-vs-plain case on the one-pass route: the benchmark's lasso
# shape, built like the bench case.
ONE_PASS_CASE = "lasso_10000x5000_f32"


def phase_kernel_vs_plain(torch, P):
    from pogs_tpu_torch.ops.fused_admm import fused_admm_loop, fused_admm_loop_ref

    F = P.Function
    rng = np.random.default_rng(7)
    A_b, b_b, lam_b = make_lasso(500, 300)
    A_w = rng.standard_normal((300, 500)).astype(np.float32)
    b_w = rng.standard_normal(300).astype(np.float32)
    A_l = rng.standard_normal((200, 100)).astype(np.float32)
    lab = np.sign(rng.standard_normal(200))
    A_n = rng.standard_normal((120, 80)).astype(np.float32)
    b_n = rng.standard_normal(120).astype(np.float32)
    A_o, b_o, lam_o = make_lasso(10000, 5000)
    S = P.SolverSettings
    cases = [
        ("lasso_500x300_f32", A_b, P.FunctionVector(F.SQUARE, 500, b=b_b),
         P.FunctionVector(F.ABS, 300, c=lam_b), S(**BENCH_TOL), torch.float32),
        ("lasso_wide_300x500_f32", A_w, P.FunctionVector(F.SQUARE, 300, b=b_w),
         P.FunctionVector(F.ABS, 500, c=0.3), S(max_iter=1000), torch.float32),
        ("logistic_200x100_f32", A_l, P.FunctionVector(F.LOGISTIC, 200, a=-lab),
         P.FunctionVector(F.ABS, 100, c=0.2), S(max_iter=1000), torch.float32),
        ("nonneg_ls_gapstop_120x80_f32", A_n, P.FunctionVector(F.SQUARE, 120, b=b_n),
         P.FunctionVector(F.INDGE0, 80), S(max_iter=1000, gap_stop=True), torch.float32),
        ("lasso_max_iter_5_f32", A_b, P.FunctionVector(F.SQUARE, 500, b=b_b),
         P.FunctionVector(F.ABS, 300, c=lam_b), S(max_iter=5), torch.float32),
        ("lasso_500x300_f64", A_b.astype(np.float64), P.FunctionVector(F.SQUARE, 500, b=b_b),
         P.FunctionVector(F.ABS, 300, c=lam_b), S(abs_tol=1e-8, rel_tol=1e-8), torch.float64),
        (ONE_PASS_CASE, A_o, P.FunctionVector(F.SQUARE, 10000, b=b_o),
         P.FunctionVector(F.ABS, 5000, c=lam_o), S(**BENCH_TOL), torch.float32),
    ]
    summary = None
    for name, A, f, g, st, dt in cases:
        state, f_s, g_s = scaled_inputs(torch, P, A, f, g, dt)
        m, n = A.shape
        z0 = torch.zeros(m + n, dtype=dt, device="cuda")
        args = (state["A"], state["factor"]["op"], state["norm_A"], f.h,
                tuple(f_s.params), g.h, tuple(g_s.params), st, z0, z0, 1.0)
        out_k = fused_admm_loop(*args, At=state["At"])
        out_p = fused_admm_loop_ref(*args)
        torch.cuda.synchronize()
        it_k, it_p = int(out_k["final_iter"]), int(out_p["final_iter"])
        s_k, s_p = int(out_k["status"]), int(out_p["status"])
        ov_k, ov_p = float(out_k["optval"]), float(out_p["optval"])
        errs, lims = {}, {}
        ok = s_k == s_p and abs(it_k - it_p) <= 2
        ok = ok and abs(ov_k - ov_p) <= 1e-4 * max(abs(ov_p), 1e-12)
        for key in ("x12", "z"):
            ref = out_p[key]
            err = float(torch.max(torch.abs(out_k[key] - ref)))
            lim = 5e-5 * max(1.0, float(torch.max(torch.abs(ref))))
            errs[key], lims[key] = err, lim
            ok = ok and err <= lim
        plan = k1_plan(torch, args)
        ok = ok and plan["one_pass"] == (name == ONE_PASS_CASE)
        ms = cuda_ms(torch, lambda: fused_admm_loop(*args, At=state["At"]), 10)
        plain_ms = cuda_ms(torch, lambda: fused_admm_loop_ref(*args), 2)
        dname = str(dt).replace("torch.", "")
        n_bytes, flops = solve_work(m, n, it_k + 1, int(s_k == 0), A.dtype.itemsize,
                                    lane_in=2 * (m + n), lane_out=6 * (m + n))
        bms, bby = bound_ms(n_bytes, flops, dname)
        rec = {"phase": "kernel_vs_plain", "case": name, "shape": [m, n],
               "dtype": dname, "blocks": plan["blocks"], "shared_side": plan["shared_side"],
               "one_pass": plan["one_pass"], "a_passes": int(out_k["a_passes"]),
               "checks": int(out_k["checks"]),
               "barriers_per_iter": plan["barriers_per_iter"],
               "barriers_per_check": plan["barriers_per_check"], "status": [s_k, s_p],
               "iters": [it_k, it_p], "optval": [ov_k, ov_p],
               "max_abs_err": errs, "err_limit": lims, "ms": ms, "plain_ms": plain_ms,
               "ms_per_iter": ms / max(it_k + 1, 1),
               "plain_ms_per_iter": plain_ms / max(it_p + 1, 1),
               "bound_ms": bms, "bound_by": bby, "ok": ok}
        emit(rec)
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version: {name}")
        if name == "lasso_500x300_f32":
            summary = rec
    admm_route_table(torch, P)
    return summary


@contextlib.contextmanager
def patched(module, name, value):
    """module.<name> set to value inside the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def k1_plan(torch, args):
    """The launch plan K1 takes for these inputs on this card."""
    from pogs_tpu_torch.ops import fused_admm as fa

    A = args[0]
    return fa.launch_plan(fa._lib(), A.device, A.dtype, A.shape[0], A.shape[1], args[3],
                          args[5])


def forced_k1(blocks=None, shared=None, one_pass=None):
    """K1's plan with its grid, its shared side or its one-pass route
    forced (None: the plan's own)."""
    from pogs_tpu_torch.ops import fused_admm as fa

    stack = contextlib.ExitStack()
    if blocks is not None:
        stack.enter_context(patched(fa, "blocks_for", lambda m, n, sms: blocks))
    if shared is not None:
        stack.enter_context(patched(fa, "shared_side_for", lambda iterative: shared))
    if one_pass is not None:
        stack.enter_context(patched(fa, "one_pass_for",
                                    lambda m, n, itemsize, iterative=0: one_pass))
    return stack


K1_ROUTE_GRIDS = (1, 8, 16, 33, 66, 132)
K1_ROUTE_SIZES = ((60, 40), (40, 60), (80, 50), (90, 60), (100, 70), (120, 80), (200, 120),
                  (300, 200), (500, 300), (300, 500), (1000, 600), (2000, 1000), (3000, 1500),
                  (5000, 2500), (2500, 5000))
# Logistic problems (m, m/2) whose f side has m iterative proxes, around the
# shared side's cap on them.
K1_ROUTE_LOGISTIC = (400, 600, 1000, 2000)
# Tall lasso problems (m, n, itemsize) around the one pass's boundary
# (fused_admm.ONE_PASS_BYTES, ONE_PASS_MIN_N), timed on the one pass and on
# the plain products, on the plan's grid.
K1_ONE_PASS_SIZES = ((5000, 2500, 4), (6000, 3000, 4), (8000, 4000, 4), (10000, 5000, 4),
                     (20000, 2000, 4), (20000, 2500, 4))


def k1_route_inputs(torch, P, m, n, dt, logistic=False):
    """Scaled inputs of a lasso (or logistic) problem of shape (m, n) at
    tolerance 0, so that the solve runs max_iter ordinary iterations."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((m, n))
    F, FV = P.Function, P.FunctionVector
    if logistic:
        f = FV(F.LOGISTIC, m, a=-np.sign(rng.standard_normal(m)))
        g = FV(F.ABS, n, c=0.2)
    else:
        b = rng.standard_normal(m)
        f = FV(F.SQUARE, m, b=b)
        g = FV(F.ABS, n, c=0.1 * float(np.max(np.abs(A.T @ b))))
    st, f_s, g_s = scaled_inputs(torch, P, A, f, g, dt)
    iters = 200 if m * n > 1_000_000 else 1000
    z0 = torch.zeros(m + n, dtype=dt, device="cuda")
    settings = P.SolverSettings(abs_tol=0.0, rel_tol=0.0, max_iter=iters)
    return (st["A"], st["factor"]["op"], st["norm_A"], f.h, tuple(f_s.params), g.h,
            tuple(g_s.params), settings, z0, z0, 1.0), st["At"], iters


def admm_route_table(torch, P):
    """K1's time per iteration by grid (K1_ROUTE_GRIDS), f32 and f64, on
    lasso problems of K1_ROUTE_SIZES (beyond a million elements of A in f32
    only): the record admm_plan's rules are set from
    (tests/test_torch_admm_plan.py).  Each solve runs a fixed count of
    iterations at tolerance 0 (no exact residuals: ordinary iterations).
    On the plan's grid it also times the shared side forced on (3 barriers)
    and off (4), in every cell and on the logistic problems of
    K1_ROUTE_LOGISTIC in f32, and the one pass forced on and off on the
    tall problems of K1_ONE_PASS_SIZES."""
    from pogs_tpu_torch.ops import fused_admm as fa

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for (m, n) in K1_ROUTE_SIZES:
        for dt in (torch.float32, torch.float64):
            if m * n > 1_000_000 and dt == torch.float64:
                continue
            args, At, iters = k1_route_inputs(torch, P, m, n, dt)
            dname = str(dt).replace("torch.", "")
            plan = k1_plan(torch, args)
            cell = {"case": f"lasso_{m}x{n}", "shape": [m, n], "dtype": dname,
                    "iters": iters, "plan_blocks": plan["blocks"],
                    "plan_shared_side": plan["shared_side"], "us_per_iter": {}}
            for g in K1_ROUTE_GRIDS:
                with forced_k1(blocks=g):
                    run = lambda: fa.fused_admm_loop(*args, At=At)  # noqa: E731
                    cell["us_per_iter"][g] = 1e3 * cuda_ms(torch, run, 2) / iters
            cell.update(shared_side_times(torch, fa, args, At, iters))
            per = cell["us_per_iter"]
            cell["fastest"] = min(per, key=per.get)
            if plan["blocks"] in per:
                cell["plan_over_fastest"] = per[plan["blocks"]] / per[cell["fastest"]]
            rows.append(cell)
            emit({"phase": "admm_route_table", **cell})
    for m in K1_ROUTE_LOGISTIC:
        args, At, iters = k1_route_inputs(torch, P, m, m // 2, torch.float32, logistic=True)
        plan = k1_plan(torch, args)
        cell = {"case": f"logistic_{m}x{m // 2}", "shape": [m, m // 2], "dtype": "float32",
                "iters": iters, "plan_blocks": plan["blocks"],
                "plan_shared_side": plan["shared_side"],
                **shared_side_times(torch, fa, args, At, iters)}
        rows.append(cell)
        emit({"phase": "admm_route_table", **cell})
    for m, n, itemsize in K1_ONE_PASS_SIZES:
        dt = torch.float32 if itemsize == 4 else torch.float64
        args, At, iters = k1_route_inputs(torch, P, m, n, dt)
        plan = k1_plan(torch, args)
        cell = {"case": f"lasso_{m}x{n}", "shape": [m, n], "dtype": str(dt)[6:],
                "iters": iters, "plan_blocks": plan["blocks"],
                "plan_one_pass": plan["one_pass"],
                **one_pass_times(torch, fa, args, At, iters)}
        rows.append(cell)
        emit({"phase": "admm_route_table", **cell})
    return rows


def one_pass_times(torch, fa, args, At, iters):
    """µs per iteration on the plan's grid on the one pass (where its ring
    fits) and on the plain products, each forced, and the passes over A or
    Aᵀ per iteration of each."""
    out = {}
    for on in (True, False):
        with forced_k1(one_pass=on):
            key = "one_pass" if on else "plain"
            if k1_plan(torch, args)["one_pass"] != on:
                out[key] = None
                continue
            run = lambda: fa.fused_admm_loop(*args, At=At)  # noqa: E731
            out[key] = 1e3 * cuda_ms(torch, run, 2) / iters
            out[f"{key}_passes_per_iter"] = int(run()["a_passes"]) / iters
    return out


def shared_side_times(torch, fa, args, At, iters):
    """µs per iteration on the plan's grid with the shared side forced on
    (3 barriers; where it fits in shared memory) and off (4)."""
    out = {}
    for shared in (True, False):
        with forced_k1(shared=shared):
            key = "shared_side" if shared else "four_barriers"
            if k1_plan(torch, args)["shared_side"] != shared:
                out[key] = None
                continue
            run = lambda: fa.fused_admm_loop(*args, At=At)  # noqa: E731
            out[key] = 1e3 * cuda_ms(torch, run, 2) / iters
    return out


def phase_main_path(torch, P):
    from pogs_tpu_torch.ops.fused_admm import fused_admm_loop

    A, b, lam = make_lasso(500, 300)
    reset_counts()
    results, wall_ms = [], []
    for i in range(5):
        t0 = time.perf_counter()
        r = P.solve_lasso(A, b, lam, **BENCH_TOL)
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        if fused_admm_loop.launches != i + 1:
            raise AssertionError(
                f"solve {i + 1}: kernel launches {fused_admm_loop.launches}, expected {i + 1}")
        results.append(r)
    counts = read_counts()
    launches = counts["fused_admm_loop"]
    if counts["fused_batched_lasso_sweep"] != 0 or counts["fused_hsde_solve"] != 0:
        raise AssertionError(f"the single solve launched another kernel: {counts}")
    r = results[-1]
    kkt = lasso_kkt(A, b, lam, r["x"])
    # One-shot calls: each pays init (equilibration, norm, factor) + solve.
    rec = {"phase": "main_path", "status": r["status"], "iterations": r["iterations"],
           "optval": r["optval"], "kkt": kkt, "launches": launches,
           "one_shot_ms": wall_ms, "one_shot_ms_median_last4": float(np.median(wall_ms[1:])),
           "solve_time_ms": [x["solve_time"] * 1e3 for x in results]}
    emit(rec)
    if r["status"] != int(P.Status.SUCCESS) or not np.all(np.isfinite(r["x"])):
        raise AssertionError("main path did not succeed")
    if r["x"].shape != (300,) or kkt >= 1e-2:
        raise AssertionError(f"main path KKT violation {kkt}")
    return launches


def timed_solves(torch, P, solver, f, g, reps):
    """Cold solves after a warm-up, ρ varied slightly per solve (bench.py)."""
    times, iters = [], []
    for i in range(reps):
        solver.reset_warm_start()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        res = solver.solve(f, g, rho=1.0 + 1e-4 * (i + 1))
        stop.record()
        torch.cuda.synchronize()
        if res.status != P.Status.SUCCESS:
            raise AssertionError(f"timed solve {i} ended {res.status.name}")
        times.append(start.elapsed_time(stop))
        iters.append(int(res.final_iter))
    return times, iters


def phase_real_size(torch, P):
    m, n = 5000, 2500
    A, b, lam = make_lasso(m, n)
    F = P.FunctionVector
    f = F(P.Function.SQUARE, m, b=b)
    g = F(P.Function.ABS, n, c=lam)
    out = {"phase": "real_size", "shape": [m, n], "dtype": "float32"}
    base = None
    for label, use_fused in (("kernel", True), ("eager", False)):
        solver = P.GraphFormSolver(
            A, device="cuda", settings=P.SolverSettings(use_fused=use_fused, **BENCH_TOL))
        if base is None:
            t0 = time.perf_counter()
            solver.init()
            out["init_ms"] = (time.perf_counter() - t0) * 1e3
            base = solver._init_state
        else:
            solver._init_state = base
        res = solver.solve(f, g)
        kkt = lasso_kkt(A, b, lam, res.x.cpu().numpy())
        if res.status != P.Status.SUCCESS or kkt >= 1e-2:
            raise AssertionError(f"5000x2500 {label}: {res.status.name}, KKT {kkt}")
        times, iters = timed_solves(torch, P, solver, f, g, 5)
        ms = float(np.mean(times))
        out[label] = {"iterations": iters, "ms_per_solve": ms,
                      "ms_per_solve_all": times,
                      "ms_per_iter": ms / (np.mean(iters) + 1), "kkt": kkt}
    # K1's bound, and the stream of A, Aᵀ and Ginv that every iteration reads.
    k = min(m, n)
    it = float(np.mean(out["kernel"]["iterations"])) + 1
    n_bytes, flops = solve_work(m, n, it, 1, 4)
    bms, bby = bound_ms(n_bytes, flops, "float32")
    stream_us = 4 * (2 * m * n + k * k) / PEAK_BYTES * 1e6
    out["kernel"].update(bound_ms=bms, bound_by=bby, stream_us_per_iter=stream_us,
                         stream_share=stream_us / (1e3 * out["kernel"]["ms_per_iter"]))
    emit(out)
    return out


def phase_warm_path(torch, P):
    A, b, lam = make_lasso(500, 300)
    f = P.FunctionVector(P.Function.SQUARE, 500, b=b)
    iters = {}
    for label, use_fused in (("kernel", True), ("eager", False)):
        solver = P.GraphFormSolver(
            A, device="cuda", settings=P.SolverSettings(use_fused=use_fused, **BENCH_TOL))
        seq = []
        for frac in (1.0, 0.7, 0.5):
            res = solver.solve(f, P.FunctionVector(P.Function.ABS, 300, c=frac * lam))
            if res.status != P.Status.SUCCESS:
                raise AssertionError(f"warm path {label} λ×{frac}: {res.status.name}")
            seq.append(int(res.final_iter))
        iters[label] = seq
    ok = all(abs(a - b) <= 2 for a, b in zip(iters["kernel"], iters["eager"]))
    ok = ok and all(it <= iters["kernel"][0] for it in iters["kernel"][1:])
    emit({"phase": "warm_path", "iterations": iters, "ok": ok})
    if not ok:
        raise AssertionError(f"warm λ-path iterations {iters}")


def sweep_inputs(torch, P, A, b, lams, dtype, fb_batch=None):
    """K2's inputs for a lasso λ-sweep from the port's init on the card:
    (positional arguments, fb_batch)."""
    m, n = A.shape
    f = P.FunctionVector(P.Function.SQUARE, m, b=b)
    g = P.FunctionVector(P.Function.ABS, n)
    state, f_s, g_s = scaled_inputs(torch, P, A, f, g, dtype)
    cb = torch.tensor(np.repeat(np.asarray(lams, np.float64)[:, None], n, axis=1),
                      dtype=dtype, device="cuda")
    fbb = None if fb_batch is None else torch.tensor(fb_batch, dtype=dtype, device="cuda")
    return (state["A"], state["factor"]["op"], state["norm_A"], f.h, tuple(f_s.params),
            g.h, tuple(g_s.params), cb), fbb, state, f_s, g_s


def lane_check(out_k, out_p):
    """Per lane: the same status, iterations within 2, optval within 1e-4
    relative, x12 within 5e-5·max(1, ‖x12‖∞)."""
    import torch

    it_k, it_p = out_k["final_iter"].cpu(), out_p["final_iter"].cpu()
    same_status = bool(torch.equal(out_k["status"].cpu(), out_p["status"].cpu()))
    it_diff = int((it_k - it_p).abs().max())
    ov_rel = float(((out_k["optval"] - out_p["optval"]).abs()
                    / out_p["optval"].abs().clamp(min=1e-12)).max())
    err = float((out_k["x12"] - out_p["x12"]).abs().max())
    lim = 5e-5 * max(1.0, float(out_p["x12"].abs().max()))
    ok = same_status and it_diff <= 2 and ov_rel <= 1e-4 and err <= lim
    return ok, {"same_status": same_status, "max_iter_diff": it_diff,
                "optval_max_rel": ov_rel, "max_abs_err": err, "x12_limit": lim}


def sweep_bound(out, m, n, itemsize, fb):
    """bound_ms of one K2 call: each input read once, each output written
    once, the projection of every executed lane-iteration and one exact
    residual check per converged lane."""
    K = int(out["status"].shape[0])
    iters = int((out["final_iter"].long() + 1).sum())
    exact = int((out["status"] == 0).sum())
    n_bytes, flops = solve_work(m, n, iters, exact, itemsize, lanes=K,
                                lane_in=n + (m if fb else 0), lane_out=n + m + 4)
    return bound_ms(n_bytes, flops, "float64" if itemsize == 8 else "float32")


class forced_route:
    """Send every K2 call to one of its two kernels ("resident" or
    "stream"), whatever route_for would pick."""

    def __init__(self, route):
        self.route = route

    def __enter__(self):
        from pogs_tpu_torch.ops import fused_admm_batch as fab

        self.rule = fab.route_for
        fab.route_for = lambda m, n, itemsize, K: self.route

    def __exit__(self, *exc):
        from pogs_tpu_torch.ops import fused_admm_batch as fab

        fab.route_for = self.rule


def k_independence(torch, fab, args, out_k):
    """The streaming kernel's lanes do not depend on K: an 8-lane run against
    the first 8 lanes of out_k, the same status and iterations, x12 within
    1e-6 relative."""
    args8 = args[:7] + (args[7][:8],) + args[8:]
    with forced_route("stream"):
        out8 = fab.fused_batched_lasso_sweep(*args8)
    torch.cuda.synchronize()
    err8 = float((out8["x12"] - out_k["x12"][:8]).abs().max())
    ok = (torch.equal(out8["status"], out_k["status"][:8])
          and torch.equal(out8["final_iter"], out_k["final_iter"][:8])
          and err8 <= 1e-6 * max(1.0, float(out_k["x12"][:8].abs().max())))
    return {"lanes": 8, "K": [8, int(out_k["status"].shape[0])], "max_abs_err": err8,
            "ok": bool(ok)}


def resident_plan(torch, fab, m, n, dt, K):
    """The resident kernel's plan for an (m, n) sweep of K lanes: cluster
    size, whether its slices sit in shared memory, clusters the card holds,
    lanes per cluster and clusters launched."""
    itemsize = 8 if dt == torch.float64 else 4
    plan = fab.cluster_plan(m, n, itemsize)
    if plan is None:
        return {"C": None, "in_smem": None, "slots": None, "kc": None, "clusters": None}
    slots = fab.cluster_slots(fab._lib(), torch.device("cuda", torch.cuda.current_device()),
                              itemsize == 8, m, n, plan)
    kc = fab.chunk_for(K, slots)
    return {"C": plan["C"], "in_smem": plan["in_smem"], "smem": plan["smem"], "slots": slots,
            "kc": kc, "clusters": -(-K // kc)}


def resident_independence(torch, fab, args, out_k):
    """The resident kernel's lanes do not depend on K or on the lanes per
    cluster, bit for bit: the first 8 lanes of out_k against an 8-lane run
    at the rule's Kc and at Kc = 8 (one cluster)."""
    args8 = args[:7] + (args[7][:8],) + args[8:]
    rule = fab.chunk_for
    runs = {}
    with forced_route("resident"):
        runs["rule"] = fab.fused_batched_lasso_sweep(*args8)
        fab.chunk_for = lambda K, clusters: 8
        try:
            runs["kc8"] = fab.fused_batched_lasso_sweep(*args8)
        finally:
            fab.chunk_for = rule
    torch.cuda.synchronize()
    keys = ("x12", "y12", "optval", "final_iter", "status", "rho")
    same = {label: all(torch.equal(out[key], out_k[key][:8]) for key in keys)
            for label, out in runs.items()}
    return {"lanes": 8, "K": [8, int(out_k["status"].shape[0])], "bit_equal": same,
            "ok": all(same.values())}


def phase_kernel_vs_plain_batch(torch, P):
    """Both K2 kernels against the plain version on each case, and their
    times in turns (resident, stream, stream, resident)."""
    from pogs_tpu_torch.ops import fused_admm_batch as fab

    S = P.SolverSettings
    A_b, b_b, lam_b = make_lasso(500, 300)
    sweep = np.linspace(1.0, 0.5, 128) * lam_b
    rng = np.random.default_rng(11)
    A_w = rng.standard_normal((300, 500)).astype(np.float32)
    b_w = rng.standard_normal(300).astype(np.float32)
    fb = (b_b[None, :] + 0.1 * rng.standard_normal((8, 500))).astype(np.float32)
    cases = [
        ("sweep_500x300_K128_f32", A_b, b_b, sweep, None, S(**BENCH_TOL), torch.float32),
        ("wide_300x500_K16_f32", A_w, b_w, np.linspace(1.0, 0.5, 16) * 0.3, None,
         S(max_iter=1000), torch.float32),
        ("multi_rhs_500x300_K8_f32", A_b, b_b, np.linspace(1.0, 0.5, 8) * lam_b, fb,
         S(**BENCH_TOL), torch.float32),
        ("sweep_max_iter_5_f32", A_b, b_b, sweep, None, S(max_iter=5), torch.float32),
        ("sweep_500x300_K128_f64", A_b.astype(np.float64), b_b, sweep, None,
         S(**BENCH_TOL), torch.float64),
    ]
    summary = None
    for name, A, b, lams, fbb_np, st, dt in cases:
        args, fbb, _, _, _ = sweep_inputs(torch, P, A, b, lams, dt, fbb_np)
        args = args + (st, 1.0)

        def run(route):
            with forced_route(route):
                return fab.fused_batched_lasso_sweep(*args, fb_batch=fbb)

        outs = {route: run(route) for route in ("resident", "stream")}
        out_p = fab.fused_batched_lasso_sweep_ref(*args, fb_batch=fbb)
        torch.cuda.synchronize()
        m, n = A.shape
        K = len(lams)
        rec = {"phase": "kernel_vs_plain_batch", "case": name, "shape": [m, n], "K": K,
               "dtype": str(dt).replace("torch.", "")}
        ok = True
        for route, out_k in outs.items():
            ok_r, stats = lane_check(out_k, out_p)
            if name.startswith("sweep_max_iter"):
                ok_r = ok_r and bool((out_k["status"] == int(P.Status.MAX_ITER)).all())
            it = out_k["final_iter"].cpu()
            rec[route] = {"iters_min_max": [int(it.min()), int(it.max())],
                          "statuses": sorted(set(out_k["status"].cpu().tolist())),
                          **stats, "ok": ok_r}
            ok = ok and ok_r
        turns = []
        for route in ("resident", "stream", "stream", "resident"):
            turns.append(cuda_ms(torch, lambda: run(route), 5))
        plain_ms = cuda_ms(torch, lambda: fab.fused_batched_lasso_sweep_ref(*args, fb_batch=fbb), 2)
        bms, bby = sweep_bound(outs["stream"], m, n, A.dtype.itemsize, fbb is not None)
        rec["resident"]["ms"] = (turns[0] + turns[3]) / 2
        rec["stream"]["ms"] = (turns[1] + turns[2]) / 2
        rec.update({"ms_in_turns": dict(zip(["resident", "stream", "stream_2", "resident_2"],
                                            turns)),
                    "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby})
        plan = resident_plan(torch, fab, m, n, dt, K)
        iters = int(outs["resident"]["final_iter"].max()) + 1
        rec["resident"].update(plan, us_per_iter=rec["resident"]["ms"] * 1e3 / iters)
        if name == "sweep_500x300_K128_f32":
            # The resident kernel's time at each lane count per cluster, as
            # a record for the rule that picks it (chunk_for), per call and
            # per iteration of its slowest lane.
            rule = fab.chunk_for
            per_kc = {}
            for kc in fab.LANE_CHUNKS:
                fab.chunk_for = lambda K, clusters, kc=kc: kc
                try:
                    per_kc[kc] = cuda_ms(torch, lambda: run("resident"), 3)
                finally:
                    fab.chunk_for = rule
            rec["resident"]["ms_by_lanes_per_cluster"] = per_kc
            rec["resident"]["us_per_iter_by_lanes_per_cluster"] = {
                kc: t * 1e3 / iters for kc, t in per_kc.items()}
            ind = resident_independence(torch, fab, args, outs["resident"])
            rec["resident"]["k_and_chunk_independence"] = ind
            # K independence (stream).
            rec["stream"]["k_independence"] = k_independence(torch, fab, args, outs["stream"])
            ok = ok and ind["ok"] and rec["stream"]["k_independence"]["ok"]
            summary = rec
        print(f"phase 7 {name}: resident C={plan['C']} Kc={plan['kc']} "
              f"clusters={plan['clusters']} slices in "
              f"{'shared' if plan['in_smem'] else 'global'} memory, "
              f"{rec['resident']['ms']:.3f} ms, {rec['resident']['us_per_iter']:.2f} us per "
              f"iteration ({iters}); stream {rec['stream']['ms']:.3f} ms; "
              f"bound {bms:.4f} ms", flush=True)
        rec["ok"] = ok
        emit(rec)
        if not ok:
            raise AssertionError(f"a batched kernel disagrees with its plain version: {name}")
    route_table(torch, P, fab)
    return summary


def route_table(torch, P, fab):
    """Both K2 kernels timed in turns on lasso sweeps below L2, by size, K
    and dtype, beside the kernel route_for picks: the record its rule is
    set from (tests/test_torch_batch_kernel.py::test_route_rule)."""
    f32, f64 = torch.float32, torch.float64
    cells = [((m, n), f32, (8, 32, 64, 128)) for m, n in (
        (120, 80), (250, 150), (350, 210), (500, 300), (1000, 600), (2000, 1200))]
    cells.append(((500, 300), f64, (8, 32, 64)))
    cells.append(((300, 500), f32, (16,)))
    rows = []
    for (m, n), dt, Ks in cells:
        A, b, lam = make_lasso(m, n)
        if dt == f64:
            A = A.astype(np.float64)
        for K in Ks:
            args, _, _, _, _ = sweep_inputs(torch, P, A, b, np.linspace(1.0, 0.5, K) * lam, dt)
            args = args + (P.SolverSettings(**BENCH_TOL), 1.0)

            def run(route):
                with forced_route(route):
                    return fab.fused_batched_lasso_sweep(*args)

            turns = [cuda_ms(torch, lambda: run(route), 2)
                     for route in ("resident", "stream", "stream", "resident")]
            ms = {"resident": (turns[0] + turns[3]) / 2, "stream": (turns[1] + turns[2]) / 2}
            k = min(m, n)
            plan = resident_plan(torch, fab, m, n, dt, K)
            iters = int(run("resident")["final_iter"].max()) + 1
            rows.append({"shape": [m, n], "K": K, "dtype": str(dt).replace("torch.", ""),
                         "matrix_elems": 2 * m * n + k * k,
                         "iters_max": int(run("stream")["final_iter"].max()) + 1,
                         "resident_plan": plan,
                         "resident_us_per_iter": ms["resident"] * 1e3 / iters,
                         "ms": ms, "faster": min(ms, key=ms.get),
                         "route_for": fab.route_for(m, n, A.dtype.itemsize, K)})
            r = rows[-1]
            print(f"route table {m}x{n} K={K} {r['dtype']}: resident {ms['resident']:.3f} ms "
                  f"(C={plan['C']} Kc={plan['kc']} "
                  f"{'shared' if plan['in_smem'] else 'global'}), stream "
                  f"{ms['stream']:.3f} ms; route_for picks {r['route_for']}, faster "
                  f"{r['faster']}", flush=True)
    emit({"phase": "kernel_vs_plain_batch", "case": "route_table", "rows": rows,
          "route_for_picks_faster": sum(r["route_for"] == r["faster"] for r in rows),
          "cells": len(rows)})


def k1_sequential_ms(torch, P, args, lams, st, reps):
    """ms per solve of K cold K1 solves, one per λ, from the same init."""
    from pogs_tpu_torch.ops.fused_admm import fused_admm_loop
    from pogs_tpu_torch.prox.vector import scale_g

    A, Ginv, norm_A, h_f, f_par, h_g, g_par, _ = args
    m, n = A.shape
    At = A.T.contiguous()
    z0 = torch.zeros(m + n, dtype=A.dtype, device="cuda")
    g_lanes = [tuple(g_par[:2]) + (torch.full((n,), float(lam), dtype=A.dtype, device="cuda"),)
               + tuple(g_par[3:]) for lam in lams]

    def run():
        return [fused_admm_loop(A, Ginv, norm_A, h_f, f_par, h_g, gp, st, z0, z0, 1.0, At=At)
                for gp in g_lanes]

    outs = run()
    if not all(int(o["status"]) == 0 for o in outs):
        raise AssertionError("a sequential K1 solve did not succeed")
    return cuda_ms(torch, run, reps) / len(lams), [int(o["final_iter"]) for o in outs]


def phase_batched_path(torch, P):
    """batched_graph_solve through K2 at the bench size (the resident
    kernel) and at 5000x2500 (the streaming kernel), each against K
    sequential K1 solves; at 5000x2500 also the streaming kernel against the
    plain version, and the resident kernel's time on the same inputs where
    it has a plan."""
    from pogs_tpu_torch.ops import fused_admm_batch as fab
    from pogs_tpu_torch.parallel import batched_graph_solve

    out = {"phase": "batched_path"}
    for label, (m, n, K, reps) in (("bench", (500, 300, 128, 5)),
                                    ("real_size", (5000, 2500, 32, 2))):
        A, b, lam = make_lasso(m, n)
        lams = (np.linspace(1.0, 0.5, K) * lam).astype(np.float32)
        f = P.FunctionVector(P.Function.SQUARE, m, b=b)
        g = P.FunctionVector(P.Function.ABS, n)
        st = P.SolverSettings(**SWEEP_TOL)
        route = fab.route_for(m, n, 4, K)
        reset_counts()
        calls, results = 3 if label == "bench" else 1, []
        for i in range(calls):
            results.append(batched_graph_solve(A, f, g, lams, settings=st))
            counts = read_counts()
            if counts != {"fused_admm_loop": 0, "fused_batched_lasso_sweep": i + 1,
                          "fused_hsde_solve": 0}:
                raise AssertionError(f"{label}: launches {counts} after {i + 1} calls")
        launches = read_counts()["fused_batched_lasso_sweep"]
        by_route = dict(fab.fused_batched_lasso_sweep.launches_by_route)
        if by_route[route] != calls:
            raise AssertionError(f"{label}: launches by kernel {by_route}, expected "
                                 f"{calls} through {route}")
        r = results[-1]
        status = r["status"].cpu().numpy()
        x = r["x"].cpu().numpy()
        kkt = lasso_kkt_lanes(A, b, lams, x).tolist()
        if not (status == 0).all() or not np.isfinite(x).all() or x.shape != (K, n):
            raise AssertionError(f"{label}: statuses {sorted(set(status.tolist()))}")
        if max(kkt) >= 1e-2:
            raise AssertionError(f"{label}: lasso KKT violation {max(kkt)}")
        call_ms = cuda_ms(torch, lambda: batched_graph_solve(A, f, g, lams, settings=st), reps)
        args, _, _, _, _ = sweep_inputs(torch, P, A, b, lams, torch.float32)
        args = args + (st, 1.0)
        out_k2 = fab.fused_batched_lasso_sweep(*args)
        k2_ms = cuda_ms(torch, lambda: fab.fused_batched_lasso_sweep(*args), reps)
        seq_ms, seq_iters = k1_sequential_ms(torch, P, args[:8], lams, st, max(1, reps // 2))
        it = r["iterations"].cpu().numpy()
        k2_iters = int(out_k2["final_iter"].max()) + 1
        bms, bby = sweep_bound(out_k2, m, n, 4, False)
        rec = {
            "shape": [m, n], "K": K, "tol": SWEEP_TOL, "route": route,
            "launches": launches, "launches_by_route": by_route,
            "kkt_max": max(kkt),
            "iters_min_max": [int(it.min()), int(it.max())],
            "call_ms": call_ms, "call_ms_per_solve": call_ms / K,
            "k2_ms": k2_ms, "k2_ms_per_solve": k2_ms / K,
            "k2_ms_per_iteration": k2_ms / k2_iters,
            "bound_ms": bms, "bound_by": bby, "share_of_bound": bms / k2_ms,
            "k1_sequential_ms_per_solve": seq_ms,
            "k1_sequential_iters_min_max": [min(seq_iters), max(seq_iters)],
        }
        if label == "real_size":
            # The streaming kernel against its plain version on the same
            # inputs, and the resident kernel's time in the same call.
            out_p = fab.fused_batched_lasso_sweep_ref(*args)
            torch.cuda.synchronize()
            ok, stats = lane_check(out_k2, out_p)
            rec["vs_plain"] = {**stats, "ok": ok}
            rec["plain_ms"] = cuda_ms(torch, lambda: fab.fused_batched_lasso_sweep_ref(*args), 1)
            if fab.cluster_plan(m, n, 4) is None:
                # The resident kernel's vector staging overflows shared
                # memory at this width: it has no plan and would raise.
                rec["resident_k2_ms"] = None
            else:
                with forced_route("resident"):
                    rec["resident_k2_ms"] = cuda_ms(
                        torch, lambda: fab.fused_batched_lasso_sweep(*args), 1)
            if not ok:
                raise AssertionError(f"real size: the streaming kernel disagrees with its "
                                     f"plain version: {stats}")
            if not k2_ms / K < seq_ms:
                raise AssertionError(f"real size: K2 {k2_ms / K} ms per solve, sequential "
                                     f"K1 {seq_ms}")
        out[label] = rec
        out[f"launches_{label}"] = by_route
        if label == "bench":
            out["launches"] = launches
    emit(out)
    return out


def phase_warm_lasso_path(torch, P):
    from pogs_tpu_torch.parallel import solve_lasso_path

    A, b, lam = make_lasso(500, 300)
    lams = np.geomspace(2.0, 0.1, 12) * lam
    iters, ms = {}, {}
    for label, use_fused in (("kernel", None), ("eager", False)):
        st = P.SolverSettings(use_fused=use_fused, **BENCH_TOL)
        reset_counts()
        r = solve_lasso_path(A, b, lams, settings=st, warm=True)
        counts = read_counts()
        want = 12 if label == "kernel" else 0
        if counts != {"fused_admm_loop": want, "fused_batched_lasso_sweep": 0,
                      "fused_hsde_solve": 0}:
            raise AssertionError(f"warm path ({label}): launches {counts}")
        if not bool((r["status"] == 0).all()):
            raise AssertionError(f"warm path ({label}): statuses {r['status'].tolist()}")
        iters[label] = r["iterations"].cpu().tolist()
        ms[label] = cuda_ms(torch, lambda: solve_lasso_path(A, b, lams, settings=st, warm=True),
                            3 if label == "kernel" else 1)
    ok = all(abs(a - c) <= 2 for a, c in zip(iters["kernel"], iters["eager"]))
    emit({"phase": "warm_lasso_path", "lambdas": 12, "launches": 12, "iterations": iters,
          "ms_per_path": ms, "ok": ok})
    if not ok:
        raise AssertionError(f"warm λ-path iterations {iters}")


# ---------------------------------------------------------------------------
# The cone form: K3 and the HSDE path.
# ---------------------------------------------------------------------------

CONE_TOL = dict(abs_tol=1e-4, rel_tol=1e-4)  # benchmarks/run_benchmarks.py:177-190
CONE_MAX_ITER = 20000


def cone_problems():
    """The cone problems of phases 10-13, from the repo's generators
    (benchmarks/problems.py, tests/conic_fixtures.py), loaded by path."""
    import importlib.util

    mods = []
    for rel in ("benchmarks/problems.py", "tests/conic_fixtures.py"):
        spec = importlib.util.spec_from_file_location(
            "_smoke_" + os.path.basename(rel)[:-3], os.path.join(ROOT, rel))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mods.append(mod)
    return tuple(mods)


def hsde_checks(iters, max_iter):
    """Check iterations among ``iters`` executed iterations (k = 0 .. iters-1):
    every 10th, and the last one at max_iter - 1."""
    return (iters - 1) // 10 + 1 + int(iters == max_iter and (max_iter - 1) % 10 != 0)


def hsde_work(m, n, iters, checks, itemsize):
    """Bytes and FLOPs of one HSDE solve on an (m, n) A.  Inputs read once (A,
    Aᵀ, Kinv, b, c, t_x, t_y, u0, the row codes), outputs written once (w, u,
    8 stats).  Each executed iteration does the SMW solve: 2 (2mn + k²) FLOPs
    tall, 2 (4mn + k²) wide (Woodbury); each check 8mn more (A x_s, A w_x,
    Aᵀ y_s, Aᵀ w_y)."""
    k = min(m, n)
    passes = 2 if m >= n else 4
    n_bytes = itemsize * (2 * m * n + k * k + 3 * (m + n) + (m + n + 1) + 2 * (m + n + 1) + 8) + 4 * m
    flops = 2 * (passes * m * n + k * k) * iters + 8 * m * n * checks
    return n_bytes, flops


def hsde_inputs(torch, P, A, b, c, cones, dtype):
    """K3's inputs from the port's cone init on the card: (args, At)."""
    solver = P.ConeSolver(A, Ky=cones, dtype=dtype, device="cuda").init()
    st = solver._init_state
    b_s = torch.as_tensor(np.asarray(b), dtype=dtype, device="cuda") * st["d"]
    c_s = torch.as_tensor(np.asarray(c), dtype=dtype, device="cuda") * st["e"]
    fac = solver.smw_factor(b_s, c_s)
    args = (st["A"], b_s, c_s, solver.Ky, st["factor"]["op"], fac["t_x"], fac["t_y"],
            fac["s_den"])
    return args, st["At"]


def k3_cases(P):
    """(name, A, b, c, cones, tol, max_iter, dtype name, how): the seven
    cases of tests/test_fused_hsde.py, then the benchmark-size ones.  ``how``
    says how the kernel is held to its plain version: "trajectory" (the same
    status, iterations within 2, w within 1e-5·max(1, ‖w‖∞) in f32 and
    1e-9·max(1, ‖w‖∞) in f64), "solution" (see ``solution_check``) or
    "optimum" (see ``optimum_check``)."""
    C, CC = P.Cone, P.ConeConstraint
    problems, _ = cone_problems()
    cases = []
    A = np.array([[1.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])
    cases.append(("lp_3x2", A, np.array([1.0, 0.0, 0.0]), np.array([1.0, 2.0]),
                  [CC(C.ZERO, [0]), CC(C.NON_NEG, [1, 2])], 1e-6, 2000, "float32",
                  "trajectory"))
    rng = np.random.default_rng(5)
    n = 9
    x0, c = rng.standard_normal(n), rng.standard_normal(n)
    cases.append(("socp_10x9", np.vstack([np.zeros((1, n)), -np.eye(n)]),
                  np.concatenate([[1.5], -x0]), c, [CC(C.SOC, range(n + 1))], 1e-6, 5000,
                  "float32", "trajectory"))
    # Wide: Woodbury through the m×m inverse, another roundoff than the
    # plain version's, so held at solution level (as tests/test_fused_hsde.py).
    A2 = rng.standard_normal((3, 8))
    cases.append(("wide_eq_lp_3x8", A2, A2 @ rng.standard_normal(8),
                  A2.T @ rng.standard_normal(3), [CC(C.ZERO, range(3))], 1e-6, 5000,
                  "float32", "solution"))
    cases.append(("infeasible_2x1", np.array([[-1.0], [1.0]]), np.array([-1.0, 0.0]),
                  np.array([1.0]), [CC(C.NON_NEG, [0, 1])], 1e-6, 5000, "float32",
                  "trajectory"))
    cases.append(("unbounded_1x1", np.array([[-1.0]]), np.array([0.0]), np.array([-1.0]),
                  [CC(C.NON_NEG, [0])], 1e-6, 5000, "float32", "trajectory"))
    cases.append(("exp_3x1", np.array([[-1.0], [0.0], [0.0]]),
                  np.array([0.0, 1.0, float(np.e)]), np.array([-1.0]),
                  [CC(C.EXP_PRIMAL, [0, 1, 2])], 1e-6, 5000, "float32", "trajectory"))
    rng = np.random.default_rng(17)
    n = 4
    x0, c = rng.standard_normal(n), rng.standard_normal(n)
    A_exp = np.zeros((3, n))
    A_exp[0, 0] = -1.0
    A_nn = rng.standard_normal((2, n))
    A = np.vstack([np.zeros((1, n)), -np.eye(n), A_exp, A_nn])
    b = np.concatenate([[2.0], -x0, [0.0, 1.0, float(np.e)], A_nn @ x0 + 2.0])
    cases.append(("mixed_soc_exp_nonneg_10x4", A, b, c,
                  [CC(C.SOC, range(n + 1)), CC(C.EXP_PRIMAL, [n + 1, n + 2, n + 3]),
                   CC(C.NON_NEG, [n + 4, n + 5])], 1e-6, 8000, "float32", "trajectory"))
    A, b, c, cones = multi_exp_problem(P)
    cases.append(("multi_exp_soc_27x6_f64", A, b, c, cones, 1e-7, 5000, "float64",
                  "trajectory"))
    A, b, c, cones = wide_eq_problem(P, 60, 300)
    cases.append(("wide_eq_lp_60x300_f64", A, b, c, cones, 1e-7, 5000, "float64",
                  "trajectory"))
    lp = problems.lp_ineq()
    soc = problems.socp_ball()
    lp_cones = P.dims_to_cones(lp["dims"])
    soc_cones = P.dims_to_cones(soc["dims"])
    tol = CONE_TOL["abs_tol"]
    # In f32 the benchmark-size solves run 850 to 2260 iterations; the sums
    # of the kernel and of torch run in other orders, and the trajectories
    # part by f32 roundoff, so the two may stop many checks apart: held
    # against the f64 solve.  In f64 they do not part.
    for dname, how in (("float64", "trajectory"), ("float32", "optimum")):
        suffix = "f64" if dname == "float64" else "f32"
        cases.append((f"lp_ineq_1100x300_{suffix}", lp["A"], lp["b"], lp["c"], lp_cones,
                      tol, CONE_MAX_ITER, dname, how))
        cases.append((f"socp_ball_804x200_{suffix}", soc["A"], soc["b"], soc["c"], soc_cones,
                      tol, CONE_MAX_ITER, dname, how))
    cases.append(("socp_ball_max_iter_5_f32", soc["A"], soc["b"], soc["c"], soc_cones, tol,
                  5, "float32", "trajectory"))
    return cases


def wide_eq_problem(P, m, n, seed=29):
    """(A, b, c, cones): min c'x s.t. A x = b for a random wide (m, n) A,
    b = A x1 and c = Aᵀ y1, so c'x is bounded on the affine set (a Zero
    cone on every row: the kernel's Woodbury route)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    return (A, A @ rng.standard_normal(n), A.T @ rng.standard_normal(m),
            [P.ConeConstraint(P.Cone.ZERO, range(m))])


def random_lp(P, m, n, seed=31):
    """(A, b, c, cones): min c'x s.t. A x ≤ b for a random dense (m, n) A,
    feasible (b = A x0 + slack) and bounded (c = −Aᵀ y0, y0 > 0)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    b = A @ rng.standard_normal(n) + rng.random(m) + 0.1
    c = -A.T @ (rng.random(m) + 0.1)
    return A, b, c, [P.ConeConstraint(P.Cone.NON_NEG, range(m))]


def multi_exp_problem(P, seed=23):
    """(A, b, c, cones): six exponential cones and an SOC, 27x6.  Three
    primal cones (x_i, 1, e^{a_i}) hold x_i ≤ a_i, three dual ones
    (−1, x_i, 1) hold x_i ≥ −1, the SOC ‖x − x0‖ ≤ 2, and two NonNeg rows
    cut the ball; c is random, so the optimum lies on several cones."""
    C, CC = P.Cone, P.ConeConstraint
    rng = np.random.default_rng(seed)
    n = 6
    x0 = 0.3 * rng.standard_normal(n)
    a = 0.2 + 0.5 * rng.random(3)
    rows, bs, cones = [np.zeros((1, n)), -np.eye(n)], [[2.0], -x0], [CC(C.SOC, range(n + 1))]
    for i in range(6):
        blk = np.zeros((3, n))
        if i < 3:
            blk[0, i] = -1.0
            bs.append([0.0, 1.0, float(np.exp(a[i]))])
        else:
            blk[1, i] = -1.0
            bs.append([-1.0, 0.0, 1.0])
        rows.append(blk)
        start = n + 1 + 3 * i
        cones.append(CC(C.EXP_PRIMAL if i < 3 else C.EXP_DUAL, [start, start + 1, start + 2]))
    A_nn = rng.standard_normal((2, n))
    rows.append(A_nn)
    bs.append(A_nn @ x0 + 1.0)
    cones.append(CC(C.NON_NEG, [n + 19, n + 20]))
    return np.vstack(rows), np.concatenate(bs), rng.standard_normal(n), cones


def _patched_hsde(name, value):
    """ops.fused_hsde.<name> set to value inside the block."""
    from pogs_tpu_torch.ops import fused_hsde as fh

    return patched(fh, name, value)


def forced_blocks(blocks):
    """Run every K3 launch on ``blocks`` blocks (before the occupancy
    limit), whatever blocks_for would pick."""
    return _patched_hsde("blocks_for", lambda m, n, sms: blocks)


def forced_tiles(smem_bytes):
    """Stage K3's vector operands in at most ``smem_bytes`` of shared memory,
    so that its products run in several column tiles."""
    return _patched_hsde("SMEM_VECTORS", smem_bytes)


def k3_plan(torch, args):
    """The launch plan K3 takes for these inputs on this card."""
    from pogs_tpu_torch.ops import fused_hsde as fh

    A, Ky = args[0], args[3]
    return fh.launch_plan(fh._lib(), A.device, A.dtype, A.shape[0], A.shape[1],
                          fh.segments(Ky))


def f64_solve(args, tol, max_iter):
    """The plain version in float64 on the same scaled inputs: the
    independent optimum a float32 run is held to."""
    from pogs_tpu_torch.ops.fused_hsde import fused_hsde_solve_ref

    up = [a.double() if hasattr(a, "double") else a for a in args]
    return fused_hsde_solve_ref(*up, tol, tol, max_iter)


def optimum_check(args, out_k, out_p, ref):
    """A long float32 run against ``ref``, the f64 solve of the same scaled
    problem: the kernel with its plain version's status and ref's, c'x
    within 1e-3·max(1, |c'x|) (phase 11's rule against an oracle) and
    x = w_x/τ within 1e-2·max(1, ‖x‖∞) of ref's.  Iterations are recorded
    and not held: in f32 the summation order alone moves them (lp_ineq
    1100x300 ends near 2070 or near 2260, the 40x12 LP of
    tests/test_torch_cuda.py at 1130 to 1200, and their x by up to 3e-3
    and 2e-5 of ‖x‖∞), and the kernel's order follows its grid and with it
    the card's SM count."""
    c_s, n = args[2].double(), args[0].shape[1]
    x_r = ref["w"][:n] / ref["w"][-1]
    ov_r = float(c_s @ x_r)
    rec = {"f64_iters": int(ref["final_iter"]), "f64_objective": ov_r}
    ok = int(out_k["status"]) == int(out_p["status"]) == int(ref["status"])
    for who, out in (("kernel", out_k), ("plain", out_p)):
        x = (out["w"][:n] / out["w"][-1]).double()
        rec[who + "_objective_rel_err"] = abs(float(c_s @ x) - ov_r) / max(1.0, abs(ov_r))
        rec[who + "_x_rel_err"] = (float((x - x_r).abs().max())
                                   / max(1.0, float(x_r.abs().max())))
    ok = ok and rec["kernel_objective_rel_err"] <= 1e-3 and rec["kernel_x_rel_err"] <= 1e-2
    return ok, rec


def solution_check(args, out_k, out_p):
    """Kernel against plain version at solution level, on the scaled problem:
    the same status, iterations within 2% (the f32 trajectories part by
    roundoff and the test runs every 10 iterations), c'x within
    1e-4·max(1, |c'x|), x = w_x/τ within 1e-3·max(1, ‖x‖∞), and for a wide
    A (equality rows) ‖A x − b‖∞ ≤ 1e-3."""
    A_s, b_s, c_s = args[0], args[1], args[2]
    m, n = A_s.shape
    w_k, w_p = out_k["w"], out_p["w"]
    x_k, x_p = w_k[:n] / w_k[-1], w_p[:n] / w_p[-1]
    it_k, it_p = int(out_k["final_iter"]), int(out_p["final_iter"])
    ov_k, ov_p = float(c_s @ x_k), float(c_s @ x_p)
    x_err = float((x_k - x_p).abs().max())
    rec = {"objective": [ov_k, ov_p], "x_max_abs_err": x_err}
    ok = (int(out_k["status"]) == int(out_p["status"])
          and abs(it_k - it_p) <= max(2, 0.02 * it_p)
          and abs(ov_k - ov_p) <= 1e-4 * max(1.0, abs(ov_p))
          and x_err <= 1e-3 * max(1.0, float(x_p.abs().max())))
    if m < n:
        rec["eq_residual"] = float((A_s @ x_k - b_s).abs().max())
        ok = ok and rec["eq_residual"] <= 1e-3
    return ok, rec


def once_ms(torch, fn):
    """Milliseconds of one call of fn() on the card (CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def phase_kernel_vs_plain_hsde(torch, P):
    from pogs_tpu_torch.ops.fused_hsde import fused_hsde_solve, fused_hsde_solve_ref

    summary, failed = None, []
    for name, A, b, c, cones, tol, max_iter, dname, how in k3_cases(P):
        dt = getattr(torch, dname)
        args, At = hsde_inputs(torch, P, A, b, c, cones, dt)
        out_k = fused_hsde_solve(*args, tol, tol, max_iter, At=At)
        out_p = fused_hsde_solve_ref(*args, tol, tol, max_iter)
        torch.cuda.synchronize()
        s_k, s_p = int(out_k["status"]), int(out_p["status"])
        it_k, it_p = int(out_k["final_iter"]), int(out_p["final_iter"])
        err = float((out_k["w"] - out_p["w"]).abs().max())
        rec = {"phase": "kernel_vs_plain_hsde", "case": name, "shape": list(A.shape),
               "dtype": dname, "held_at": how, "status": [s_k, s_p], "iters": [it_k, it_p],
               "max_abs_err": err}
        if how == "solution":
            ok, more = solution_check(args, out_k, out_p)
            rec.update(more)
        elif how == "optimum":
            ok, more = optimum_check(args, out_k, out_p, f64_solve(args, tol, max_iter))
            rec.update(more)
        else:
            rel = 1e-5 if dname == "float32" else 1e-9
            lim = rel * max(1.0, float(out_p["w"].abs().max()))
            ok = s_k == s_p and abs(it_k - it_p) <= 2 and err <= lim
            rec["w_limit"] = lim
        if name.startswith("socp_ball_max_iter"):
            ok = ok and s_k == int(P.Status.MAX_ITER) and it_k == max_iter
        iters = (it_k + 1) if it_k < max_iter else max_iter
        n_bytes, flops = hsde_work(A.shape[0], A.shape[1], iters,
                                   hsde_checks(iters, max_iter), 4 if dname == "float32" else 8)
        bms, bby = bound_ms(n_bytes, flops, dname)
        ms = cuda_ms(torch, lambda: fused_hsde_solve(*args, tol, tol, max_iter, At=At), 5)
        plain_ms = once_ms(torch, lambda: fused_hsde_solve_ref(*args, tol, tol, max_iter))
        plan = k3_plan(torch, args)
        rec.update(ms=ms, plain_ms=plain_ms, ms_per_iter=ms / iters,
                   plain_ms_per_iter=plain_ms / iters, bound_ms=bms, bound_by=bby,
                   blocks=plan["blocks"], barriers_per_iter=plan["barriers_per_iter"],
                   barriers_per_check=plan["barriers_per_check"], ok=ok)
        emit(rec)
        if not ok:
            failed.append(name)
        if name == "socp_ball_804x200_f64":
            summary = rec
    if failed:
        raise AssertionError(f"the cone kernel disagrees with its plain version: {failed}")
    hsde_grids(torch, P)
    hsde_route_table(torch, P)
    return summary


def hsde_grids(torch, P):
    """The cone kernel on grids and tilings the plan does not pick, against
    the plain version once per case: the multi-exponential case on 1, 3 and
    8 blocks (exp cones on several owner blocks), socp_ball 804x200 f64 on 1
    and 132 (the one-block route at a size it does not run), both held at
    trajectory level; socp_ball and the wide 60x300 LP in f64 with 1 KiB of
    staging (products in up to 13 column tiles, as every problem with more
    than 12,288 (f64) or 24,576 (f32) rows or columns runs them), at
    trajectory level; lp_ineq 1100x300 f32 on 45, 92 and 132 blocks, held
    to the f64 solve (``optimum_check``)."""
    from pogs_tpu_torch.ops.fused_hsde import fused_hsde_solve, fused_hsde_solve_ref

    cases = {c[0]: c for c in k3_cases(P)}
    runs = (("multi_exp_soc_27x6_f64", "blocks", (1, 3, 8)),
            ("socp_ball_804x200_f64", "blocks", (1, 132)),
            ("socp_ball_804x200_f64", "tiles", (1024,)),
            ("wide_eq_lp_60x300_f64", "tiles", (1024,)),
            ("lp_ineq_1100x300_f32", "blocks", (45, 92, 132)))
    for name, what, values in runs:
        _, A, b, c, cones, tol, max_iter, dname, how = cases[name]
        args, At = hsde_inputs(torch, P, A, b, c, cones, getattr(torch, dname))
        out_p = fused_hsde_solve_ref(*args, tol, tol, max_iter)
        ref = f64_solve(args, tol, max_iter) if how == "optimum" else None
        lim = 1e-9 * max(1.0, float(out_p["w"].abs().max()))
        rows = []
        for v in values:
            with (forced_blocks(v) if what == "blocks" else forced_tiles(v)):
                out_k = fused_hsde_solve(*args, tol, tol, max_iter, At=At)
                plan = k3_plan(torch, args)
            torch.cuda.synchronize()
            err = float((out_k["w"] - out_p["w"]).abs().max())
            row = {what: v, "blocks_run": plan["blocks"], "smem": plan["smem"],
                   "iters": [int(out_k["final_iter"]), int(out_p["final_iter"])],
                   "max_abs_err": err}
            if what == "blocks":
                ok = plan["blocks"] == v
            else:
                ok = plan["smem"] < 2 * max(A.shape) * args[0].element_size()
            if how == "optimum":
                good, more = optimum_check(args, out_k, out_p, ref)
                row.update(more)
                ok = ok and good
            else:
                ok = (ok and int(out_k["status"]) == int(out_p["status"])
                      and abs(int(out_k["final_iter"]) - int(out_p["final_iter"])) <= 2
                      and err <= lim)
            row["ok"] = ok
            rows.append(row)
        emit({"phase": "kernel_vs_plain_hsde", "case": f"{name}_by_{what}", "w_limit": lim,
              "runs": rows})
        if not all(r["ok"] for r in rows):
            raise AssertionError(f"the cone kernel disagrees with its plain version on "
                                 f"some {what}: {name}")


ROUTE_GRIDS = (1, 2, 4, 8, 16, 33, 66, 132)
ROUTE_ITERS = 1000


ROUTE_LPS = ((64, 48), (90, 60), (128, 96), (200, 120), (300, 200))


def hsde_route_table(torch, P):
    """K3's time per iteration on every grid of ROUTE_GRIDS blocks, f32 and
    f64, at the sizes of phases 10 and 11 and of random LPs of ROUTE_LPS
    shapes around the one-block threshold: the record blocks_for is set
    from (tests/test_torch_hsde.py::test_plan_picks_a_fast_grid).  Each
    solve runs up to ROUTE_ITERS iterations (tolerance 0), so the launch and
    the wrapper weigh little beside the kernel; a certificate may end it
    sooner, so the time is divided by the iterations it ran."""
    from pogs_tpu_torch.ops.fused_hsde import blocks_for, fused_hsde_solve, segments

    _, fx = cone_problems()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sizes = {name: (A, b, c, cones) for name, A, b, c, cones, _, _, _, _ in k3_cases(P)
             if not name.endswith("_f32") and "max_iter" not in name}
    for name, p in (("exp_primal_fixture", fx.exp_primal_fixture()),
                    ("exp_dual_fixture", fx.exp_dual_fixture()),
                    ("mixed_fixture", fx.mixed_fixture())):
        sizes[name] = (p["A"], p["b"], p["c"], P.dims_to_cones(p["dims"]))
    for m, n in ROUTE_LPS:
        sizes[f"random_lp_{m}x{n}"] = random_lp(P, m, n)
    rows = []
    for name, (A, b, c, cones) in sizes.items():
        for dt in (torch.float32, torch.float64):
            args, At = hsde_inputs(torch, P, A, b, c, cones, dt)
            m, n = A.shape
            nseg = len(segments(args[3]))
            cell = {"case": name.replace("_f64", ""), "shape": [m, n],
                    "dtype": str(dt).replace("torch.", ""), "nseg": nseg, "us_per_iter": {},
                    "iters": {}}
            for g in ROUTE_GRIDS:
                with forced_blocks(g):
                    run = lambda: fused_hsde_solve(*args, 0.0, 0.0, ROUTE_ITERS, At=At)
                    it = int(run()["final_iter"])
                    ms = cuda_ms(torch, run, 2)
                ran = it + 1 if it < ROUTE_ITERS else ROUTE_ITERS
                cell["iters"][g] = ran
                cell["us_per_iter"][g] = 1e3 * ms / ran
            per = cell["us_per_iter"]
            cell["fastest"] = min(per, key=per.get)
            cell["blocks_for"] = blocks_for(m, n, sms)
            if cell["blocks_for"] in per:
                cell["blocks_for_over_fastest"] = per[cell["blocks_for"]] / per[cell["fastest"]]
            rows.append(cell)
            emit({"phase": "hsde_route_table", **cell})
    return rows


def cone_residuals(P, torch, p, x, tol):
    """The primal cone residual of a returned x, on the host in float64:
    ‖s − Π_K(s)‖ for s = b − A x, and the same in the solver's equilibrated
    space (s_s = d ∘ s, d from the port's cone init), where the solver
    certifies ‖s_s − Π_K(s_s)‖ ≤ √m·abs_tol + rel_tol·max(‖d ∘ b‖, ‖s_s‖).
    Returns (unscaled, scaled, that bound)."""
    A, b = np.asarray(p["A"], np.float64), np.asarray(p["b"], np.float64)
    cones = P.dims_to_cones(p["dims"])
    K = P.ConeSet(cones, len(b))
    d = P.ConeSolver(A, Ky=cones, device="cpu").init()._init_state["d"].numpy()
    s = b - A @ x
    unscaled = float(K.distance(torch.as_tensor(s)))
    s_s = d * s
    scaled = float(K.distance(torch.as_tensor(s_s)))
    bound = (np.sqrt(len(b)) * tol["abs_tol"]
             + tol["rel_tol"] * max(np.linalg.norm(d * b), np.linalg.norm(s_s)))
    return unscaled, scaled, float(bound)


def phase_cone_main_path(torch, P):
    from scipy.optimize import linprog

    problems, fx = cone_problems()
    S = P.Status
    soc = problems.socp_ball()
    lp = problems.lp_ineq()
    rng = np.random.default_rng(3)
    # Infeasible: lp_ineq(50, 20) with x0 ≤ −1 and x0 ≥ 1 added.
    inf = problems.lp_ineq(m=50, n=20)
    e0 = np.zeros((1, 20))
    e0[0, 0] = 1.0
    inf_A = np.vstack([inf["A"], e0, -e0])
    inf_b = np.concatenate([inf["b"], [-1.0, -1.0]])
    # Unbounded: A x ≤ b with A e0 ≤ 0 and c0 < 0, so x0 → +∞ stays feasible.
    ub_A = rng.standard_normal((60, 20))
    ub_A[:, 0] = -np.abs(ub_A[:, 0])
    ub_b = ub_A @ rng.standard_normal(20) + 1.0
    ub_c = rng.standard_normal(20)
    ub_c[0] = -1.0
    cases = [
        # name, (c, A, b, dims), kwargs, expected K3 launches, expected status, oracle
        ("socp_ball_804x200", soc, {}, 1, S.SUCCESS, "eager"),
        ("exp_primal", fx.exp_primal_fixture(), {}, 1, S.SUCCESS, "closed_form"),
        ("exp_dual", fx.exp_dual_fixture(), {}, 1, S.SUCCESS, "closed_form"),
        ("mixed", fx.mixed_fixture(), {}, 1, S.SUCCESS, "eager"),
        ("lp_ineq_1100x300_no_polish", lp, {"polish": False}, 1, S.SUCCESS, "highs"),
        ("lp_ineq_1100x300_polish", lp, {}, 0, S.SUCCESS, "highs"),
        ("lp_infeasible_92x20", {"c": inf["c"], "A": inf_A, "b": inf_b,
                                 "dims": {"l": len(inf_b)}},
         {"polish": False}, 1, S.INFEASIBLE, None),
        ("lp_unbounded_60x20", {"c": ub_c, "A": ub_A, "b": ub_b, "dims": {"l": 60}},
         {"polish": False}, 1, S.UNBOUNDED, None),
    ]
    reset_counts()
    total = 0
    for name, p, kw, want, want_status, oracle in cases:
        before = read_counts()
        r = P.solve_cone_problem(p["c"], p["A"], p["b"], p["dims"], max_iter=CONE_MAX_ITER,
                                 **CONE_TOL, **kw)
        after = read_counts()
        launched = after["fused_hsde_solve"] - before["fused_hsde_solve"]
        others = (after["fused_admm_loop"] - before["fused_admm_loop"]
                  + after["fused_batched_lasso_sweep"] - before["fused_batched_lasso_sweep"])
        total += launched
        rec = {"phase": "cone_main_path", "case": name, "shape": list(np.shape(p["A"])),
               "status": r["status_name"], "iterations": r["iterations"],
               "optval": r["optval"], "k3_launches": launched}
        ok = r["status"] == int(want_status) and launched == want and others == 0
        if want_status == S.SUCCESS:
            if oracle == "closed_form":
                ref = p["optval"]
            elif oracle == "highs":
                ref = float(linprog(p["c"], A_ub=p["A"], b_ub=p["b"], bounds=(None, None),
                                    method="highs").fun)
            else:
                e = P.solve_cone_problem(p["c"], p["A"], p["b"], p["dims"],
                                         max_iter=CONE_MAX_ITER, use_fused=False, **CONE_TOL)
                ref = e["optval"]
                un, sc, bound = cone_residuals(P, torch, p, r["x"], CONE_TOL)
                rec.update(cone_residual=un, cone_residual_scaled=sc,
                           cone_residual_scaled_bound=bound)
                ok = ok and e["status"] == 0 and sc <= bound
            rec["reference_optval"] = ref
            rec["reference"] = oracle
            # Relative to max(1, |ref|), the scale of the solver's own gap
            # test: below 1 the tolerances are absolute.
            rec["abs_err"] = abs(r["optval"] - ref)
            rec["rel_err"] = rec["abs_err"] / max(1.0, abs(ref))
            ok = ok and rec["rel_err"] <= 1e-3 and np.all(np.isfinite(r["x"]))
        rec["ok"] = bool(ok)
        emit(rec)
        if not ok:
            raise AssertionError(f"cone main path: {name}")
    if total == 0:
        raise AssertionError("the cone main path never launched K3")
    return total


def phase_cone_real_size(torch, P):
    problems, _ = cone_problems()
    p = problems.socp_ball(n=2000, n_balls=4)
    m, n = p["A"].shape
    cones = P.dims_to_cones(p["dims"])
    S = P.SolverSettings
    st = S(max_iter=CONE_MAX_ITER, **CONE_TOL)
    out = {"phase": "cone_real_size", "shape": [m, n], "dtype": "float32"}
    t0 = time.perf_counter()
    k3 = P.ConeSolver(p["A"], Ky=cones, settings=st, dtype=torch.float32, device="cuda").init()
    torch.cuda.synchronize()
    out["init_ms"] = (time.perf_counter() - t0) * 1e3
    eager = P.ConeSolver(p["A"], Ky=cones, settings=st.replace(use_fused=False),
                         dtype=torch.float32, device="cuda")
    eager._init_state = k3._init_state
    before = read_counts()["fused_hsde_solve"]
    res = k3.solve(p["b"], p["c"])
    if read_counts()["fused_hsde_solve"] != before + 1 or res.status != P.Status.SUCCESS:
        raise AssertionError(f"8004x2000 through K3: {res.status.name}")
    iters = int(res.final_iter)
    times = [once_ms(torch, lambda: k3.solve(p["b"], p["c"])) for _ in range(3)]
    out["kernel"] = {"iterations": iters, "ms_per_solve": float(np.mean(times)),
                     "ms_per_solve_all": times, "ms_per_iter": float(np.mean(times)) / (iters + 1),
                     "optval": float(res.optval)}
    # The eager loop: its per-iteration time from a short run decides whether
    # the whole solve fits a minute; if not, both run to a fixed cap.
    probe = 50
    ms_probe = once_ms(torch, lambda: eager.solve(p["b"], p["c"], settings=st.replace(
        use_fused=False, max_iter=probe)))
    if ms_probe / probe * (iters + 1) <= 60e3:
        e_ms = once_ms(torch, lambda: eager.solve(p["b"], p["c"]))
        r_e = eager.solve(p["b"], p["c"])
        e_it = int(r_e.final_iter)
        if r_e.status != P.Status.SUCCESS or abs(e_it - iters) > 2:
            raise AssertionError(f"8004x2000 eager: {r_e.status.name}, {e_it} iterations")
        out["eager"] = {"iterations": e_it, "ms_per_solve": e_ms,
                        "ms_per_iter": e_ms / (e_it + 1),
                        "optval_rel_diff": abs(float(r_e.optval) - float(res.optval))
                        / max(abs(float(res.optval)), 1e-12)}
    else:
        cap = max(10, int(60e3 / (ms_probe / probe)) // 10 * 10)
        capped = st.replace(max_iter=cap)
        rk = k3.solve(p["b"], p["c"], settings=capped)
        e_ms = once_ms(torch, lambda: eager.solve(p["b"], p["c"], settings=capped.replace(
            use_fused=False)))
        re_ = eager.solve(p["b"], p["c"], settings=capped.replace(use_fused=False))
        out["eager"] = {"capped_at": cap, "ms_per_solve": e_ms, "ms_per_iter": e_ms / cap,
                        "x_max_abs_diff": float((rk.x - re_.x).abs().max())}
    out["kernel_speedup_per_iter"] = out["eager"]["ms_per_iter"] / out["kernel"]["ms_per_iter"]
    # The bound of the whole solve (hsde_work), and the per-iteration stream
    # of A, Aᵀ and Kinv at 3.35 TB/s as the yardstick of one iteration.
    n_iter = iters + 1 if iters < CONE_MAX_ITER else CONE_MAX_ITER
    n_bytes, flops = hsde_work(m, n, n_iter, hsde_checks(n_iter, CONE_MAX_ITER), 4)
    bms, bby = bound_ms(n_bytes, flops, "float32")
    stream_us = 4 * (2 * m * n + min(m, n) ** 2) / PEAK_BYTES * 1e6
    k_us = 1e3 * out["kernel"]["ms_per_solve"] / n_iter
    plan = k3_plan(torch, (k3._init_state["A"], None, None, k3.Ky))
    out["kernel"].update(bound_ms=bms, bound_by=bby, us_per_iter=k_us,
                         stream_us_per_iter=stream_us, share_of_stream=stream_us / k_us,
                         blocks=plan["blocks"], barriers_per_iter=plan["barriers_per_iter"])
    emit(out)
    return out


def phase_cone_warm_start(torch, P):
    problems, _ = cone_problems()
    p = problems.socp_ball()
    cones = P.dims_to_cones(p["dims"])
    st = P.SolverSettings(max_iter=CONE_MAX_ITER, **CONE_TOL)
    k3 = P.ConeSolver(p["A"], Ky=cones, settings=st, device="cuda").init()
    eager = P.ConeSolver(p["A"], Ky=cones, settings=st.replace(use_fused=False), device="cuda")
    eager._init_state = k3._init_state
    iters = {}
    for label, solver in (("kernel", k3), ("eager", eager)):
        before = read_counts()["fused_hsde_solve"]
        cold = solver.solve(p["b"], p["c"])
        warm = solver.solve(p["b"] * (1 + 1e-3), p["c"], warm_start=True)
        launched = read_counts()["fused_hsde_solve"] - before
        if cold.status != P.Status.SUCCESS or warm.status != P.Status.SUCCESS:
            raise AssertionError(f"warm start ({label}): {cold.status.name}, {warm.status.name}")
        if launched != (2 if label == "kernel" else 0):
            raise AssertionError(f"warm start ({label}): {launched} K3 launches")
        iters[label] = [int(cold.final_iter), int(warm.final_iter)]
    ok = all(abs(a - c) <= 2 for a, c in zip(iters["kernel"], iters["eager"]))
    ok = ok and all(w < c for c, w in iters.values())
    emit({"phase": "cone_warm_start", "shape": list(p["A"].shape), "dtype": "float64",
          "iterations_cold_warm": iters, "ok": ok})
    if not ok:
        raise AssertionError(f"cone warm start iterations {iters}")


# ---------------------------------------------------------------------------
# Slice 3: the sparse route (CSR + CGLS, the cg cone strategy) and the auto
# rule, which densifies a sparse A within 1 GiB on the card.
# ---------------------------------------------------------------------------

SPARSE_TOL = dict(abs_tol=1e-4, rel_tol=1e-4)  # benchmarks/sparse_bench.py:66
SPARSE_LASSO_SIZES = ((2000, 1000), (10000, 5000))  # benchmarks/sparse_bench.py:289-292
SPARSE_BUDGET_S = 60.0  # phase 15's solve; beyond it max_iter is cut


def sparse_lasso_problem(m, n, density):
    """The lasso of benchmarks/sparse_bench.py:53-67, seeded as there."""
    import scipy.sparse as sp

    rng = np.random.default_rng(5)
    A = sp.random(m, n, density=density, random_state=3, format="csr")
    A.data[:] = rng.standard_normal(A.nnz)
    x_true = np.zeros(n)
    idx = rng.choice(n, n // 20, replace=False)
    x_true[idx] = rng.standard_normal(idx.size)
    b = A @ x_true + 0.1 * rng.standard_normal(m)
    return A, b, 0.1 * float(np.max(np.abs(A.T @ b)))


def sparse_kkt(A, b, lam, x):
    """Max lasso KKT violation relative to λ, for a scipy A (float64)."""
    x = np.asarray(x, np.float64)
    grad = A.T @ (A @ x - b)
    viol = np.where(np.abs(x) > 1e-5, np.abs(grad + lam * np.sign(x)),
                    np.maximum(np.abs(grad) - lam, 0.0))
    return float(viol.max()) / lam


def sparse_counters():
    from pogs_tpu_torch.linalg.cgls import cgls_solve
    from pogs_tpu_torch.solver.hsde import cg_solve_normal_split

    return {"cgls_iterations": cgls_solve.iterations, "cgls_steps": cgls_solve.steps,
            **{f"cgls_exit_{k}": v for k, v in cgls_solve.exits.items()},
            "pcg_iterations": cg_solve_normal_split.iterations,
            "pcg_steps": cg_solve_normal_split.steps}


def counter_delta(before):
    now = sparse_counters()
    return {key: now[key] - before[key] for key in now}


def sparse_solve_ms(torch, solver, f, g, st, rho):
    """One solve from ρ on a reset warm start, timed by CUDA events."""
    solver.reset_warm_start()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    res = solver.solve(f, g, settings=st, rho=rho)
    stop.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(stop)


def check_every_ab(torch, solver, f, g, st):
    """The kept route with the done flag read every 2 (the setting) and every
    5 steps, in the order 2 5 5 2 2 5: ms per solve and frozen steps."""
    from pogs_tpu_torch.linalg import cgls

    out = {2: [], 5: []}
    frozen = {2: 0, 5: 0}
    for i, every in enumerate((2, 5, 5, 2, 2, 5)):
        c0 = sparse_counters()
        with patched(cgls, "CHECK_EVERY", every):
            _, ms = sparse_solve_ms(torch, solver, f, g, st, 1.0 + 1e-4 * i)
        cnt = counter_delta(c0)
        out[every].append(ms)
        frozen[every] += cnt["cgls_steps"] - cnt["cgls_iterations"]
    return {f"every_{k}": {"ms": v, "median_ms": float(np.median(v)),
                           "frozen_steps_per_solve": frozen[k] / len(v)}
            for k, v in out.items()}


def phase_sparse_lasso(torch, P):
    """Phase 14: sparse_bench's lasso kept (CSR + CGLS, eager) in f32 and f64
    and densified by the auto rule (K1), warm time per solve by route; the
    densified solve held to K1's plain version (the eager loop, use_fused
    off) on the same init at trajectory level (the same status, iterations
    within 2, x within 5e-5·max(1, ‖x‖∞)); at the first size the done-flag
    read every 2 against 5 CGLS steps."""
    F, S = P.Function, P.SolverSettings
    st = S(max_iter=2500, **SPARSE_TOL)
    rows = []
    for m, n in SPARSE_LASSO_SIZES:
        A, b, lam = sparse_lasso_problem(m, n, 0.01)
        rec = {"phase": "sparse_lasso", "shape": [m, n], "density": 0.01, "nnz": int(A.nnz)}
        objs = {}
        for label, dt, policy in (("keep_f32", torch.float32, "keep"),
                                  ("auto_f32", torch.float32, "auto"),
                                  ("keep_f64", torch.float64, "keep")):
            f = P.FunctionVector(F.SQUARE, m, b=b)
            g = P.FunctionVector(F.ABS, n, c=lam)
            t0 = time.perf_counter()
            solver = P.GraphFormSolver(A, dtype=dt, device="cuda", sparse_policy=policy).init()
            init_ms = (time.perf_counter() - t0) * 1e3
            k1 = read_counts()["fused_admm_loop"]
            c0 = sparse_counters()
            res, times, iters = None, [], []
            for i in range(3):  # one warm-up, then two timed; each from ρ ≈ 1
                res, ms = sparse_solve_ms(torch, solver, f, g, st, 1.0 + 1e-4 * i)
                times.append(ms)
                iters.append(int(res.final_iter))
                if res.status != P.Status.SUCCESS:
                    raise AssertionError(f"sparse lasso {m}x{n} {label}: {res.status.name}")
            launches = read_counts()["fused_admm_loop"] - k1
            cnt = counter_delta(c0)
            x = res.x.double().cpu().numpy()
            objs[label] = 0.5 * float(np.sum((A @ x - b) ** 2)) + lam * float(np.abs(x).sum())
            kkt = sparse_kkt(A, b, lam, x)
            r = {"dense": not solver.A.is_sparse, "init_ms": init_ms,
                 "ms_per_solve": float(np.mean(times[1:])), "ms_per_solve_all": times,
                 "iterations": iters, "k1_launches": launches, "kkt": kkt,
                 "objective": objs[label],
                 "cgls_iterations_per_solve": cnt["cgls_iterations"] / len(times),
                 "cgls_frozen_steps_per_solve":
                     (cnt["cgls_steps"] - cnt["cgls_iterations"]) / len(times),
                 "cgls_exits": {k[len("cgls_exit_"):]: v for k, v in cnt.items()
                                if k.startswith("cgls_exit_")}}
            r["ms_per_iter"] = r["ms_per_solve"] / (np.mean(iters[1:]) + 1)
            ok = launches == (len(times) if policy == "auto" else 0) and kkt < 1e-2 \
                and r["dense"] == (policy == "auto")
            if policy == "auto":
                # K1 against its plain version on the same densified init.
                plain, r["plain_ms"] = sparse_solve_ms(
                    torch, solver, f, g, S(max_iter=2500, use_fused=False, **SPARSE_TOL),
                    1.0 + 2e-4)
                ref = plain.x.double().cpu().numpy()
                x_err = float(np.abs(x - ref).max())
                r["vs_plain"] = {"status": [res.status.name, plain.status.name],
                                 "iterations": [iters[-1], int(plain.final_iter)],
                                 "x_max_abs_err": x_err,
                                 "x_limit": 5e-5 * max(1.0, float(np.abs(ref).max()))}
                ok = ok and res.status == plain.status \
                    and abs(iters[-1] - int(plain.final_iter)) <= 2 \
                    and x_err <= r["vs_plain"]["x_limit"] \
                    and read_counts()["fused_admm_loop"] - k1 == launches
            elif (m, n) == SPARSE_LASSO_SIZES[0]:
                r["check_every"] = check_every_ab(torch, solver, f, g, st)
            rec[label] = r
            if not ok:
                emit(rec)
                raise AssertionError(f"sparse lasso {m}x{n} {label}: {launches} K1 launches, "
                                     f"KKT {kkt}, {r.get('vs_plain')}")
        ref = objs["keep_f64"]
        rec["objective_rel_diff"] = {k: abs(v - ref) / abs(ref) for k, v in objs.items()}
        rec["keep_over_auto"] = rec["keep_f32"]["ms_per_solve"] / rec["auto_f32"]["ms_per_solve"]
        rec["ok"] = max(rec["objective_rel_diff"].values()) <= 1e-2
        emit(rec)
        if not rec["ok"]:
            raise AssertionError(f"sparse lasso {m}x{n}: objectives {objs}")
        rows.append(rec)
    return rows


def rcv1_sized_lasso():
    """The rcv1-sized lasso of benchmarks/real_data_benchmark.py:315-323."""
    import scipy.sparse as sp

    m, n, density = 20242, 47236, 0.0016
    rng = np.random.default_rng(11)
    A = sp.random(m, n, density=density, random_state=7, format="csr", dtype=np.float64)
    A.data[:] = rng.standard_normal(A.nnz)
    x_true = np.zeros(n)
    idx = rng.choice(n, 200, replace=False)
    x_true[idx] = rng.standard_normal(200)
    b = np.asarray(A @ x_true + 0.1 * rng.standard_normal(m))
    return A, b, 0.1 * float(np.max(np.abs(A.T @ b)))


def spmv_bytes(A, itemsize, transposed):
    """Bytes of one CSR product: values and column indices (int32) read once,
    the row pointers, the input vector read and the output written once."""
    m, n = A.shape
    rows, cols = (n, m) if transposed else (m, n)
    return A.nnz * (itemsize + 4) + 4 * (rows + 1) + itemsize * (cols + rows)


def phase_sparse_real_size(torch, P):
    """Phase 15: the rcv1-sized lasso through solve_lasso (auto keeps it
    sparse), and one mv and one rmv alone against their bound."""
    from pogs_tpu_torch.linalg.matrix import as_matrix_op
    from pogs_tpu_torch.solver.graph import densify_sparse

    t0 = time.perf_counter()
    A, b, lam = rcv1_sized_lasso()
    m, n = A.shape
    out = {"phase": "sparse_real_size", "shape": [m, n], "nnz": int(A.nnz),
           "dtype": "float32", "generate_s": time.perf_counter() - t0,
           "auto_densifies": densify_sparse("auto", (m, n), 4, "cuda")}
    if out["auto_densifies"]:
        raise AssertionError("the rcv1-sized A would be densified")
    tol = dict(gap_stop=False, **SPARSE_TOL)
    # A 20-iteration probe sets max_iter within the time budget.
    probe = P.GraphFormSolver(A, dtype=torch.float32, device="cuda")
    probe.init()
    t0 = time.perf_counter()
    probe.solve(P.FunctionVector(P.Function.SQUARE, m, b=b),
                P.FunctionVector(P.Function.ABS, n, c=lam),
                settings=P.SolverSettings(max_iter=20, **tol))
    per_iter = (time.perf_counter() - t0) / 20
    max_iter = 1000
    if per_iter * max_iter > SPARSE_BUDGET_S:
        max_iter = max(50, int(SPARSE_BUDGET_S / per_iter) // 10 * 10)
        out["max_iter_cut"] = f"max_iter 1000 -> {max_iter}: {per_iter * 1e3:.1f} ms per " \
                              f"iteration in a 20-iteration probe"
    out["max_iter"] = max_iter
    k1 = read_counts()["fused_admm_loop"]
    c0 = sparse_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = P.solve_lasso(A, b, lam, dtype=np.float32, max_iter=max_iter, **tol)
    wall = time.perf_counter() - t0
    cnt = counter_delta(c0)
    kkt = sparse_kkt(A, b, lam, r["x"])
    out.update(status=P.Status(r["status"]).name, iterations=r["iterations"], wall_s=wall,
               ms_per_iter=wall * 1e3 / (r["iterations"] + 1),
               cgls_iterations=cnt["cgls_iterations"],
               cgls_frozen_steps=cnt["cgls_steps"] - cnt["cgls_iterations"],
               cgls_exits={k[len("cgls_exit_"):]: v for k, v in cnt.items()
                           if k.startswith("cgls_exit_")},
               k1_launches=read_counts()["fused_admm_loop"] - k1, kkt=kkt)
    # One product of each direction alone, against bytes over 3.35 TB/s.
    op = as_matrix_op(A, torch.float32, "cuda")
    x = torch.randn(n, device="cuda")
    y = torch.randn(m, device="cuda")
    for name, fn, tr in (("mv", lambda: op.mv(x), False), ("rmv", lambda: op.rmv(y), True)):
        ms = cuda_ms(torch, fn, 50)
        bms, bby = bound_ms(spmv_bytes(A, 4, tr), 2 * A.nnz, "float32")
        out[name] = {"ms": ms, "bound_ms": bms, "bound_by": bby, "share": bms / ms}
    ok = (r["status"] in (0, int(P.Status.MAX_ITER)) and out["k1_launches"] == 0
          and cnt["cgls_iterations"] > 0 and kkt < 1e-2
          and (r["status"] == 0 or "max_iter_cut" in out))
    out["ok"] = bool(ok)
    emit(out)
    if not ok:
        raise AssertionError(f"rcv1-sized lasso: {out['status']}, KKT {kkt}")
    return out


def sparse_lp_problem(m0=800, n=300, density=0.02):
    """The LP of benchmarks/sparse_bench.py:145-170: sparse rows stacked with
    ±I, all NonNeg (1400x300 at the defaults)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(2)
    Araw = sp.random(m0, n, density=density, random_state=8, format="csr")
    Araw.data[:] = rng.standard_normal(Araw.nnz)
    A = sp.vstack([Araw, sp.eye(n), -sp.eye(n)]).tocsr()
    x0 = rng.standard_normal(n)
    b = A @ x0 + rng.random(A.shape[0]) + 0.1
    return {"A": A, "b": b, "c": rng.standard_normal(n), "dims": {"l": A.shape[0]}}


def phase_sparse_cone(torch, P):
    """Phase 16: a sparse LP and a sparse SOCP, kept (the cg strategy, eager,
    the polish on as by default) and densified by the auto rule (K3, polish
    off), each held to the eager f64 solve of its dense twin with the same
    polish setting (optimum_check's rule: the same status, c'x within
    1e-3·max(1, |c'x|), x within 1e-2·max(1, ‖x‖∞))."""
    import scipy.sparse as sp

    problems, _ = cone_problems()
    soc = problems.socp_ball()  # the preset's own size, as phases 10 to 13
    cases = (("lp_1400x300", sparse_lp_problem()),
             ("socp_ball_804x200", dict(soc, A=sp.csr_matrix(soc["A"]))))
    rows = []
    for name, p in cases:
        A, b, c, dims = p["A"], p["b"], p["c"], p["dims"]
        kw = dict(max_iter=CONE_MAX_ITER, dtype="float64", **CONE_TOL)
        twins = {polish: P.solve_cone_problem(c, A.toarray(), b, dims, use_fused=False,
                                              polish=polish, **kw)
                 for polish in (True, False)}
        rec = {"phase": "sparse_cone", "case": name, "shape": list(A.shape), "nnz": int(A.nnz),
               "dtype": "float64",
               "twin": {("polish" if k else "no_polish"): {
                   "status": t["status_name"], "iterations": t["iterations"],
                   "optval": t["optval"]} for k, t in twins.items()}}
        ok = all(t["status"] == 0 for t in twins.values())

        def held(r, polish):
            twin = twins[polish]
            x_ref = twin["x"]
            err = abs(r["optval"] - twin["optval"]) / max(1.0, abs(twin["optval"]))
            x_err = float(np.abs(r["x"] - x_ref).max()) / max(1.0, float(np.abs(x_ref).max()))
            return err, x_err, r["status"] == 0 and err <= 1e-3 and x_err <= 1e-2

        # Kept: the cg strategy in the eager loop (the polish on, as by default).
        cones = P.dims_to_cones(dims)
        kept = P.ConeSolver(A, Ky=cones, dtype=torch.float64, device="cuda",
                            sparse_policy="keep").init()
        c0 = sparse_counters()
        k3 = read_counts()["fused_hsde_solve"]
        t0 = time.perf_counter()
        res = kept.solve(b, c, settings=P.SolverSettings(max_iter=CONE_MAX_ITER, **CONE_TOL))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        cnt = counter_delta(c0)
        r_k = {"status": int(res.status), "optval": float(res.optval),
               "x": res.x.cpu().numpy()}
        err, x_err, good = held(r_k, True)
        it = int(res.final_iter)
        rec["kept"] = {"strategy": kept.strategy, "status": res.status.name, "iterations": it,
                       "ms_per_solve": ms, "ms_per_dr_iter": ms / (it + 1),
                       "pcg_iterations": cnt["pcg_iterations"],
                       "pcg_frozen_steps": cnt["pcg_steps"] - cnt["pcg_iterations"],
                       "pcg_per_dr_iter": cnt["pcg_iterations"] / (it + 1),
                       "k3_launches": read_counts()["fused_hsde_solve"] - k3,
                       "objective_rel_err": err, "x_rel_err": x_err}
        ok = ok and good and kept.strategy == "cg" and rec["kept"]["k3_launches"] == 0
        # Densified by the auto rule, without polish: one K3 launch.
        k3 = read_counts()["fused_hsde_solve"]
        t0 = time.perf_counter()
        r_d = P.solve_cone_problem(c, A, b, dims, polish=False, **kw)
        ms = (time.perf_counter() - t0) * 1e3
        err, x_err, good = held(r_d, False)
        launched = read_counts()["fused_hsde_solve"] - k3
        rec["densified"] = {"status": r_d["status_name"], "iterations": r_d["iterations"],
                            "ms_one_shot": ms, "k3_launches": launched,
                            "objective_rel_err": err, "x_rel_err": x_err}
        ok = ok and good and launched == 1
        rec["ok"] = bool(ok)
        emit(rec)
        if not ok:
            raise AssertionError(f"sparse cone {name}")
        rows.append(rec)
    return rows


# ---------------------------------------------------------------------------
# Slice 5: the QP and LP front ends and the batched cone and QP solves.  The
# HSDE solves on these paths run through K3 (the epigraph SOC is one
# segment); the IPM, the eigh of P and the PDAS polish run on the host.
# ---------------------------------------------------------------------------

CVXQP1_M_OPTVAL = 1.0875115673e6  # benchmarks/maros_meszaros.py:292-294, KKT-certified
QP_TOL = dict(abs_tol=1e-6, rel_tol=1e-6)  # benchmarks/maros_meszaros.py:380 (solve_with_pogs_tpu)


def maros():
    """benchmarks/maros_meszaros.py (numpy only), loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_smoke_maros", os.path.join(ROOT, "benchmarks", "maros_meszaros.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def qp_kwargs(p):
    """A maros_meszaros problem dict as solve_qp's arguments: '=' rows as
    A x = b, '<=' rows as G x ≤ h, '>=' rows negated into G."""
    eq = [i for i, s in enumerate(p["sense"]) if s == "="]
    le = [i for i, s in enumerate(p["sense"]) if s != "="]
    sign = np.array([1.0 if p["sense"][i] == "<=" else -1.0 for i in le])
    kw = dict(P=p["Q"], q=p["c"], lb=p["lb"], ub=p["ub"])
    if eq:
        kw.update(A=p["A"][eq], b=p["rhs"][eq])
    if le:
        kw.update(G=sign[:, None] * p["A"][le], h=sign * p["rhs"][le])
    return kw


class K3Recorder:
    """Inside the block, every K3 launch that ConeSolver or the cone batches
    make is bracketed by CUDA events, and the arguments and result of the
    last one are kept (to run the plain version on the same inputs)."""

    def __init__(self, torch):
        self.torch, self.events, self.last = torch, [], None

    @contextlib.contextmanager
    def on(self):
        import pogs_tpu_torch.parallel.batch as batch_mod
        import pogs_tpu_torch.solver.cone as cone_mod

        inner = cone_mod.fused_hsde_solve
        torch = self.torch

        def recorded(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*args, **kw)
            stop.record()
            self.events.append((start, stop))
            self.last = (args, kw, out)
            return out

        with patched(cone_mod, "fused_hsde_solve", recorded), \
                patched(batch_mod, "fused_hsde_solve", recorded):
            yield self

    def ms(self):
        self.torch.cuda.synchronize()
        return float(sum(a.elapsed_time(b) for a, b in self.events))


@contextlib.contextmanager
def uncounted():
    """K3 launches inside the block (comparison runs) leave its count alone."""
    from pogs_tpu_torch.ops.fused_hsde import fused_hsde_solve

    saved = fused_hsde_solve.launches
    try:
        yield
    finally:
        fused_hsde_solve.launches = saved


@contextlib.contextmanager
def host_timed(module, name, acc, key, sync=None):
    """module.<name> wrapped so that its host time adds to acc[key]."""
    inner = getattr(module, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        if sync is not None:
            sync()
        acc[key] = acc.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    with patched(module, name, timed):
        yield


def kkt_score(P, p, x, lam_split):
    """qp_polish.kkt_residuals of a solve_qp result on the solver's own
    lowering (equalities, G rows, finite upper bounds, finite lower bounds)."""
    from pogs_tpu_torch.solver.qp_polish import kkt_residuals

    kw = qp_kwargs(p)
    n = len(kw["q"])
    rows, rhs, kind, lam = [], [], [], []
    if "A" in kw:
        rows.append(kw["A"]), rhs.append(kw["b"]), kind.append(np.zeros(len(kw["b"])))
        lam.append(lam_split["y_eq"])
    if "G" in kw:
        rows.append(kw["G"]), rhs.append(kw["h"]), kind.append(np.ones(len(kw["h"])))
        lam.append(lam_split["z_ineq"])
    ub, lb = np.flatnonzero(np.isfinite(kw["ub"])), np.flatnonzero(np.isfinite(kw["lb"]))
    rows.append(np.eye(n)[ub]), rhs.append(kw["ub"][ub]), kind.append(np.ones(ub.size))
    lam.append(lam_split["z_ub"][ub])
    rows.append(-np.eye(n)[lb]), rhs.append(-kw["lb"][lb]), kind.append(np.ones(lb.size))
    lam.append(lam_split["z_lb"][lb])
    res = kkt_residuals(kw["P"], kw["q"], np.vstack(rows), np.concatenate(rhs),
                        np.concatenate(kind).astype(np.int8), x, np.concatenate(lam))
    return {k: float(v) for k, v in res.items()}


def phase_qp_main_path(torch, P):
    """CVXQP1_M (n = 1000, 500 equalities, 0.1 ≤ x ≤ 10) in f64 through
    solve_qp on the card, three routes: the default (the host IPM first), the
    staged HSDE route (the IPM patched out: K3 segments of 500 iterations,
    the PDAS polish after each), and polish=False with max_iter 1000 (one
    unstaged K3 solve, held to the plain version on the same scaled
    extension)."""
    import pogs_tpu_torch.solver.cone as cone_mod
    from pogs_tpu_torch.ops.fused_hsde import fused_hsde_solve_ref

    p = maros().cvxqp_problem(1, 1000, CVXQP1_M_OPTVAL)
    kw = qp_kwargs(p)
    Pm, q = kw.pop("P"), kw.pop("q")
    run = dict(max_iter=40000, dtype="float64", device="cuda", **QP_TOL)
    out = {"phase": "qp_main_path", "problem": "CVXQP1_M", "n": len(q)}

    # 1. The default route.
    k3 = read_counts()["fused_hsde_solve"]
    t0 = time.perf_counter()
    r = P.solve_qp(Pm, q, **kw, **run)
    wall = (time.perf_counter() - t0) * 1e3
    launched = read_counts()["fused_hsde_solve"] - k3
    out["default"] = {"status": r["status_name"], "ipm_certified": launched == 0,
                      "newton_steps": r["iterations"] if launched == 0 else None,
                      "k3_launches": launched, "ms": wall,
                      "rel_err": abs(r["optval"] - CVXQP1_M_OPTVAL) / CVXQP1_M_OPTVAL}
    ok = r["status"] == 0 and out["default"]["rel_err"] <= 1e-6

    # 2. The staged HSDE route, the IPM patched out; the time split.
    rec, acc = K3Recorder(torch), {}
    k3 = read_counts()["fused_hsde_solve"]
    with patched(cone_mod.ConeSolver, "_try_qp_ipm", lambda self, *a: None), rec.on(), \
            host_timed(cone_mod, "epigraph_factor", acc, "eigh_ms"), \
            host_timed(cone_mod.ConeSolver, "_polish_qp", acc, "polish_ms"), \
            host_timed(cone_mod.ConeSolver, "init", acc, "init_ms", torch.cuda.synchronize):
        t0 = time.perf_counter()
        r = P.solve_qp(Pm, q, **kw, **run)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    launched = read_counts()["fused_hsde_solve"] - k3
    k3_ms = rec.ms()
    score = kkt_score(Pm, p, r["x"], r)
    rel = abs(r["optval"] - CVXQP1_M_OPTVAL) / CVXQP1_M_OPTVAL
    out["A_ext"] = [r["solver"]._qp_sub.m, r["solver"]._qp_sub.n]
    out["staged"] = {"status": r["status_name"], "dr_iterations": r["iterations"],
                     "k3_launches": launched, "segments": len(rec.events), "ms": wall,
                     "k3_ms": k3_ms, "polish_ms": acc.get("polish_ms", 0.0),
                     "eigh_ms": acc.get("eigh_ms", 0.0), "init_ms": acc.get("init_ms", 0.0),
                     "rest_ms": wall - k3_ms - sum(acc.values()),
                     "rel_err": rel, "kkt": score}
    ok = (ok and r["status"] == 0 and rel <= 1e-6 and launched >= 1
          and max(score.values()) <= QP_TOL["abs_tol"])

    # 3. polish=False, max_iter 1000: one K3 solve against its plain version.
    rec = K3Recorder(torch)
    k3 = read_counts()["fused_hsde_solve"]
    with rec.on():
        t0 = time.perf_counter()
        r = P.solve_qp(Pm, q, **kw, **dict(run, max_iter=1000, polish=False))
        wall = (time.perf_counter() - t0) * 1e3
    launched = read_counts()["fused_hsde_solve"] - k3
    args, kwargs, out_k = rec.last
    t0 = time.perf_counter()
    out_p = fused_hsde_solve_ref(*args[:11], u0=kwargs.get("u0"))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n_ext = args[0].shape[1]
    x_k, x_p = (o["w"][:n_ext] / o["w"][-1] for o in (out_k, out_p))
    x_err = float((x_k - x_p).abs().max())
    lim = 1e-8 * max(1.0, float(x_p.abs().max()))
    it_k, it_p = int(out_k["final_iter"]), int(out_p["final_iter"])
    from pogs_tpu_torch.ops.fused_hsde import launch_plan, _lib, segments
    plan = launch_plan(_lib(), args[0].device, args[0].dtype, *args[0].shape, segments(args[3]))
    out["no_polish"] = {"status": r["status_name"], "iterations": r["iterations"],
                        "k3_launches": launched, "ms": wall, "k3_ms": rec.ms(),
                        "plain_ms": plain_ms, "kernel_vs_plain": {
                            "status": [int(out_k["status"]), int(out_p["status"])],
                            "iters": [it_k, it_p], "x_max_abs_err": x_err, "x_limit": lim},
                        "blocks": plan["blocks"], "smem": plan["smem"],
                        "soc_owner": plan["owners"]}
    ok = (ok and launched == 1 and int(out_k["status"]) == int(out_p["status"])
          and abs(it_k - it_p) <= 2 and x_err <= lim)
    out["ok"] = bool(ok)
    emit(out)
    if not ok:
        raise AssertionError("qp main path")
    return out


def phase_qp_admm(torch, P):
    """qp_via="admm" (the eager graph-form loop with the eigenbasis x-prox,
    then the PDAS polish) on CVXQP1_S and HS21, against the published
    optima."""
    mm = maros()
    rows = []
    for p in (mm.cvxqp_problem(1, 100, 1.1590718e4), mm.problems()[0]):
        kw = qp_kwargs(p)
        t0 = time.perf_counter()
        r = P.solve_qp(kw.pop("P"), kw.pop("q"), **kw, qp_via="admm", max_iter=4000,
                       dtype="float64", device="cuda", **QP_TOL)
        ms = (time.perf_counter() - t0) * 1e3
        obj = r["optval"] + p["c0"]
        rel = abs(obj - p["optval"]) / abs(p["optval"])
        rec = {"phase": "qp_admm", "problem": p["name"], "status": r["status_name"],
               "iterations": r["iterations"], "objective": obj, "published": p["optval"],
               "rel_err": rel, "ms": ms, "ok": r["status"] == 0 and rel <= 1e-6}
        emit(rec)
        if not rec["ok"]:
            raise AssertionError(f"qp_via=admm on {p['name']}")
        rows.append(rec)
    return rows


def phase_batched_cone(torch, P):
    """batched_cone_solve on socp_ball 804x200 f64 with K = 8 perturbed b (8
    K3 launches): lanes 0 and 7 against the eager plain version, every lane
    against one ConeSolver solve of its b; warm_path_cone_solve on lp_ineq
    1100x300 f64 over 6 drifting b against cold solves of the same b."""
    problems, _ = cone_problems()
    soc = problems.socp_ball()
    cones = P.dims_to_cones(soc["dims"])
    K = 8
    rng = np.random.default_rng(8)
    bs = soc["b"][None, :] * (1.0 + 0.02 * rng.standard_normal((K, 1)))
    st = P.SolverSettings(max_iter=CONE_MAX_ITER, **CONE_TOL)
    rec_k = K3Recorder(torch)
    k3 = read_counts()["fused_hsde_solve"]
    with rec_k.on():
        t0 = time.perf_counter()
        out = P.batched_cone_solve(soc["A"], bs, soc["c"], cones, settings=st, device="cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    launched = read_counts()["fused_hsde_solve"] - k3
    iters = out["iterations"].cpu().tolist()
    rec = {"phase": "batched_cone", "problem": "socp_ball", "shape": list(soc["A"].shape),
           "dtype": "float64", "K": K, "k3_launches": launched, "ms": wall,
           "k3_ms": rec_k.ms(), "iterations": iters, "status": out["status"].cpu().tolist()}
    ok = launched == K and all(s == 0 for s in rec["status"])
    # Lanes 0 and 7 against the eager plain version (the same factor).
    t0 = time.perf_counter()
    plain = P.batched_cone_solve(soc["A"], bs[[0, K - 1]], soc["c"], cones,
                                 settings=st.replace(use_fused=False), device="cuda")
    torch.cuda.synchronize()
    rec["plain_ms_2_lanes"] = (time.perf_counter() - t0) * 1e3
    vs_plain = []
    for j, k in enumerate((0, K - 1)):
        x, x_p = out["x"][k], plain["x"][j]
        err = float((x - x_p).abs().max())
        lim = 1e-8 * max(1.0, float(x_p.abs().max()))
        d_it = abs(iters[k] - int(plain["iterations"][j]))
        vs_plain.append({"lane": k, "iters_plain": int(plain["iterations"][j]),
                         "x_max_abs_err": err, "x_limit": lim})
        ok = ok and int(plain["status"][j]) == rec["status"][k] and d_it <= 2 and err <= lim
    rec["vs_plain"] = vs_plain
    # Every lane against a single ConeSolver solve of its b (K3 too): a lane
    # does not depend on K.
    worst = 0.0
    for k in range(K):
        with uncounted():
            r = P.ConeSolver(soc["A"], Ky=cones, settings=st, device="cuda").solve(
                bs[k], soc["c"])
        worst = max(worst, float((r.x - out["x"][k]).abs().max()))
        ok = ok and int(r.final_iter) == iters[k] and int(r.status) == rec["status"][k]
    rec["vs_single_solve_x_max_abs_err"] = worst
    ok = ok and worst <= 1e-9 * max(1.0, float(out["x"].abs().max()))

    # The warm path against cold solves of the same b.
    lp = problems.lp_ineq()
    lp_cones = P.dims_to_cones(lp["dims"])
    drift = lp["b"][None, :] * (1.0 + 2e-3 * np.arange(6)[:, None])
    k3 = read_counts()["fused_hsde_solve"]
    t0 = time.perf_counter()
    warm = P.warm_path_cone_solve(lp["A"], drift, lp["c"], lp_cones, settings=st, device="cuda")
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    launched = read_counts()["fused_hsde_solve"] - k3
    t0 = time.perf_counter()
    with uncounted():
        cold = P.batched_cone_solve(lp["A"], drift, lp["c"], lp_cones, settings=st,
                                    device="cuda")
        torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    w_ov, c_ov = warm["optval"].cpu().numpy(), cold["optval"].cpu().numpy()
    ov_err = float(np.max(np.abs(w_ov - c_ov) / np.maximum(1.0, np.abs(c_ov))))
    rec["warm_path"] = {"problem": "lp_ineq", "shape": list(lp["A"].shape), "steps": 6,
                        "k3_launches": launched,
                        "iterations_warm": warm["iterations"].cpu().tolist(),
                        "iterations_cold": cold["iterations"].cpu().tolist(),
                        "ms_warm": warm_ms, "ms_cold": cold_ms, "optval_rel_err": ov_err}
    ok = (ok and launched == 6
          and bool((warm["status"] == 0).all()) and bool((cold["status"] == 0).all())
          and ov_err <= 1e-3)
    rec["ok"] = bool(ok)
    emit(rec)
    if not ok:
        raise AssertionError("batched cone")
    return rec


def phase_batched_qp(torch, P):
    """batched_qp_solve on CVXQP1_S with K = 16 perturbed q: the shared
    epigraph extension, one K3 launch per lane, then the JAX package's one
    host PDAS polish per lane (tol 1e-5, 5000 iterations).  Polished lanes
    within 1e-6 of a per-lane solve_qp, no lane the polish rejects called
    SUCCESS, and the unpolished lanes reported (ROADMAP §3).  Then the
    staged single-QP route (solve_qp's ConeSolver, the IPM patched out:
    500-iteration K3 segments, a polish attempt after each) on every lane:
    SUCCESS within 1e-6 of the per-lane solve_qp; and on lane 0, the lane
    with the most segments and the unpolished lanes again by the plain
    version: the warm-started segments give the same status and iteration
    totals, x within 1e-8."""
    import pogs_tpu_torch.parallel.batch as batch_mod

    p = maros().cvxqp_problem(1, 100, 1.1590718e4)
    kw = qp_kwargs(p)
    A, b = kw["A"], kw["b"]
    n, m_eq = len(kw["q"]), len(b)
    # The lowering solve_qp makes: equalities, then x ≤ ub, then −x ≤ −lb.
    A_bar = np.vstack([A, np.eye(n), -np.eye(n)])
    b_bar = np.concatenate([b, kw["ub"], -kw["lb"]])
    m = A_bar.shape[0]
    Ky = [P.ConeConstraint(P.Cone.ZERO, range(m_eq)),
          P.ConeConstraint(P.Cone.NON_NEG, range(m_eq, m))]
    K = 16
    rng = np.random.default_rng(3)
    qs = kw["q"][None, :] + 0.1 * rng.standard_normal((K, n))
    bs = np.broadcast_to(b_bar, (K, m))
    ref = []
    for k in range(K):
        r = P.solve_qp(kw["P"], qs[k], A=A, b=b, lb=kw["lb"], ub=kw["ub"], dtype="float64",
                       device="cuda", abs_tol=1e-9, rel_tol=1e-9)
        ref.append(r["optval"] if r["status"] == 0 else float("nan"))
    ref = np.array(ref)
    rec = {"phase": "batched_qp", "problem": "CVXQP1_S", "K": K, "A_ext": [m + n + 2, n + 1]}
    ok = bool(np.all(np.isfinite(ref)))
    st = P.SolverSettings(abs_tol=1e-5, rel_tol=1e-5, max_iter=5000)
    rec_k, acc = K3Recorder(torch), {}
    k3 = read_counts()["fused_hsde_solve"]
    with rec_k.on(), host_timed(batch_mod, "active_set_polish", acc, "polish_ms"):
        t0 = time.perf_counter()
        out = P.batched_qp_solve(A_bar, kw["P"], bs, qs, Ky, settings=st, device="cuda")
        wall = (time.perf_counter() - t0) * 1e3
    err = np.abs(out["optval"] - ref) / np.maximum(1.0, np.abs(ref))
    pol = out["polished"]
    rec.update({"tol": st.abs_tol, "max_iter": st.max_iter,
                "k3_launches": read_counts()["fused_hsde_solve"] - k3, "ms": wall,
                "k3_ms": rec_k.ms(), "polish_ms": acc.get("polish_ms", 0.0),
                "iterations": np.asarray(out["iterations"]).tolist(),
                "status": np.asarray(out["status"]).tolist(), "polished": int(pol.sum()),
                "unpolished_lanes": np.flatnonzero(~pol).tolist(),
                "optval_rel_err_max_polished": float(err[pol].max(initial=0.0))})
    # Correct either way: a polished lane at the optimum, and no lane the
    # polish rejects reported as SUCCESS.
    ok = (ok and rec["k3_launches"] == K and err[pol].max(initial=0.0) <= 1e-6
          and bool(np.all(out["status"][~pol] != 0)))

    # Warm-started segments: the staged single-QP route on every lane on K3,
    # and on the plain version (use_fused=False) for lane 0, the lane with
    # the most segments and the unpolished lanes.
    import pogs_tpu_torch.solver.cone as cone_mod

    staged = P.SolverSettings(max_iter=40000, **QP_TOL)

    def staged_solve(k, settings):
        solver = P.ConeSolver(A_bar, Ky=Ky, dtype=torch.float64, device="cuda")
        k3 = read_counts()["fused_hsde_solve"]
        r = solver.solve(bs[k], qs[k], P=kw["P"], settings=settings)
        return r, read_counts()["fused_hsde_solve"] - k3

    with patched(cone_mod.ConeSolver, "_try_qp_ipm", lambda self, *a: None):
        t0 = time.perf_counter()
        runs = [staged_solve(k, staged) for k in range(K)]
        wall = (time.perf_counter() - t0) * 1e3
        iters = [int(r.final_iter) for r, _ in runs]
        err = np.array([abs(float(r.optval) - ref[k]) / max(1.0, abs(ref[k]))
                        for k, (r, _) in enumerate(runs)])
        rec["staged_single"] = {
            "ms": wall, "iterations": iters, "status": [r.status.name for r, _ in runs],
            "k3_launches": [n_k3 for _, n_k3 in runs],
            "optval_rel_err_max": float(err.max()), "vs_plain": []}
        ok = (ok and all(n_k3 >= 1 and r.status == P.Status.SUCCESS for r, n_k3 in runs)
              and err.max() <= 1e-6)
        for k in sorted({0, int(np.argmax(iters)), *np.flatnonzero(~pol).tolist()}):
            (rk, _), (rp, launched_p) = runs[k], staged_solve(k, staged.replace(use_fused=False))
            x_err = float((rk.x - rp.x).abs().max())
            lim = 1e-8 * max(1.0, float(rp.x.abs().max()))
            rec["staged_single"]["vs_plain"].append({
                "lane": k, "status": [rk.status.name, rp.status.name],
                "iterations": [iters[k], int(rp.final_iter)], "x_max_abs_err": x_err})
            ok = (ok and rk.status == rp.status and launched_p == 0
                  and abs(iters[k] - int(rp.final_iter)) <= 2 and x_err <= lim)
    rec["ok"] = bool(ok)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("batched qp")
    return rec


def phase_qps(torch, P):
    """solve_qps on tests/data/HS21.QPS: SUCCESS, objective within 1e-6
    of the published -99.96."""
    t0 = time.perf_counter()
    r = P.solve_qps(os.path.join(ROOT, "tests", "data", "HS21.QPS"), device="cuda")
    ms = (time.perf_counter() - t0) * 1e3
    rel = abs(r["objective"] - (-99.96)) / 99.96
    rec = {"phase": "qps", "name": r["name"], "status": r["status_name"],
           "iterations": r["iterations"], "objective": r["objective"], "rel_err": rel, "ms": ms,
           "ok": r["status"] == 0 and rel <= 1e-6}
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("solve_qps HS21")
    return rec


# ---------------------------------------------------------------------------
# Slice 6: the differentiable layers.  Each forward solve is one K1 launch
# (graph form) or one K3 launch (cone form, SOC / exponential cones); the
# backward pass is dense linear algebra outside the kernels: the fixed-point
# Jacobian (torch.func.jacfwd) and its solve, or GMRES on vector-Jacobian
# products, then one vector-Jacobian product for the parameters.
# ---------------------------------------------------------------------------

DIFF_PARTS = ("fixed_point_jacobian", "adjoint_solve", "param_vjp")


class LayerTimer:
    """Inside the block, the solve kernels that the layers' forward passes
    launch and the three parts of the backward pass (api/diff.py's
    fixed_point_jacobian, adjoint_solve and param_vjp, which api/diff_cone.py
    imports) are bracketed by CUDA events."""

    def __init__(self, torch):
        self.torch = torch
        self.events = {key: [] for key in ("k1", "k3") + DIFF_PARTS}

    def _timed(self, fn, key):
        torch = self.torch

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            stop.record()
            self.events[key].append((start, stop))
            return out

        return timed

    @contextlib.contextmanager
    def on(self):
        import pogs_tpu_torch.api.diff as diff_mod
        import pogs_tpu_torch.api.diff_cone as cone_diff_mod
        import pogs_tpu_torch.solver.cone as cone_mod
        import pogs_tpu_torch.solver.graph as graph_mod

        targets = [(graph_mod, "fused_admm_loop", "k1"), (cone_mod, "fused_hsde_solve", "k3")]
        targets += [(mod, part, part) for mod in (diff_mod, cone_diff_mod) for part in DIFF_PARTS]
        with contextlib.ExitStack() as stack:
            for mod, name, key in targets:
                stack.enter_context(patched(mod, name, self._timed(getattr(mod, name), key)))
            yield self

    def ms(self):
        self.torch.cuda.synchronize()
        return {key: float(sum(a.elapsed_time(b) for a, b in ev))
                for key, ev in self.events.items()}


def layer_run(torch, fn, args, loss_of_x):
    """A forward and a backward of a layer, twice: the first call's host
    times (cold: the process's first use of a shape pays cuSOLVER and
    torch.func set-up), then the second's, with the CUDA-event split of its
    kernel launches and backward parts and the launches of its forward.
    Returns (x, aux, grads, times) of the second call."""
    times = {}
    for run in ("first", "warm"):
        timer = LayerTimer(torch)
        leaves = [a.detach().clone().requires_grad_() for a in args]
        before = read_counts()
        with timer.on():
            t0 = time.perf_counter()
            x, aux = fn(*leaves)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            after = read_counts()
            grads = torch.autograd.grad(loss_of_x(x), leaves)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        times[f"{run}_forward_ms"] = (t1 - t0) * 1e3
        times[f"{run}_backward_ms"] = (t2 - t1) * 1e3
    ev = timer.ms()
    times.update({
        "k1_launches": after["fused_admm_loop"] - before["fused_admm_loop"],
        "k3_launches": after["fused_hsde_solve"] - before["fused_hsde_solve"],
        "k1_ms": ev["k1"], "k3_ms": ev["k3"], "jacobian_ms": ev["fixed_point_jacobian"],
        "linear_solve_ms": ev["adjoint_solve"], "param_vjp_ms": ev["param_vjp"]})
    return x.detach(), aux, [g.detach() for g in grads], times


def central_diff(loss, p, V, eps):
    """(loss(p + eps V) − loss(p − eps V)) / (2 eps), the two loss values
    host floats."""
    return (float(loss(p + eps * V)) - float(loss(p - eps * V))) / (2 * eps)


def forward_match(x, aux, x_e, aux_e):
    """The layer's forward against the eager forward: statuses equal,
    iterations within 2, x within 1e-8·max(1, ‖x‖∞)."""
    err = float((x - x_e).abs().max())
    lim = 1e-8 * max(1.0, float(x_e.abs().max()))
    rec = {"status": int(aux["status"]), "status_eager": int(aux_e["status"]),
           "iterations": int(aux["iterations"]), "iterations_eager": int(aux_e["iterations"]),
           "x_max_abs_err": err, "x_limit": lim}
    ok = (rec["status"] == rec["status_eager"] == 0
          and abs(rec["iterations"] - rec["iterations_eager"]) <= 2 and err <= lim)
    return rec, ok


def phase_diff_graph(torch, P):
    """diff_lasso on the bench lasso (500x300, f64, the layer's defaults):
    one K1 launch per forward, the forward held to the eager one, dλ and a
    directional derivative in A of ½‖x‖² against central differences through
    K1 forwards; diff_lasso at 2000x1000 (the gmres route), its forward held
    to the eager one and its gradient to linear_solver="dense"; an
    OptNet-style diff_qp (n = 100, 50 inequalities, 50 equalities) on a batch
    of 16 q, one K1 launch per element, each element its own single call and
    the eager forward, dx/dq of one element against differences."""
    from pogs_tpu_torch.api.diff import diff_lasso, diff_qp
    from pogs_tpu_torch.linalg.gmres import gmres

    dev, f64 = torch.device("cuda"), torch.float64
    S = P.SolverSettings
    defaults = dict(abs_tol=1e-6, rel_tol=1e-6, max_iter=20000)  # make_diff_solver's
    rng = np.random.default_rng(22)

    def k1():
        return read_counts()["fused_admm_loop"]

    def half_sq(x):
        return 0.5 * torch.sum(x * x)

    A32, b32, lam = make_lasso(500, 300)
    A = torch.as_tensor(A32, dtype=f64, device=dev)
    b = torch.as_tensor(b32, dtype=f64, device=dev)
    lam_t = torch.tensor(lam, dtype=f64, device=dev)
    x, aux, (g_A, _, g_lam), times = layer_run(torch, diff_lasso, (A, b, lam_t), half_sq)
    rec = {"phase": "diff_graph", "problem": "bench lasso", "shape": [500, 300],
           "dtype": "float64", "route": "dense", **times}
    ok = times["k1_launches"] == 1
    before = k1()
    x_e, aux_e = diff_lasso(A, b, lam_t, settings=S(use_fused=False, **defaults))
    match, ok_m = forward_match(x, aux, x_e, aux_e)
    rec["vs_eager"] = match
    ok = ok and ok_m and k1() == before

    def loss(A_, lam_):
        return half_sq(diff_lasso(A_, b, lam_)[0])

    before = k1()
    eps = 1e-3 * lam
    fd_lam = central_diff(lambda l: loss(A, l), lam_t, torch.ones_like(lam_t), eps)
    V = torch.as_tensor(rng.standard_normal(A.shape), dtype=f64, device=dev)
    fd_A = central_diff(lambda A_: loss(A_, lam_t), A, V, 1e-5)
    g_A_V = float(torch.sum(g_A * V))
    rec["fd"] = {"d_lambda": float(g_lam), "d_lambda_fd": fd_lam, "d_A_V": g_A_V,
                 "d_A_V_fd": fd_A, "k1_launches": k1() - before}
    ok = (ok and rec["fd"]["k1_launches"] == 4
          and abs(float(g_lam) - fd_lam) <= 1e-3 * abs(fd_lam)
          and abs(g_A_V - fd_A) <= 1e-3 * abs(fd_A))

    # 2000x1000: m + n = 3000 > 2048, the gmres route; against the dense one.
    A2_32, b2_32, lam2 = make_lasso(2000, 1000)
    A2 = torch.as_tensor(A2_32, dtype=f64, device=dev)
    b2 = torch.as_tensor(b2_32, dtype=f64, device=dev)
    lam2_t = torch.tensor(lam2, dtype=f64, device=dev)
    x2, aux2, (g2,), times2 = layer_run(torch, lambda l: diff_lasso(A2, b2, l), (lam2_t,),
                                        half_sq)
    restarts = gmres.restarts
    before = k1()
    x2_e, aux2_e = diff_lasso(A2, b2, lam2_t, settings=S(use_fused=False, **defaults))
    match2, ok_m2 = forward_match(x2, aux2, x2_e, aux2_e)
    ok = ok and ok_m2 and k1() == before
    _, _, (g2_dense,), times2_dense = layer_run(
        torch, lambda l: diff_lasso(A2, b2, l, linear_solver="dense"), (lam2_t,), half_sq)
    rel = abs(float(g2) - float(g2_dense)) / abs(float(g2_dense))
    rec["gmres"] = {"shape": [2000, 1000], "status": int(aux2["status"]),
                    "iterations": int(aux2["iterations"]), "gmres_restarts": restarts,
                    "d_lambda": float(g2), "d_lambda_dense": float(g2_dense), "rel_err": rel,
                    "vs_eager": match2, **times2, "dense": times2_dense}
    ok = (ok and int(aux2["status"]) == 0 and times2["k1_launches"] == 1
          and times2_dense["k1_launches"] == 1 and rel <= 1e-6)

    # OptNet-style QP layer on a batch of 16 q.
    n, mi, me, K = 100, 50, 50, 16
    M = rng.standard_normal((n, n))
    Pm = M @ M.T / n + np.eye(n)
    G = rng.standard_normal((mi, n))
    Aeq = rng.standard_normal((me, n))
    x0 = rng.standard_normal(n)
    h = G @ x0 + rng.random(mi) + 0.1
    beq = Aeq @ x0
    qs = rng.standard_normal((K, n))
    Pt, Gt, ht, At, bt, qt = (torch.as_tensor(v, dtype=f64, device=dev)
                              for v in (Pm, G, h, Aeq, beq, qs))

    def qp(q_, settings=None):
        return diff_qp(Pt, q_, G=Gt, h=ht, A=At, b=bt, settings=settings)

    xq, auxq, (gq,), times_q = layer_run(torch, qp, (qt,), half_sq)
    worst = 0.0
    iters_equal = True
    for i in range(K):
        x_i, aux_i = qp(qt[i])
        worst = max(worst, float((x_i - xq[i]).abs().max()))
        iters_equal = iters_equal and int(aux_i["iterations"]) == int(auxq["iterations"][i])
    # K1 on the QP's prox mix (SQUARE rows from Lᵀ, shifted INDLE0 and INDEQ0
    # rows, ZERO with a linear term) against the eager loop, lane by lane.
    before = k1()
    xq_e, auxq_e = qp(qt, settings=S(use_fused=False, **defaults))
    lanes_e = [forward_match(xq[i], {k: auxq[k][i] for k in ("status", "iterations")},
                             xq_e[i], {k: auxq_e[k][i] for k in ("status", "iterations")})
               for i in range(K)]
    eager_ok = all(ok_i for _, ok_i in lanes_e) and k1() == before
    Vq = torch.as_tensor(rng.standard_normal(n), dtype=f64, device=dev)
    lane = 3
    fd_q = central_diff(lambda q_: half_sq(qp(q_)[0]), qt[lane], Vq, 1e-5)
    g_q_V = float(gq[lane] @ Vq)
    rec["qp"] = {"n": n, "inequalities": mi, "equalities": me, "batch": K,
                 "status": auxq["status"].cpu().tolist(),
                 "iterations": auxq["iterations"].cpu().tolist(),
                 "vs_single_x_max_abs_err": worst,
                 "vs_eager_x_max_abs_err": max(r["x_max_abs_err"] for r, _ in lanes_e),
                 "vs_eager_iterations": auxq_e["iterations"].cpu().tolist(),
                 "vs_eager_ok": eager_ok, "lane": lane, "d_q_V": g_q_V,
                 "d_q_V_fd": fd_q, **times_q}
    ok = (ok and times_q["k1_launches"] == K and bool((auxq["status"] == 0).all())
          and iters_equal and eager_ok
          and worst <= 1e-12 * max(1.0, float(xq.abs().max()))
          and abs(g_q_V - fd_q) <= 1e-3 * abs(fd_q))
    rec["ok"] = bool(ok)
    emit(rec)
    if not ok:
        raise AssertionError("differentiable graph-form layers")
    return rec


def phase_diff_cone(torch, P):
    """diff_cone_solve on socp_ball 804x200 f64: one K3 launch per forward,
    the forward held to the eager one (tol 1e-4), and at tol 1e-7 the
    gradient w.r.t. b in one direction against central differences through
    K3 forwards; the exp-primal conic fixture through K3 (optimum e, the b
    gradient against differences); lp_ineq 1100x300 with the default polish,
    which runs the eager loop and launches no K3 (optval against HiGHS)."""
    from scipy.optimize import linprog

    from pogs_tpu_torch.api.diff_cone import diff_cone_solve

    dev, f64 = torch.device("cuda"), torch.float64
    S = P.SolverSettings
    problems, fx = cone_problems()
    rng = np.random.default_rng(23)

    def k3():
        return read_counts()["fused_hsde_solve"]

    def tensors(p):
        return tuple(torch.as_tensor(p[k], dtype=f64, device=dev) for k in ("A", "b", "c"))

    def half_sq(x):
        return 0.5 * torch.sum(x * x)

    recs = []
    ok = True
    # socp_ball: the forward against the eager loop at the benchmarks' tol.
    soc = problems.socp_ball()
    cones = P.dims_to_cones(soc["dims"])
    A, b, c = tensors(soc)
    st = S(max_iter=CONE_MAX_ITER, **CONE_TOL)
    x, aux, (g_b,), times = layer_run(
        torch, lambda b_: diff_cone_solve(A, b_, c, cones, settings=st), (b,), half_sq)
    rec = {"case": "socp_ball", "shape": list(A.shape), "tol": CONE_TOL["abs_tol"], **times}
    ok_c = times["k3_launches"] == 1
    before = k3()
    x_e, aux_e = diff_cone_solve(A, b, c, cones, settings=st.replace(use_fused=False))
    rec["vs_eager"], ok_m = forward_match(x, aux, x_e, aux_e)
    ok_c = ok_c and ok_m and k3() == before
    # The gradient against differences at a tolerance where both agree.
    st_g = S(abs_tol=1e-7, rel_tol=1e-7, max_iter=200000)

    def soc_loss(b_):
        return half_sq(diff_cone_solve(A, b_, c, cones, settings=st_g)[0])

    _, aux_g, (g_b,), times_g = layer_run(
        torch, lambda b_: diff_cone_solve(A, b_, c, cones, settings=st_g), (b,), half_sq)
    V = torch.as_tensor(rng.standard_normal(b.shape), dtype=f64, device=dev)
    before = k3()
    fd = central_diff(soc_loss, b, V, 1e-4)
    g_V = float(g_b @ V)
    rec["gradient"] = {"tol": 1e-7, "status": int(aux_g["status"]),
                       "iterations": int(aux_g["iterations"]), "d_b_V": g_V, "d_b_V_fd": fd,
                       "fd_k3_launches": k3() - before, **times_g}
    ok_c = (ok_c and int(aux_g["status"]) == 0 and times_g["k3_launches"] == 1
            and rec["gradient"]["fd_k3_launches"] == 2
            and abs(g_V - fd) <= 1e-3 * abs(fd))
    rec["ok"] = bool(ok_c)
    recs.append(rec)
    ok = ok and ok_c

    # The exponential-cone fixture: optimum z* = e.
    p = fx.exp_primal_fixture()
    cones = P.dims_to_cones(p["dims"])
    A, b, c = tensors(p)
    st = S(max_iter=CONE_MAX_ITER, abs_tol=1e-8, rel_tol=1e-8)

    def exp_loss(b_):
        return half_sq(diff_cone_solve(A, b_, c, cones, settings=st)[0])

    x, aux, (g_b,), times = layer_run(
        torch, lambda b_: diff_cone_solve(A, b_, c, cones, settings=st), (b,), half_sq)
    V = torch.as_tensor(rng.standard_normal(b.shape), dtype=f64, device=dev)
    fd = central_diff(exp_loss, b, V, 1e-5)
    g_V = float(g_b @ V)
    rec = {"case": "exp_primal", "shape": list(A.shape), "status": int(aux["status"]),
           "iterations": int(aux["iterations"]), "optval": float(aux["optval"]),
           "optval_ref": p["optval"], "d_b_V": g_V, "d_b_V_fd": fd, **times}
    ok_c = (times["k3_launches"] == 1 and rec["status"] == 0
            and abs(rec["optval"] - p["optval"]) <= 1e-6 * p["optval"]
            and abs(g_V - fd) <= 1e-3 * max(abs(fd), 1e-6))
    rec["ok"] = bool(ok_c)
    recs.append(rec)
    ok = ok and ok_c

    # lp_ineq with the default polish: the eager loop, no K3 launch.  The
    # polished vertex is accurate to about 1e-9 and some rows are nearly
    # degenerate (slack and dual both near 2e-5), so central differences
    # scatter by about 5e-4 of their value with the step (1e-7 to 1e-4, a
    # CPU run of this phase): the gradient is held to them within 5e-3.
    lp = problems.lp_ineq()
    cones = P.dims_to_cones(lp["dims"])
    A, b, c = tensors(lp)
    w = torch.as_tensor(rng.standard_normal(A.shape[1]), dtype=f64, device=dev)

    def lp_loss(b_):
        return torch.dot(w, diff_cone_solve(A, b_, c, cones)[0])

    x, aux, (g_b,), times = layer_run(
        torch, lambda b_: diff_cone_solve(A, b_, c, cones), (b,), lambda x_: torch.dot(w, x_))
    V = torch.as_tensor(rng.standard_normal(b.shape), dtype=f64, device=dev)
    fd = central_diff(lp_loss, b, V, 1e-5)
    ref = float(linprog(lp["c"], A_ub=lp["A"], b_ub=lp["b"], bounds=(None, None),
                        method="highs").fun)
    rel = abs(float(aux["optval"]) - ref) / max(1.0, abs(ref))
    g_V = float(g_b @ V)
    rec = {"case": "lp_ineq_polish", "shape": list(A.shape), "status": int(aux["status"]),
           "iterations": int(aux["iterations"]), "optval_rel_err_highs": rel,
           "d_b_V": g_V, "d_b_V_fd": fd, **times}
    ok_c = (rec["status"] == 0 and times["k3_launches"] == 0 and times["k1_launches"] == 0
            and rel <= 1e-6 and abs(g_V - fd) <= 5e-3 * max(abs(fd), 1e-6))
    rec["ok"] = bool(ok_c)
    recs.append(rec)
    ok = ok and ok_c
    emit({"phase": "diff_cone", "dtype": "float64", "cases": recs, "ok": bool(ok)})
    if not ok:
        raise AssertionError("differentiable cone layer")
    return recs


# ---------------------------------------------------------------------------
# Slice 7: profiling, checkpoint / resume, the SCS-data plugin path and the
# native host runtime.
# ---------------------------------------------------------------------------

TRACE_DIR = os.path.join(ROOT, "chiprun_out", "traces")


def traced_window(torch, name, fn):
    """fn() inside a record_function window that ends in a synchronize,
    under the port's trace(); returns (fn's result, busy_time of the window,
    the trace's path)."""
    from pogs_tpu_torch.utils.profiling import busy_time, trace

    with trace(TRACE_DIR) as prof:
        with torch.profiler.record_function(name):
            out = fn()
            torch.cuda.synchronize()
    return out, busy_time(prof.trace_path, name), prof.trace_path


def phase_profiling(torch, P):
    """The port's profiler on the card: trace() around a warm one-shot
    solve_lasso at the bench size (500x300 f32) and around the bench
    diff_lasso's forward and backward (phase 22's problem, f64), each
    window's length, the union of its CUDA kernels' time and so the card's
    idle share; the one-shot trace must hold a K1 kernel event.  The init
    split, before any profiler session: equilibrate, norm2_est and the
    projector's init at 500x300 f32 one by one and the three in sequence,
    with device_time (CUDA events), then PhaseTimer's summary of five
    one-shot solves (setup: the FunctionVectors and the solver with A on the
    card; init; solve: scaling, K1 and unscaling up to the status read;
    result: the copies to the host).  After the traces, each part in a
    traced window and the split once more."""
    from pogs_tpu_torch import PhaseTimer, device_time
    from pogs_tpu_torch.api.diff import diff_lasso
    from pogs_tpu_torch.linalg.equil import equilibrate
    from pogs_tpu_torch.linalg.matrix import DenseMatrix
    from pogs_tpu_torch.linalg.norm import norm2_est
    from pogs_tpu_torch.projector.direct import DirectProjector
    from pogs_tpu_torch.utils.precision import highest_precision

    def k1():
        return read_counts()["fused_admm_loop"]

    A, b, lam = make_lasso(500, 300)
    dev, f64 = torch.device("cuda"), torch.float64
    A_op = DenseMatrix(torch.as_tensor(A, device=dev))
    proj = DirectProjector("inverse")

    def whole_init(op):
        eq = equilibrate(op)
        return norm2_est(eq.A), proj.init(eq.A, s=1.0)

    def init_split():
        """device_time of the three parts of GraphFormSolver.init one by
        one and of the three in sequence, as init runs them."""
        with highest_precision():
            eq = equilibrate(A_op)
            parts = {"equilibrate": (equilibrate, A_op), "norm2_est": (norm2_est, eq.A),
                     "projector_init": (lambda op: proj.init(op, s=1.0), eq.A),
                     "init_whole": (whole_init, A_op)}
            ms = {name: device_time(fn, arg, reps=20, warmup=3) * 1e3
                  for name, (fn, arg) in parts.items()}
        ms["parts_sum"] = ms["equilibrate"] + ms["norm2_est"] + ms["projector_init"]
        ms["parts_sum_over_whole"] = ms["parts_sum"] / ms["init_whole"]
        return parts, ms

    P.solve_lasso(A, b, lam, **BENCH_TOL)  # warm
    # The init split and PhaseTimer first, before any profiler session in
    # this process, so that nothing the profiler leaves behind is timed.
    parts, clean = init_split()
    rec = {"phase": "profiling", "init_split": {"before_profiler": clean}}

    # PhaseTimer over five one-shot solves, step by step.
    ok = True
    timer = PhaseTimer()
    st = P.SolverSettings(abs_tol=BENCH_TOL["abs_tol"], rel_tol=BENCH_TOL["rel_tol"])
    for _ in range(5):
        with timer.phase("setup"):
            f = P.FunctionVector(P.Function.SQUARE, 500, b=b, dtype=np.float32)
            gv = P.FunctionVector(P.Function.ABS, 300, c=lam, dtype=np.float32)
            solver = P.GraphFormSolver(A, settings=st)
            torch.cuda.synchronize()
        with timer.phase("init"):
            solver.init()
        with timer.phase("solve"):
            res = solver.solve(f, gv)
        with timer.phase("result"):
            res.as_dict()
        ok = ok and res.status == P.Status.SUCCESS

    before = k1()
    out, lasso, path = traced_window(torch, "lasso_one_shot",
                                     lambda: P.solve_lasso(A, b, lam, **BENCH_TOL))
    k1_names = [k for k in lasso["kernel_ms_by_name"] if "fused_admm_kernel" in k]
    rec.update({"trace_file": os.path.relpath(path, ROOT),
                "lasso_one_shot": {"shape": [500, 300], "dtype": "float32",
                                   "status": out["status"], "iterations": out["iterations"],
                                   "k1_launches": k1() - before, "k1_events": k1_names,
                                   "k1_ms": sum(lasso["kernel_ms_by_name"][k] for k in k1_names),
                                   **{k: v for k, v in lasso.items()
                                      if k != "kernel_ms_by_name"}}})
    ok = (ok and os.path.exists(path) and out["status"] == 0 and k1() - before == 1
          and len(k1_names) == 1)

    # The bench diff_lasso (f64, the layer's defaults): forward and backward.
    At = torch.as_tensor(A, dtype=f64, device=dev)
    bt = torch.as_tensor(b, dtype=f64, device=dev)
    leaves = [torch.tensor(lam, dtype=f64, device=dev).requires_grad_()]

    def forward():
        return diff_lasso(At, bt, leaves[0])

    x, _ = forward()  # warm: the shape's first backward is cold
    torch.autograd.grad(0.5 * torch.sum(x * x), leaves)
    (x, aux), fwd, _ = traced_window(torch, "diff_lasso_forward", forward)
    (g,), bwd, bwd_path = traced_window(
        torch, "diff_lasso_backward",
        lambda: torch.autograd.grad(0.5 * torch.sum(x * x), leaves))
    rec["diff_lasso"] = {"shape": [500, 300], "dtype": "float64",
                         "iterations": int(aux["iterations"]), "d_lambda": float(g),
                         "backward_trace_file": os.path.relpath(bwd_path, ROOT),
                         "forward": {k: v for k, v in fwd.items() if k != "kernel_ms_by_name"},
                         "backward": {k: v for k, v in bwd.items() if k != "kernel_ms_by_name"},
                         "backward_top_kernels": dict(sorted(
                             bwd["kernel_ms_by_name"].items(), key=lambda kv: -kv[1])[:5])}
    ok = ok and int(aux["status"]) == 0 and np.isfinite(float(g))

    # Each part of init in a traced window (its launches and kernel time),
    # then the split again, now that the profiler has run in this process.
    traced = {}
    with highest_precision():
        for name, (fn, arg) in parts.items():
            _, busy, _ = traced_window(torch, name, lambda: fn(arg))
            traced[name] = {"traced_ms": busy["window_ms"], "kernel_ms": busy["kernel_ms"],
                            "kernels": busy["kernels"], "idle_share": busy["idle_share"]}
    rec["init_split"]["traced"] = traced
    rec["init_split"]["after_profiler"] = init_split()[1]
    rec["phase_timer_summary"] = timer.summary().splitlines()
    rec["ok"] = bool(ok)
    emit(rec)
    if not ok:
        raise AssertionError("profiling phase")
    return rec


def phase_checkpoint(torch, P):
    """Checkpoint / resume on the card: the bench lasso (500x300 f32, bench
    tolerances) solved with K1, save_state, load_state into a fresh solver,
    solved again with K1: SUCCESS within max(3, first // 5) iterations (the
    contract of tests/test_utils.py), optval within 1e-5 relative, the state
    on the card in float32; a checkpoint of another matrix refused under
    strict=True."""
    import tempfile

    A, b, lam = make_lasso(500, 300)
    st = P.SolverSettings(abs_tol=BENCH_TOL["abs_tol"], rel_tol=BENCH_TOL["rel_tol"])
    f = P.FunctionVector(P.Function.SQUARE, 500, b=b, dtype=np.float32)
    g = P.FunctionVector(P.Function.ABS, 300, c=lam, dtype=np.float32)
    before = read_counts()["fused_admm_loop"]
    s1 = P.GraphFormSolver(A, settings=st)
    r1 = s1.solve(f, g)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench_lasso.npz")
        s1.save_state(path)
        s2 = P.GraphFormSolver(A, settings=st).load_state(path)
        on_card = s2._z.device.type == "cuda" and s2._z.dtype == torch.float32
        r2 = s2.solve(f, g)
        other = make_lasso(500, 300, seed=43)[0]
        try:
            P.GraphFormSolver(other, settings=st).load_state(path)
            refused = False
        except ValueError as exc:
            refused = "different matrix" in str(exc)
    launches = read_counts()["fused_admm_loop"] - before
    it1, it2 = int(r1.final_iter), int(r2.final_iter)
    rel = abs(float(r2.optval) - float(r1.optval)) / abs(float(r1.optval))
    rec = {"phase": "checkpoint", "shape": [500, 300], "dtype": "float32",
           "first": {"status": r1.status.name, "iterations": it1, "optval": float(r1.optval)},
           "resumed": {"status": r2.status.name, "iterations": it2, "optval": float(r2.optval)},
           "iteration_limit": max(3, it1 // 5), "optval_rel_err": rel,
           "state_on_card_f32": on_card, "other_matrix_refused": refused,
           "k1_launches": launches}
    rec["ok"] = bool(r1.status == r2.status == P.Status.SUCCESS and it2 <= max(3, it1 // 5)
                     and rel <= 1e-5 and on_card and refused and launches == 2)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("checkpoint / resume")
    return rec


def scs_schema_ok(res, m, n):
    """The SCS 3.x result-dict schema that cvxpy's SCS.invert() reads
    (tests/test_cvxpy_plugin_contract.py:40-49)."""
    info = res["info"]
    return (set(res) == {"x", "y", "s", "info"} and res["x"].shape == (n,)
            and res["y"].shape == (m,) and res["s"].shape == (m,)
            and all(k in info for k in ("status", "status_val", "iter", "pobj", "dobj",
                                        "solve_time", "setup_time"))
            and info["status_val"] in (1, 2, -1, -2, -4))


def phase_scs_data(torch, P):
    """The cvxpy plugin's solve path on the card: solve_via_scs_data on
    socp_ball 804x200 (benchmarks/problems.py) in SCS form, f64, one K3
    launch, held to the port's solve_cone_problem on the same data (the same
    status and iterations, x within 1e-12) and to the SCS result schema."""
    from pogs_tpu_torch.api.cvxpy_interface import solve_via_scs_data

    problems, _ = cone_problems()
    soc = problems.socp_ball()
    m, n = soc["A"].shape
    data = {"c": soc["c"], "A": soc["A"], "b": soc["b"], "dims": soc["dims"]}
    opts = dict(CONE_TOL, max_iter=CONE_MAX_ITER)
    before = read_counts()["fused_hsde_solve"]
    t0 = time.perf_counter()
    res = solve_via_scs_data(data, opts)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()["fused_hsde_solve"] - before
    direct = P.solve_cone_problem(soc["c"], soc["A"], soc["b"], soc["dims"], **opts)
    err = float(np.max(np.abs(res["x"] - direct["x"])))
    info = res["info"]
    rec = {"phase": "scs_data", "problem": "socp_ball", "shape": [m, n], "dtype": "float64",
           "status": info["status"], "status_val": info["status_val"], "iter": info["iter"],
           "pobj": info["pobj"], "direct_status": direct["status"],
           "direct_iterations": direct["iterations"], "x_max_abs_err": err,
           "schema_ok": scs_schema_ok(res, m, n), "k3_launches": launches,
           "wall_ms": wall_ms}
    rec["ok"] = bool(info["status_val"] == 1 and direct["status"] == 0
                     and info["iter"] == direct["iterations"] and err <= 1e-12
                     and rec["schema_ok"] and launches == 1)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("solve_via_scs_data")
    return rec


def phase_native(torch, P, native_build):
    """The native host runtime against the device path: the library's build
    time (the host C++ compiler, into build/pogs_tpu_torch/, in phase 2
    beside the kernels' nvcc), then
    solve_graph_form(..., backend="native") against the device one-shot
    (K1) on the bench lasso 500x300 and at 128x256 (32768 elements, the
    JAX package's native routing size): both SUCCESS with optval within
    1e-3 relative; each route's one-shot wall time (host clock, the result
    on the host) over 5 calls in turns after a warm call."""
    from pogs_tpu_torch import native

    native.load()
    rec = {"phase": "native", "build_seconds": native_build["seconds"],
           "library": os.path.relpath(str(native_build["library"]), ROOT),
           "flags": native.flags(),
           "version": native.version(), "cases": []}
    ok = True
    for m, n in ((500, 300), (128, 256)):
        A, b, lam = make_lasso(m, n)
        before = read_counts()["fused_admm_loop"]
        runs = {"device": lambda: P.solve_lasso(A, b, lam, **BENCH_TOL),
                "native": lambda: P.solve_lasso(A, b, lam, backend="native", **BENCH_TOL)}
        out = {route: fn() for route, fn in runs.items()}  # warm
        times = {route: [] for route in runs}
        for _ in range(5):
            for route, fn in runs.items():
                t0 = time.perf_counter()
                fn()
                times[route].append((time.perf_counter() - t0) * 1e3)
        rel = abs(out["native"]["optval"] - out["device"]["optval"]) / abs(out["device"]["optval"])
        case = {"shape": [m, n], "elements": m * n,
                "device": {"status": out["device"]["status"],
                           "iterations": out["device"]["iterations"],
                           "optval": out["device"]["optval"],
                           "kkt": lasso_kkt(A, b, lam, out["device"]["x"]),
                           "ms": times["device"], "ms_median": float(np.median(times["device"]))},
                "native": {"status": out["native"]["status"],
                           "algorithm": out["native"].get("algorithm"),
                           "iterations": out["native"]["iterations"],
                           "optval": out["native"]["optval"],
                           "kkt": lasso_kkt(A, b, lam, out["native"]["x"]),
                           "ms": times["native"], "ms_median": float(np.median(times["native"]))},
                "optval_rel_diff": rel, "k1_launches": read_counts()["fused_admm_loop"] - before}
        case["native_speedup"] = case["device"]["ms_median"] / case["native"]["ms_median"]
        case["ok"] = bool(out["device"]["status"] == out["native"]["status"] == 0
                          and out["native"]["backend"] == "native" and rel <= 1e-3
                          and case["k1_launches"] == 6)
        ok = ok and case["ok"]
        rec["cases"].append(case)
    rec["ok"] = bool(ok)
    emit(rec)
    if not ok:
        raise AssertionError("native runtime against the device path")
    return rec


# ---------------------------------------------------------------------------
# Slice 8: multi-device solves on torch.distributed.  Phase 28 runs two
# ranks on one GPU, cuda:0, under gloo (which stages its buffers through the
# host): these times measure the software path, not scaling.
# ---------------------------------------------------------------------------

MESH_RANKS = 2
MESH_DEVICE = "cuda:0"  # every rank's: the gloo ranks share one card
MESH_GROUP_TIMEOUT_S = 300
MESH_JOIN_TIMEOUT_S = 480
# DR iterations of sparse_bench's LP timed in phase 28 (d): each makes over
# a thousand collectives, so a solve to tolerance does not fit the phase.
SPARSE_TIMED_ITERS = 3
# Elements per all_reduce timed in each rank of phase 28, and the calls
# timed per size (after a warm-up of 10).
MESH_AR_SIZES = (1, 8, 300, 2500, 90_000)
MESH_AR_REPS = 100


def _all_reduce_us(torch, M, mesh):
    """Microseconds per all_reduce of the rows group, f64, the device
    synchronized after each call: the median of ``MESH_AR_REPS`` for each
    size of ``MESH_AR_SIZES``."""
    group = mesh.group("rows")
    out = {}
    for size in MESH_AR_SIZES:
        t = torch.zeros(size, dtype=torch.float64, device=mesh.device)
        for _ in range(10):
            M.all_reduce(t, group)
        torch.cuda.synchronize()
        times = []
        for _ in range(MESH_AR_REPS):
            t0 = time.perf_counter()
            M.all_reduce(t, group)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e6)
        out[size] = float(np.median(times))
    return out


def _rank_barrier(torch, M, mesh):
    """Every rank of the group waits here (an all_reduce: the only
    collectives used are all_reduce and broadcast)."""
    t = torch.zeros(1, device=mesh.device)
    M.all_reduce(t, None, "small")
    torch.cuda.synchronize()


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _solve_pair(torch, P, M, mesh, A, f, g, st, shard, rank, label):
    """The single-device eager solve (rank 0 alone, the other ranks waiting)
    and the sharded one (every rank) from the same numpy inputs: status,
    iterations, x, and each one's ms per iteration, timed on a second cold
    solve of the same solver (the first pays the process's warm-up; the
    second starts again from zeros and the settings' ρ)."""
    def cold(solver):
        solver.reset_warm_start()
        return solver.solve(f, g, rho=st.rho)

    ref = None
    if rank == 0:
        solver = P.GraphFormSolver(A, settings=st, device=mesh.device).init()
        cold(solver)
        ref, ref_ms = _timed(torch, lambda: cold(solver))
    _rank_barrier(torch, M, mesh)
    op = shard(A, mesh)
    sh_solver = P.GraphFormSolver(op, settings=st).init()
    cold(sh_solver)
    _rank_barrier(torch, M, mesh)
    M.reset_stats()
    sh, sh_ms = _timed(torch, lambda: cold(sh_solver))
    stats = dict(M.stats)
    it = int(sh.final_iter)
    rec = {"case": label, "shape": list(A.shape), "dtype": str(A.dtype), "plan": op.plan,
           "status": int(sh.status), "iterations": it, "ms_per_iter": sh_ms / (it + 1),
           "all_reduces_per_iter": {k: v / (it + 1) for k, v in stats.items()}}
    if ref is not None:
        rec.update(ref_status=int(ref.status), ref_iterations=int(ref.final_iter),
                   ref_ms_per_iter=ref_ms / (int(ref.final_iter) + 1),
                   x_max_abs_err=float((ref.x - sh.x).abs().max()))
    return rec


def _steady_collectives(torch, P, M, mesh, A, f, g, shard, exact=False):
    """All-reduces per steady-state ADMM iteration, by kind and bytes: two
    runs at tolerance 0 (20 and 40 iterations) differenced."""
    counts = []
    for iters in (20, 40):
        st = P.SolverSettings(abs_tol=0.0, rel_tol=0.0, max_iter=iters, use_fused=False,
                              use_exact_tol=exact)
        solver = P.GraphFormSolver(shard(A, mesh), settings=st).init()
        M.reset_stats()
        solver.solve(f, g)
        counts.append(dict(M.stats))
    return {k: (counts[1][k] - counts[0][k]) / 20 for k in counts[0]}


def _steady_dr_collectives(torch, P, M, mesh, A, b, c, cones):
    """All-reduces per DR iteration of a row-sharded SMW cone solve (its
    checks every 10th iteration included): 21 and 41 iterations
    differenced."""
    counts = []
    for iters in (21, 41):
        st = P.SolverSettings(abs_tol=0.0, rel_tol=0.0, max_iter=iters, polish=False)
        solver = P.ConeSolver(M.shard_matrix(A, mesh), Ky=cones, settings=st).init()
        M.reset_stats()
        solver.solve(b, c)
        counts.append(dict(M.stats))
    return {k: (counts[1][k] - counts[0][k]) / 20 for k in counts[0]}


def _mesh_graph(torch, P, M, mesh, rank):
    """(a) the row plan, (b) the column plan, (c) 5000x2500 row-sharded."""
    F = P.Function
    out = []
    A, b, lam = make_lasso(500, 300)
    f = P.FunctionVector(F.SQUARE, 500, b=b)
    g = P.FunctionVector(F.ABS, 300, c=lam)
    cases = [("row_f32", A, P.SolverSettings(use_fused=False, **BENCH_TOL), 5e-4),
             ("row_f64", A.astype(np.float64),
              P.SolverSettings(use_fused=False, abs_tol=1e-6, rel_tol=1e-6), 1e-8)]
    for label, A_c, st, lim in cases:
        rec = _solve_pair(torch, P, M, mesh, A_c, f, g, st, M.shard_matrix, rank, label)
        rec["x_limit"] = lim
        out.append(rec)
    A_w, b_w, lam_w = make_lasso(300, 500)
    if M.auto_shard(A_w, mesh).plan != "cols":
        raise AssertionError("auto_shard did not pick the column plan for a wide A")
    rec = _solve_pair(torch, P, M, mesh, A_w, P.FunctionVector(F.SQUARE, 300, b=b_w),
                      P.FunctionVector(F.ABS, 500, c=lam_w),
                      P.SolverSettings(use_fused=False, **BENCH_TOL), M.auto_shard, rank,
                      "col_f32")
    rec["x_limit"] = 5e-4
    out.append(rec)
    A_r, b_r, lam_r = make_lasso(5000, 2500)
    rec = _solve_pair(torch, P, M, mesh, A_r, P.FunctionVector(F.SQUARE, A_r.shape[0], b=b_r),
                      P.FunctionVector(F.ABS, A_r.shape[1], c=lam_r),
                      P.SolverSettings(use_fused=False, max_iter=100, **BENCH_TOL),
                      M.shard_matrix, rank, "real_size_5000x2500_f32")
    rec["x_limit"] = 5e-4
    out.append(rec)
    budget = {"row": _steady_collectives(torch, P, M, mesh, A, f, g, M.shard_matrix),
              "col": _steady_collectives(torch, P, M, mesh, A_w,
                                         P.FunctionVector(F.SQUARE, 300, b=b_w),
                                         P.FunctionVector(F.ABS, 500, c=lam_w),
                                         M.shard_matrix_cols),
              "row_exact": _steady_collectives(torch, P, M, mesh, A, f, g, M.shard_matrix,
                                               exact=True)}
    return out, budget


def _sparse_op_errors(torch, P, M, mesh, A):
    """The sharded operator of ``A`` (``shard_sparse``, f64) against the
    single-device ``SparseMatrix`` on the same seeded vectors: the largest
    error of mv, rmv, sq_mv and sq_rmv, each relative to max(1, ‖ref‖∞),
    and of frob2."""
    from pogs_tpu_torch.linalg.matrix import as_matrix_op
    from pogs_tpu_torch.parallel.sparse import shard_sparse

    op, m = shard_sparse(A, mesh, dtype=np.float64)
    ref = as_matrix_op(A, torch.float64, mesh.device)
    rng = np.random.default_rng(28)
    x = torch.as_tensor(rng.standard_normal(A.shape[1]), device=mesh.device)
    y = torch.zeros(op.shape[0], dtype=torch.float64, device=mesh.device)
    y[:m] = torch.as_tensor(rng.standard_normal(m), device=mesh.device)

    def err(got, want):
        return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))

    return {"mv": err(op.gather(op.mv(x))[:m], ref.mv(x)),
            "rmv": err(op.rmv(op.local(y)), ref.rmv(y[:m])),
            "sq_mv": err(op.gather(op.sq_mv(x))[:m], ref.sq_mv(x)),
            "sq_rmv": err(op.sq_rmv(op.local(y)), ref.sq_rmv(y[:m])),
            "frob2": abs(float(op.frob2()) - float(ref.frob2())) / float(ref.frob2())}


def _mesh_sparse(torch, P, M, mesh, rank):
    """(d) shard_sparse with pad_cone_rows, the cg strategy, f64, against the
    single-device kept-sparse solve (rank 0).  The SOCP and the LP of
    tests/test_sharding.py at their sizes are solved to tolerance and held
    (``"hold": "solve"``; the SOCP also to its closed form).  At
    sparse_bench's LP 1400x300 the sharded operator's products are held to
    the single-device ``SparseMatrix``'s, and ``SPARSE_TIMED_ITERS`` DR
    iterations are timed (``"hold": "timed"``): each makes over a thousand
    collectives of about a millisecond here, and a CG stopped at a loose
    tolerance follows the order of its sums, so that short trajectory is
    reported, not held."""
    import scipy.sparse as sp
    from pogs_tpu_torch.parallel.sparse import pad_cone_rows, shard_sparse

    Cn = P.Cone
    rng = np.random.default_rng(7)
    Araw = sp.random(9, 10, density=0.4, random_state=1, format="csr")
    A_lp = sp.vstack([Araw, sp.eye(10), -sp.eye(10)]).tocsr()
    b_lp = A_lp @ rng.normal(size=10) + rng.random(A_lp.shape[0]) + 0.1
    c_lp = rng.normal(size=10)
    rng = np.random.default_rng(9)
    x0, c_soc = rng.standard_normal(15), rng.standard_normal(15)
    A_soc = sp.vstack([sp.csr_matrix((1, 15)), -sp.eye(15)]).tocsr()
    b_soc = np.concatenate([[1.5], -x0])
    big = sparse_lp_problem()
    cases = [("socp_16x15", A_soc, b_soc, c_soc, [P.ConeConstraint(Cn.SOC, range(16))],
              P.SolverSettings(abs_tol=1e-4, rel_tol=1e-4), "solve",
              float(c_soc @ x0 - 1.5 * np.linalg.norm(c_soc))),
             ("lp_29x10", A_lp, b_lp, c_lp, [P.ConeConstraint(Cn.NON_NEG, range(29))],
              P.SolverSettings(abs_tol=1e-6, rel_tol=1e-6, max_iter=1500), "solve", None),
             ("lp_1400x300", big["A"], big["b"], big["c"], P.dims_to_cones(big["dims"]),
              P.SolverSettings(max_iter=SPARSE_TIMED_ITERS, **CONE_TOL), "timed", None)]
    out = []
    for label, A, b, c, cones, st, hold, expect in cases:
        ref = None
        if rank == 0:
            solver = P.ConeSolver(A, Ky=cones, settings=st, dtype=torch.float64,
                                  device=mesh.device, sparse_policy="keep").init()
            ref, ref_ms = _timed(torch, lambda: solver.solve(b, c))
        _rank_barrier(torch, M, mesh)
        op, _ = shard_sparse(A, mesh, dtype=np.float64)
        b_pad, cones_pad = pad_cone_rows(b, cones, op.shape[0])
        solver = P.ConeSolver(op, Ky=cones_pad, settings=st, dtype=torch.float64).init()
        _rank_barrier(torch, M, mesh)
        M.reset_stats()
        sh, sh_ms = _timed(torch, lambda: solver.solve(b_pad, c))
        it = int(sh.final_iter)
        rec = {"case": label, "shape": list(A.shape), "nnz": int(A.nnz),
               "strategy": solver.strategy, "status": int(sh.status), "iterations": it,
               "hold": hold, "ms_per_dr_iter": sh_ms / (it + 1),
               "optval": float(sh.optval), "x_finite": bool(torch.isfinite(sh.x).all()),
               "all_reduces_per_dr_iter": {k: v / (it + 1) for k, v in M.stats.items()}}
        if expect is not None:
            rec["closed_form"] = expect
        if hold == "timed":
            rec["op_errors"] = _sparse_op_errors(torch, P, M, mesh, A)
        if ref is not None:
            rec.update(ref_status=int(ref.status), ref_iterations=int(ref.final_iter),
                       ref_ms_per_dr_iter=ref_ms / (int(ref.final_iter) + 1),
                       ref_optval=float(ref.optval),
                       x_max_abs_err=float((ref.x - sh.x).abs().max()))
        out.append(rec)
    return out


def _mesh_batches(torch, P, M, rank, world):
    """(e) a (batch = world, rows = 1) mesh: the bench λ-sweep (one K2 launch
    per rank) and batched_cone_solve on socp_ball (its K3 launches per rank),
    the main path of this phase, with the launch counts reset around it; then
    every lane against the single-device run's (rank 0, uncounted)."""
    from pogs_tpu_torch.parallel import batched_cone_solve, solve_lasso_path

    mesh = M.make_mesh((world, 1), ("batch", "rows"), device=MESH_DEVICE)
    A, b, lam = make_lasso(500, 300)
    K = 128
    lams = (np.linspace(1.0, 0.5, K) * lam).astype(np.float32)
    st = P.SolverSettings(**SWEEP_TOL)
    problems, _ = cone_problems()
    soc = problems.socp_ball()
    cones = P.dims_to_cones(soc["dims"])
    K_c = 8
    rng = np.random.default_rng(8)
    bs = soc["b"][None, :] * (1.0 + 0.02 * rng.standard_normal((K_c, 1)))
    st_c = P.SolverSettings(max_iter=CONE_MAX_ITER, **CONE_TOL)

    _rank_barrier(torch, M, mesh)
    reset_counts()
    M.reset_stats()
    sweep, sweep_ms = _timed(torch, lambda: solve_lasso_path(A, b, lams, settings=st, mesh=mesh))
    cone, cone_ms = _timed(torch, lambda: batched_cone_solve(soc["A"], bs, soc["c"], cones,
                                                             settings=st_c, mesh=mesh))
    launches = read_counts()
    stats = dict(M.stats)
    rec = {"mesh": {"batch": world, "rows": 1}, "launches": launches,
           "launches_by_route": dict(_wrappers()["fused_batched_lasso_sweep"].launches_by_route),
           "sweep": {"K": K, "ms": sweep_ms, "lanes_per_rank": K // world,
                     "status_all_success": bool((sweep["status"] == 0).all())},
           "cone": {"K": K_c, "ms": cone_ms, "lanes_per_rank": K_c // world,
                    "status_all_success": bool((cone["status"] == 0).all())},
           "gather_all_reduces": stats}
    if rank == 0:
        from pogs_tpu_torch.ops.fused_admm_batch import fused_batched_lasso_sweep
        from pogs_tpu_torch.ops.fused_hsde import fused_hsde_solve

        saved = (fused_batched_lasso_sweep.launches, fused_hsde_solve.launches)
        ref = solve_lasso_path(A, b, lams, settings=st, device=MESH_DEVICE)
        ref_c = batched_cone_solve(soc["A"], bs, soc["c"], cones, settings=st_c,
                                   device=MESH_DEVICE)
        torch.cuda.synchronize()
        fused_batched_lasso_sweep.launches, fused_hsde_solve.launches = saved
        rec["sweep"].update(
            x_max_abs_err=float((ref["x"] - sweep["x"]).abs().max()),
            same_iterations=bool((ref["iterations"] == sweep["iterations"]).all()),
            same_status=bool((ref["status"] == sweep["status"]).all()),
            kkt_max=float(lasso_kkt_lanes(A, b, lams, sweep["x"].cpu().numpy()).max()))
        rec["cone"].update(
            x_max_abs_err=float((ref_c["x"] - cone["x"]).abs().max()),
            same_iterations=bool((ref_c["iterations"] == cone["iterations"]).all()),
            same_status=bool((ref_c["status"] == cone["status"]).all()))
    _rank_barrier(torch, M, mesh)
    return rec


# Iterations at which phase 28 (g) holds the 1000x10000 LP to the
# single-device loop (its solve to tolerance does not fit the phase).
LP_HOLD_ITERS = 200
LP_SHAPE = (1000, 10000)
QP_ASSETS = 1000
QP_ROUTES = (("socp_polish", "socp", True), ("socp", "socp", False), ("admm", "admm", True))


def _lp_eq_kx(m, n, seed=42):
    """benchmarks/problems.py's lp_eq (:87) in its K_x form: A0, b0 and c
    drawn as there, without the −I block (min c'x, A0 x = b0, x ≥ 0)."""
    rng = np.random.default_rng(seed)
    A0 = rng.standard_normal((m, n))
    x0 = rng.random(n) + 0.1
    return A0, A0 @ x0, rng.random(n) + 0.5


def _cone_cases(torch, P, M, mesh, rank, label, A, b, c, st, plans, P_q=None, **kw):
    """One problem through ``ConeSolver``: the single-device eager solve on
    rank 0 (the other ranks waiting), then the sharded one on every rank
    for each (plan, shard) of ``plans``; each record with the status,
    iterations, ms per iteration (one solve after init, host parts
    included) and all-reduces per iteration by kind and bytes."""
    def solver_for(A_in, **extra):
        solver = P.ConeSolver(A_in, settings=st, **kw, **extra)
        if P_q is None or kw.get("qp_via") == "admm":
            solver.init()
        return solver

    ref = None
    if rank == 0:
        solver = solver_for(A, device=mesh.device)
        ref, ref_ms = _timed(torch, lambda: solver.solve(b, c, P=P_q))
    _rank_barrier(torch, M, mesh)
    out = []
    for plan, shard in plans:
        op = shard(A, mesh)
        solver = solver_for(op)
        _rank_barrier(torch, M, mesh)
        M.reset_stats()
        sh, sh_ms = _timed(torch, lambda: solver.solve(b, c, P=P_q))
        stats = dict(M.stats)
        it = int(sh.final_iter)
        rec = {"case": label, "shape": list(A.shape), "plan": op.plan, "asked": plan,
               "status": int(sh.status), "iterations": it, "ms_per_iter": sh_ms / (it + 1),
               "optval": float(sh.optval), "x_finite": bool(torch.isfinite(sh.x).all()),
               "all_reduces_per_iter": {k: v / (it + 1) for k, v in stats.items()}}
        if ref is not None:
            rec.update(ref_status=int(ref.status), ref_iterations=int(ref.final_iter),
                       ref_ms_per_iter=ref_ms / (int(ref.final_iter) + 1),
                       ref_optval=float(ref.optval),
                       x_max_abs_err=float((ref.x - sh.x).abs().max()))
        out.append(rec)
    _rank_barrier(torch, M, mesh)
    return out


def _mesh_lp(torch, P, M, mesh, rank, full=False):
    """(g) lp_eq's LP in its K_x form at ``LP_SHAPE`` on the plan auto_shard
    picks (the column plan): ``LP_HOLD_ITERS`` iterations, or with ``full``
    to SUCCESS at 1e-4 / 1e-3 within 50,000."""
    Cn = P.Cone
    m, n = LP_SHAPE
    A0, b0, c0 = _lp_eq_kx(m, n)
    if M.auto_shard(A0, mesh).plan != "cols":
        raise AssertionError("auto_shard did not pick the column plan for lp_eq")
    st_lp = P.SolverSettings(use_fused=False, abs_tol=1e-4, rel_tol=1e-3,
                             max_iter=50000 if full else LP_HOLD_ITERS)
    out = _cone_cases(torch, P, M, mesh, rank, f"lp_eq_kx_{m}x{n}", A0, b0, c0, st_lp,
                      [("auto", M.auto_shard)], Kx=[P.ConeConstraint(Cn.NON_NEG, range(n))],
                      Ky=[P.ConeConstraint(Cn.ZERO, range(m))])
    out[-1]["hold"] = "solve" if full else "trajectory"
    return out


def _mesh_cone(torch, P, M, mesh, rank):
    """(g) the column plan of both cone paths, (h) the portfolio QP on both
    plans through each route; every record x_limit 1e-8 (f64)."""
    problems, _ = cone_problems()
    soc = problems.socp_ball()
    st = P.SolverSettings(use_fused=False, max_iter=CONE_MAX_ITER, **CONE_TOL)
    out = _cone_cases(torch, P, M, mesh, rank, "socp_ball_804x200", soc["A"], soc["b"],
                      soc["c"], st, [("cols", M.shard_matrix_cols)],
                      Ky=P.dims_to_cones(soc["dims"]))
    out += _mesh_lp(torch, P, M, mesh, rank)
    q = problems.portfolio(n_assets=QP_ASSETS, n_factors=30)
    Ky = P.dims_to_cones(q["dims"])
    for route, via, polish in QP_ROUTES:
        st_q = P.SolverSettings(use_fused=False, abs_tol=1e-7, rel_tol=1e-7, max_iter=20000,
                                polish=polish)
        out += _cone_cases(torch, P, M, mesh, rank, f"portfolio_{QP_ASSETS}_{route}", q["A"], q["b"],
                           q["c"], st_q, [("rows", M.shard_matrix), ("cols", M.shard_matrix_cols)],
                           P_q=q["P"], Ky=Ky, qp_via=via)
    return out


def _mesh_checkpoint(torch, P, M, mesh, rank, tmp):
    """(i) a row-sharded f64 lasso cut at 40 iterations, saved (rank 0
    writes) and resumed on one device, against the sharded solver's own
    continuation; then the reverse: a single-device cut (rank 0's file)
    resumed on the mesh, against the single-device continuation."""
    F = P.Function
    A, b, lam = make_lasso(500, 300)
    A = A.astype(np.float64)
    f = P.FunctionVector(F.SQUARE, 500, b=b)
    g = P.FunctionVector(F.ABS, 300, c=lam)
    full = P.SolverSettings(use_fused=False, abs_tol=1e-6, rel_tol=1e-6)
    cut = full.replace(max_iter=40)
    out = {}
    path = os.path.join(tmp, "mesh_ckpt.npz")
    sh = P.GraphFormSolver(M.shard_matrix(A, mesh), settings=cut)
    sh.solve(f, g)
    sh.save_state(path)
    one = P.GraphFormSolver(A, settings=full, device=mesh.device).load_state(path)
    resumed = one.solve(f, g)
    cont = sh.solve(f, g, settings=full)
    out["to_one"] = (resumed, cont)
    path1 = os.path.join(tmp, "one_ckpt.npz")
    one = P.GraphFormSolver(A, settings=cut, device=mesh.device)
    one.solve(f, g)
    if rank == 0:
        one.save_state(path1)
    _rank_barrier(torch, M, mesh)
    sh = P.GraphFormSolver(M.shard_matrix(A, mesh), settings=full).load_state(path1)
    out["to_mesh"] = (sh.solve(f, g), one.solve(f, g, settings=full))
    _rank_barrier(torch, M, mesh)
    return {k: {"status": [int(r.status) for r in v], "iterations": [int(r.final_iter) for r in v],
                "x_max_abs_err": float((v[0].x - v[1].x).abs().max())} for k, v in out.items()}


def _mesh_rank(rank, world, store_path, out_path, backend, lp_full=False):
    """One spawned rank of phase 28: joins the group (a FileStore, a group
    timeout) and runs the phase's parts; an exception ends the process with
    a non-zero code and its traceback."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    import pogs_tpu_torch as P
    from pogs_tpu_torch.parallel import mesh as M

    torch.cuda.set_device(torch.device(MESH_DEVICE))
    t0 = time.perf_counter()
    M.init_distributed(store=dist.FileStore(store_path, world), world_size=world, rank=rank,
                       backend=backend,
                       timeout=datetime.timedelta(seconds=MESH_GROUP_TIMEOUT_S))
    mesh = M.make_mesh((world,), ("rows",), device=MESH_DEVICE)
    out = {"rank": rank, "backend": dist.get_backend(), "init_s": time.perf_counter() - t0,
           "all_reduce_us": _all_reduce_us(torch, M, mesh)}

    def done(part):
        if rank == 0:
            print(f"mesh rank 0: {part} done at {time.perf_counter() - t0:.1f} s", flush=True)

    if lp_full:
        out["cone"] = _mesh_lp(torch, P, M, mesh, rank, full=True)
    elif backend == "nccl":
        A, b, lam = make_lasso(500, 300)
        out["graph"] = [dict(_solve_pair(
            torch, P, M, mesh, A, P.FunctionVector(P.Function.SQUARE, 500, b=b),
            P.FunctionVector(P.Function.ABS, 300, c=lam),
            P.SolverSettings(use_fused=False, **BENCH_TOL), M.shard_matrix, rank, "row_f32"),
            x_limit=5e-4)]
    else:
        out["graph"], out["budget"] = _mesh_graph(torch, P, M, mesh, rank)
        done("(a) to (c)")
        problems, _ = cone_problems()
        soc = problems.socp_ball()
        out["budget"]["dr"] = _steady_dr_collectives(torch, P, M, mesh, soc["A"], soc["b"],
                                                     soc["c"], P.dims_to_cones(soc["dims"]))
        out["batches"] = _mesh_batches(torch, P, M, rank, world)
        done("(e)")
        out["cone"] = _mesh_cone(torch, P, M, mesh, rank)
        done("(g), (h)")
        out["checkpoint"] = _mesh_checkpoint(torch, P, M, mesh, rank,
                                             os.path.dirname(store_path))
        done("(i)")
        out["sparse"] = _mesh_sparse(torch, P, M, mesh, rank)
        done("(d)")
    out["jax_loaded"] = "jax" in sys.modules or "pogs_tpu" in sys.modules
    with open(f"{out_path}.{rank}", "wb") as fh:
        pickle.dump(out, fh)
    dist.destroy_process_group()


def _spawn_ranks(world, backend, lp_full=False):
    """Spawn ``world`` ranks of :func:`_mesh_rank`; every rank's results,
    and the time from the spawn to the last rank's group init."""
    import multiprocessing as mp
    import pickle
    import tempfile

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store, out = os.path.join(tmp, "store"), os.path.join(tmp, "out")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_mesh_rank, args=(r, world, store, out, backend, lp_full))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + MESH_JOIN_TIMEOUT_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        wall = time.perf_counter() - t0
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        codes = [p.exitcode for p in procs]
        if hung or any(codes):
            raise AssertionError(f"phase 28 ({backend}): rank exit codes {codes}, "
                                 f"{len(hung)} killed at the join timeout")
        results = []
        for r in range(world):
            with open(f"{out}.{r}", "rb") as fh:
                results.append(pickle.load(fh))
    return results, wall


def _print_cone(cn):
    c = cn["all_reduces_per_iter"]
    print(f"mesh cone {cn['case']} {cn['plan']}: {cn['iterations']} iterations "
          f"(status {cn['status']}), sharded {cn['ms_per_iter']:.4f} ms/iter, single-device "
          f"eager {cn['ref_ms_per_iter']:.4f} ms/iter, x err {cn['x_max_abs_err']:.3g}, "
          f"optval {cn['optval']:.12g}; all-reduces per iteration {c['vector']:.3f} vector "
          f"({c['vector_bytes']:.1f} B), {c['small']:.3f} small ({c['small_bytes']:.1f} B), "
          f"{c['broadcast']:.3f} broadcast", flush=True)


def _cone_ok(cn) -> bool:
    """A record of (g) or (h) against the single-device eager solve."""
    return (cn["x_finite"] and cn["status"] == cn["ref_status"]
            and cn["iterations"] == cn["ref_iterations"] and cn["x_max_abs_err"] <= 1e-8
            and (cn.get("hold") == "trajectory" or cn["status"] == 0))


def phase_mesh_lp_full(torch, P):
    """``--mesh-only --mesh-lp-full``: phase 28 (g)'s LP alone, solved to
    tolerance by two gloo ranks and by rank 0 on one device."""
    results, wall = _spawn_ranks(MESH_RANKS, "gloo", lp_full=True)
    cn = results[0]["cone"][0]
    emit({"phase": "mesh_lp_full", "ranks": MESH_RANKS, "spawn_to_done_s": wall, **cn})
    _print_cone(cn)
    if not _cone_ok(cn):
        raise AssertionError(f"phase 28 (g) LP to tolerance: {cn}")


def phase_mesh(torch, P):
    """Phase 28: two gloo ranks on cuda:0 ((a) to (e), (g) to (i)), then an
    NCCL group of one rank ((f)); returns the K2 and K3 launches the ranks
    made on the phase's main path (e)."""
    results, wall = _spawn_ranks(MESH_RANKS, "gloo")
    nccl, nccl_wall = _spawn_ranks(1, "nccl")
    r0 = results[0]
    rec = {"phase": "mesh", "ranks": MESH_RANKS, "backend": r0["backend"],
           "spawn_to_done_s": wall, "group_init_s": [r["init_s"] for r in results],
           "all_reduce_us": r0["all_reduce_us"],
           "graph": r0["graph"], "all_reduces_per_iter": r0["budget"],
           "sparse": r0["sparse"], "batches": [r["batches"] for r in results],
           "cone": r0["cone"], "checkpoint": r0["checkpoint"],
           "nccl": {"backend": nccl[0]["backend"], "spawn_to_done_s": nccl_wall,
                    "all_reduce_us": nccl[0]["all_reduce_us"], "graph": nccl[0]["graph"]}}
    fails = []
    if any(r["jax_loaded"] for r in results + nccl):
        fails.append("a rank imported jax or pogs_tpu")
    for g in r0["graph"] + nccl[0]["graph"]:
        if not (g["status"] == g["ref_status"] and g["iterations"] == g["ref_iterations"]
                and g["x_max_abs_err"] <= g["x_limit"]):
            fails.append(f"graph {g['case']}")
    for kind in ("row", "col", "row_exact"):
        c = r0["budget"][kind]
        if c["vector"] > 2 or c["small"] > 1:
            fails.append(f"budget {kind}: {c}")
    for s in r0["sparse"]:
        if s["hold"] == "solve":
            # As tests/test_torch_sharding_sparse.py holds them on the CPU.
            ok = (s["status"] == s["ref_status"] == 0 and s["iterations"] == s["ref_iterations"]
                  and s["x_max_abs_err"] <= 1e-8
                  and abs(s["optval"] - s["ref_optval"]) <= 1e-10 * max(1.0, abs(s["ref_optval"])))
            if "closed_form" in s:
                ok = ok and abs(s["optval"] - s["closed_form"]) <= 1e-3 * max(1.0, abs(s["closed_form"]))
        else:
            ok = s["x_finite"] and all(e <= 1e-12 for e in s["op_errors"].values())
        if not ok:
            fails.append(f"sparse {s['case']}")
    qp_ref = {c["case"]: c["ref_optval"] for c in r0["cone"]}[f"portfolio_{QP_ASSETS}_socp_polish"]
    for cn in r0["cone"]:
        ok = _cone_ok(cn)
        if cn["case"].startswith("portfolio"):
            ok = ok and abs(cn["optval"] - qp_ref) <= 1e-6 * abs(qp_ref)
        if not ok:
            fails.append(f"cone {cn['case']} {cn['plan']}")
    for k, ck in r0["checkpoint"].items():
        if not (ck["status"] == [0, 0] and ck["iterations"][0] == ck["iterations"][1]
                and ck["x_max_abs_err"] <= 1e-8):
            fails.append(f"checkpoint {k}: {ck}")
    k2 = k3 = 0
    for r in results:
        b = r["batches"]
        k2 += b["launches"]["fused_batched_lasso_sweep"]
        k3 += b["launches"]["fused_hsde_solve"]
        if (b["launches"]["fused_batched_lasso_sweep"] != 1
                or b["launches"]["fused_hsde_solve"] != 8 // MESH_RANKS
                or b["launches"]["fused_admm_loop"] != 0
                or not b["sweep"]["status_all_success"] or not b["cone"]["status_all_success"]):
            fails.append(f"batches rank {r['rank']}: {b['launches']}")
    b0 = r0["batches"]
    if not (b0["sweep"]["same_status"] and b0["sweep"]["same_iterations"]
            and b0["sweep"]["x_max_abs_err"] == 0.0 and b0["sweep"]["kkt_max"] < 1e-2):
        fails.append(f"sweep lanes {b0['sweep']}")
    if not (b0["cone"]["same_status"] and b0["cone"]["same_iterations"]
            and b0["cone"]["x_max_abs_err"] == 0.0):
        fails.append(f"cone lanes {b0['cone']}")
    rec["ok"] = not fails
    rec["fails"] = fails
    emit(rec)
    for g in r0["graph"]:
        print(f"mesh {g['case']} {g['plan']}: sharded {g['ms_per_iter']:.4f} ms/iter, "
              f"single-device eager {g['ref_ms_per_iter']:.4f} ms/iter", flush=True)
    for kind, c in r0["budget"].items():
        print(f"mesh all-reduces per {'DR' if kind == 'dr' else 'ADMM'} iteration ({kind}): "
              f"{c['vector']:g} vector ({c['vector_bytes']:g} B), "
              f"{c['small']:g} small ({c['small_bytes']:g} B)", flush=True)
    for cn in r0["cone"]:
        _print_cone(cn)
    for k, ck in r0["checkpoint"].items():
        print(f"mesh checkpoint {k}: resumed / uninterrupted status {ck['status']}, iterations "
              f"{ck['iterations']}, x err {ck['x_max_abs_err']:.3g}", flush=True)
    for name, us in ((f"gloo, {MESH_RANKS} ranks on {MESH_DEVICE}", r0["all_reduce_us"]),
                     ("nccl, 1 rank", nccl[0]["all_reduce_us"])):
        print(f"mesh all_reduce ({name}), median us by elements: "
              + ", ".join(f"{n}: {t:.1f}" for n, t in us.items()), flush=True)
    for sp_ in r0["sparse"]:
        print(f"mesh sparse {sp_['case']} ({sp_['hold']}): {sp_['iterations']} DR iterations, "
              f"sharded {sp_['ms_per_dr_iter']:.2f} ms/iter, single-device "
              f"{sp_['ref_ms_per_dr_iter']:.2f} ms/iter, x err {sp_['x_max_abs_err']:.3g}"
              + (f", operator errors {sp_['op_errors']}" if "op_errors" in sp_ else ""),
              flush=True)
    print(f"mesh spawn: {MESH_RANKS} gloo ranks {wall:.1f} s to done, group init "
          f"{max(rec['group_init_s']):.1f} s; nccl 1 rank {nccl_wall:.1f} s", flush=True)
    if fails:
        raise AssertionError(f"phase 28: {fails}")
    return {"fused_batched_lasso_sweep": k2, "fused_hsde_solve": k3}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import pogs_tpu_torch as P

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    smi = phase_device(torch)
    native_build = phase_build()
    if "--mesh-only" in sys.argv[1:]:
        # Phase 28 alone (after the build), for work on the sharded path.
        if "--mesh-lp-full" in sys.argv[1:]:
            phase_mesh_lp_full(torch, P)
        else:
            phase_mesh(torch, P)
        print(smi, flush=True)
        return 0
    if "--batch-only" in sys.argv[1:]:
        # Phases 7 and 8 alone (after the build), for work on K2.
        phase_kernel_vs_plain_batch(torch, P)
        phase_batched_path(torch, P)
        print(smi, flush=True)
        return 0
    summary = phase_kernel_vs_plain(torch, P)
    launches = phase_main_path(torch, P)
    phase_real_size(torch, P)
    phase_warm_path(torch, P)
    summary_b = phase_kernel_vs_plain_batch(torch, P)
    batched = phase_batched_path(torch, P)
    phase_warm_lasso_path(torch, P)
    summary_h = phase_kernel_vs_plain_hsde(torch, P)
    launches_h = phase_cone_main_path(torch, P)
    phase_cone_real_size(torch, P)
    phase_cone_warm_start(torch, P)
    # Slice 3's path: the densified routes launch K1 and K3.
    reset_counts()
    phase_sparse_lasso(torch, P)
    phase_sparse_real_size(torch, P)
    phase_sparse_cone(torch, P)
    sparse_launches = read_counts()
    emit({"phase": "sparse_path_launches", **sparse_launches})
    if not sparse_launches["fused_admm_loop"] or not sparse_launches["fused_hsde_solve"]:
        raise AssertionError(f"the sparse path launched {sparse_launches}")
    # Slice 5's path: the QP and LP front ends and the cone batches launch K3.
    reset_counts()
    phase_qp_main_path(torch, P)
    phase_qp_admm(torch, P)
    phase_batched_cone(torch, P)
    phase_batched_qp(torch, P)
    phase_qps(torch, P)
    qp_launches = read_counts()
    emit({"phase": "qp_path_launches", **qp_launches})
    if not qp_launches["fused_hsde_solve"]:
        raise AssertionError(f"the QP path launched {qp_launches}")
    # Slice 6's path: the differentiable layers' forwards launch K1 and K3.
    reset_counts()
    phase_diff_graph(torch, P)
    phase_diff_cone(torch, P)
    diff_launches = read_counts()
    emit({"phase": "diff_path_launches", **diff_launches})
    if not diff_launches["fused_admm_loop"] or not diff_launches["fused_hsde_solve"]:
        raise AssertionError(f"the differentiable layers launched {diff_launches}")
    # Slice 7's path: the checkpoint resume, the native comparison and
    # profiling launch K1, the SCS-data solve K3.  Profiling runs last: a
    # profiler session slows the eager launches that follow it in the same
    # process (PERF.md), and phase 27 times one-shots.
    reset_counts()
    phase_checkpoint(torch, P)
    phase_scs_data(torch, P)
    phase_native(torch, P, native_build)
    phase_profiling(torch, P)
    slice7_launches = read_counts()
    emit({"phase": "slice7_path_launches", **slice7_launches})
    if not slice7_launches["fused_admm_loop"] or not slice7_launches["fused_hsde_solve"]:
        raise AssertionError(f"slice 7's path launched {slice7_launches}")
    # Slice 8's path: the ranks' shares of the batches over a mesh launch K2
    # and K3 (counted in the ranks; a sharded single solve launches nothing).
    mesh_launches = phase_mesh(torch, P)
    emit({"phase": "mesh_path_launches", **mesh_launches})
    if "jax" in sys.modules or "pogs_tpu" in sys.modules:
        raise AssertionError("the port imported jax or pogs_tpu")
    # No single PyTorch call computes an ADMM or HSDE solve: library_ms null.
    # K2's two kernels: the streaming one as the 5000x2500 sweep runs it, the
    # resident cluster kernel as the bench sweep runs it.
    real_b = batched["real_size"]
    emit({"kernels": [{
        "name": "fused_admm_loop", "route": "cuda",
        "source": "pogs_tpu_torch/csrc/fused_admm.cu",
        "replaces": "pogs_tpu/ops/fused_admm.py:440",
        "launches": (launches + diff_launches["fused_admm_loop"]
                     + slice7_launches["fused_admm_loop"]),
        "max_abs_err": max(summary["max_abs_err"].values()),
        "ms": summary["ms"], "plain_ms": summary["plain_ms"],
        "bound_ms": summary["bound_ms"], "bound_by": summary["bound_by"],
        "library_ms": None,
    }, {
        "name": "fused_batched_lasso_sweep", "route": "cuda",
        "source": "pogs_tpu_torch/csrc/fused_admm_sweep.cu",
        "replaces": "pogs_tpu/ops/fused_admm_batch.py:415",
        "launches": batched["launches_real_size"]["stream"],
        "max_abs_err": real_b["vs_plain"]["max_abs_err"],
        "ms": real_b["k2_ms"], "plain_ms": real_b["plain_ms"],
        "bound_ms": real_b["bound_ms"], "bound_by": real_b["bound_by"],
        "library_ms": None,
    }, {
        "name": "fused_batched_lasso_sweep_resident", "route": "cuda",
        "source": "pogs_tpu_torch/csrc/fused_admm_batch.cu",
        "replaces": "pogs_tpu/ops/fused_admm_batch.py:415",
        "launches": (batched["launches_bench"]["resident"]
                     + mesh_launches["fused_batched_lasso_sweep"]),
        "max_abs_err": summary_b["resident"]["max_abs_err"],
        "ms": summary_b["resident"]["ms"], "plain_ms": summary_b["plain_ms"],
        "bound_ms": summary_b["bound_ms"], "bound_by": summary_b["bound_by"],
        "library_ms": None,
    }, {
        "name": "fused_hsde_solve", "route": "cuda",
        "source": "pogs_tpu_torch/csrc/fused_hsde.cu",
        "replaces": "pogs_tpu/ops/fused_hsde.py:555",
        "launches": (launches_h + qp_launches["fused_hsde_solve"]
                     + diff_launches["fused_hsde_solve"]
                     + slice7_launches["fused_hsde_solve"]
                     + mesh_launches["fused_hsde_solve"]),
        "max_abs_err": summary_h["max_abs_err"],
        "ms": summary_h["ms"], "plain_ms": summary_h["plain_ms"],
        "bound_ms": summary_h["bound_ms"], "bound_by": summary_h["bound_by"],
        "library_ms": None,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
