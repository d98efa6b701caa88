#!/usr/bin/env python3
"""Drive the PyTorch port (pogs_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line of its own:
  1. device: the card's name and power limit (as nvidia-smi reports them),
     the torch and CUDA versions;
  2. build: nvcc builds the solve kernel from pogs_tpu_torch/csrc/;
  3. the kernel against its plain version (the eager loop) on the card, on
     the same scaled inputs from the port's init: tall bench lasso 500x300,
     wide 300x500, logistic 200x100, nonneg LS with gap_stop, max_iter=5,
     and the bench lasso in float64;
  4. the main path: pogs_tpu_torch.solve_lasso on the bench problem (f32,
     cuda), which must succeed, pass the lasso KKT check, and launch the
     kernel exactly once per solve;
  5. a real size: lasso 5000x2500 f32 through GraphFormSolver, timed per
     solve with CUDA events, for the kernel and for the eager loop;
  6. a warm λ-path of 3 solves on one solver, kernel against eager loop.
Then the kernels' summary line, and last {"ok": true, "device": {...}}.

Any failure raises and exits non-zero before the last line.  Exits 1 when
no CUDA device is present.  The bench problem generator is that of
bench.py (seed 42; A ~ N(0,1); 90%-sparse x_true; λ = 0.1‖Aᵀb‖∞).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH_TOL = dict(abs_tol=1e-4, rel_tol=1e-3, gap_stop=False)


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


def lasso_kkt(A, b, lam, x):
    """Max lasso KKT violation relative to λ (bench.py's check)."""
    x = np.asarray(x, np.float64)
    A64, b64 = A.astype(np.float64), b.astype(np.float64)
    grad = A64.T @ (A64 @ x - b64)
    return float(np.max(np.where(
        np.abs(x) > 1e-5, np.abs(grad + lam * np.sign(x)),
        np.maximum(np.abs(grad) - lam, 0.0))) / lam)


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


def phase_build():
    from pogs_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load("fused_admm")
    secs = time.perf_counter() - t0
    log = _build.BUILD_LOGS.get("fused_admm", "")
    usage = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": secs, "library": str(_build.library_path("fused_admm")),
          "ptxas": usage})


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
        errs = {}
        ok = s_k == s_p and abs(it_k - it_p) <= 2
        ok = ok and abs(ov_k - ov_p) <= 1e-4 * max(abs(ov_p), 1e-12)
        for key in ("x12", "z"):
            ref = out_p[key]
            err = float(torch.max(torch.abs(out_k[key] - ref)))
            lim = 5e-5 * max(1.0, float(torch.max(torch.abs(ref))))
            errs[key] = err
            ok = ok and err <= lim
        ms = cuda_ms(torch, lambda: fused_admm_loop(*args, At=state["At"]), 10)
        plain_ms = cuda_ms(torch, lambda: fused_admm_loop_ref(*args), 3)
        rec = {"phase": "kernel_vs_plain", "case": name, "shape": [m, n],
               "dtype": str(dt).replace("torch.", ""), "status": [s_k, s_p],
               "iters": [it_k, it_p], "optval": [ov_k, ov_p],
               "max_abs_err": errs, "ms": ms, "plain_ms": plain_ms,
               "ms_per_iter": ms / max(it_k + 1, 1),
               "plain_ms_per_iter": plain_ms / max(it_p + 1, 1), "ok": ok}
        emit(rec)
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version: {name}")
        if name == "lasso_500x300_f32":
            summary = rec
    return summary


def phase_main_path(torch, P):
    from pogs_tpu_torch.ops.fused_admm import fused_admm_loop

    A, b, lam = make_lasso(500, 300)
    fused_admm_loop.launches = 0
    results, wall_ms = [], []
    for i in range(5):
        t0 = time.perf_counter()
        r = P.solve_lasso(A, b, lam, **BENCH_TOL)
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        if fused_admm_loop.launches != i + 1:
            raise AssertionError(
                f"solve {i + 1}: kernel launches {fused_admm_loop.launches}, expected {i + 1}")
        results.append(r)
    launches = fused_admm_loop.launches
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
    phase_build()
    summary = phase_kernel_vs_plain(torch, P)
    launches = phase_main_path(torch, P)
    phase_real_size(torch, P)
    phase_warm_path(torch, P)
    if "jax" in sys.modules or "pogs_tpu" in sys.modules:
        raise AssertionError("the port imported jax or pogs_tpu")
    emit({"kernels": [{
        "name": "fused_admm_loop", "route": "cuda",
        "source": "pogs_tpu_torch/csrc/fused_admm.cu",
        "replaces": "pogs_tpu/ops/fused_admm.py:440",
        "launches": launches,
        "max_abs_err": max(summary["max_abs_err"].values()),
        "ms": summary["ms"], "plain_ms": summary["plain_ms"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
