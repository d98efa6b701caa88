#!/usr/bin/env python3
"""Where an iteration of the graph-form solve kernel (K1) goes, on the card.

    python3 tools/k1_split.py [--root TREE] [--label NAME] [--cases a,b,...]
                              [--no-barriers] [--out FILE]

Builds a timed copy of ``TREE/pogs_tpu_torch/csrc/fused_admm.cu`` (default:
this checkout) in which thread 0 of block 0 reads ``%globaltimer`` before and
after every grid barrier and after every cross-block reduction of the kernel
body (``tools/k3_split.py``'s instrumenter), and launches it through TREE's
own wrapper (``ops/fused_admm.py``), so an older tree's kernel is timed with
its own interface.  Per case it prints one JSON line: the solve's time and
iterations, and each site's microseconds per iteration:

  * ``work``: block 0's work since the previous reading (its prox, products
    and elementwise loops), up to the barrier that follows;
  * ``barrier``: from block 0's arrival at a barrier to its release, i.e. the
    wait for the slowest block plus the barrier itself;
  * ``reduce``: the fixed-order reduction of partial sums after a barrier.

With --fine a "work" stamp also follows the start of an iteration, the end
of the prox loop, its partial sums and every product, and the stamps add
up in thread 0's local memory (a global read-modify-write per stamp would
wait for L2 in every phase); on the one-pass route also after the pass and
after the sum of the blocks' candidate products.  The cases are lasso
120x80, the bench lasso 500x300, the wide lasso 300x500, logistic
2000x1000, lasso 5000x2500 (on the plain products, just below the one
pass's boundary) and the benchmark's lasso 10000x5000 (the only case on the
one pass), all float32 at the bench tolerances (abs 1e-4, rel 1e-3)
from the port's own init.  Each case also gives ``a_passes``, the passes
over A or Aᵀ its solve made (where the tree's kernel counts them), per
iteration too, and its plan.  Then, unless
--no-barriers, the bare barrier loop of tools/barrier_loop.cu at grids of
1, 8, 33, 66 and 132 blocks.  Everything is also written to ``--out``
(default ``build/k1_split_<label>.json``).  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from pathlib import Path

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import k3_split  # noqa: E402

CASES = ("lasso_120x80", "lasso_500x300", "lasso_wide_300x500", "logistic_2000x1000",
         "lasso_5000x2500", "lasso_10000x5000")
# --fine: a stamp also after these statements of the loop (the start of an
# iteration, the end of the prox loop, its partial sums, every product, the
# one pass and the sum of its candidate products), accumulated in local
# memory.
FINE_MARKS = (r"const bool update = k > 0;", r"^\s*T g\[6\];", r"^\s*partial\(g, ",
              r"^\s*\}\);\s*$", r"^\s*if \(kPass\) one_pass\(v\);",
              r"^\s*if \(commit\) commit_rhs\(cand\);", r"^\s*\+\+k;")
TOL = dict(abs_tol=1e-4, rel_tol=1e-3, gap_stop=False)


def problem(P, name):
    """(A, f, g) of a named case, made from a seed."""
    kind, shape = name.rsplit("_", 1)
    kind = kind.replace("_wide", "")
    m, n = (int(v) for v in shape.split("x"))
    F, FV = P.Function, P.FunctionVector
    if kind == "logistic":
        rng = np.random.default_rng(11)
        A = rng.standard_normal((m, n)).astype(np.float32)
        labels = np.sign(rng.standard_normal(m))
        return A, FV(F.LOGISTIC, m, a=-labels), FV(F.ABS, n, c=0.2)
    rng = np.random.default_rng(42)
    A = rng.standard_normal((m, n))
    x_true = rng.standard_normal(n)
    x_true[rng.random(n) < 0.9] = 0.0
    b = A @ x_true + 0.1 * rng.standard_normal(m)
    lam = 0.1 * float(np.max(np.abs(A.T @ b)))
    return A.astype(np.float32), FV(F.SQUARE, m, b=b), FV(F.ABS, n, c=lam)


def inputs(torch, P, name):
    """The kernel's arguments from the port's init on the card, and Aᵀ."""
    from pogs_tpu_torch.prox.vector import scale_f, scale_g

    A, f, g = problem(P, name)
    dt = torch.float32
    st = P.GraphFormSolver(A, dtype=dt, device="cuda").init()._init_state

    def cast(fv):
        return fv.replace_params(*(p.to(device="cuda", dtype=dt) for p in fv.params))

    f_s, g_s = scale_f(cast(f), st["d"]), scale_g(cast(g), st["e"])
    m, n = A.shape
    z0 = torch.zeros(m + n, dtype=dt, device="cuda")
    settings = P.SolverSettings(max_iter=2000, **TOL)
    args = (st["A"], st["factor"]["op"], st["norm_A"], f.h, tuple(f_s.params), g.h,
            tuple(g_s.params), settings, z0, z0, 1.0)
    return args, st["At"]


def split_case(torch, lib, sites, name, args, At, fused_admm_loop, plan_of):
    ns = (ctypes.c_ulonglong * k3_split.MAX_SITES)()
    cnt = (ctypes.c_ulonglong * k3_split.MAX_SITES)()
    run = lambda: fused_admm_loop(*args, At=At)  # noqa: E731
    run()
    torch.cuda.synchronize()
    lib.k3_split_reset()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = run()
    stop.record()
    torch.cuda.synchronize()
    lib.k3_split_read(ns, cnt)
    iters = int(out["final_iter"]) + 1
    ms = start.elapsed_time(stop)
    rows, totals = [], {"work": 0.0, "barrier": 0.0, "reduce": 0.0}
    for i, (kind, line, phase) in enumerate(sites):
        us = ns[i] / 1e3 / iters
        totals[kind] += us
        rows.append({"site": i, "kind": kind, "line": line, "phase": phase,
                     "count": int(cnt[i]), "us_per_iter": us,
                     "us_per_occurrence": ns[i] / 1e3 / max(int(cnt[i]), 1)})
    rec = {"case": name, "shape": list(args[0].shape), "status": int(out["status"]),
           "iterations": iters, "ms": ms, "us_per_iter": 1e3 * ms / iters,
           "totals_us_per_iter": totals, "sites": rows}
    if "a_passes" in out:
        rec["a_passes"] = int(out["a_passes"])
        rec["a_passes_per_iter"] = rec["a_passes"] / iters
    if ns[k3_split.MAX_SITES - 2]:  # --fine: the kernel's time and SM clock on thread 0
        rec["kernel_us"] = ns[k3_split.MAX_SITES - 2] / 1e3
        rec["sm_clock_ghz"] = ns[k3_split.MAX_SITES - 1] / ns[k3_split.MAX_SITES - 2]
    if plan_of is not None:
        rec["plan"] = plan_of(args)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO, help="tree whose kernel and wrapper are timed")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--no-barriers", action="store_true")
    ap.add_argument("--fine", action="store_true",
                    help="stamps inside the loop too, accumulated in local memory")
    ap.add_argument("--out", help="JSON file for the results")
    opt = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k1_split: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(opt.root)
    sys.path.insert(0, root)
    import pogs_tpu_torch as P
    from pogs_tpu_torch.ops import _build
    from pogs_tpu_torch.ops import fused_admm as fa

    if not os.path.abspath(P.__file__).startswith(root):
        raise RuntimeError(f"imported {P.__file__}, not the tree {root}")
    build_dir = os.path.join(REPO, "build", "k1_split", opt.label)
    os.makedirs(build_dir, exist_ok=True)
    lib_path, sites, ptxas = k3_split.build_timed(
        root, build_dir, "fused_admm", "fused_admm_kernel",
        FINE_MARKS if opt.fine else (), opt.fine)
    plain = _build.library_path
    _build.library_path = lambda name: Path(lib_path) if name == "fused_admm" else plain(name)
    lib = ctypes.CDLL(lib_path)
    lib.k3_split_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.k3_split_reset.argtypes = []
    plan_of = None
    if hasattr(fa, "launch_plan"):
        def plan_of(args):
            A = args[0]
            return fa.launch_plan(fa._lib(), A.device, A.dtype, A.shape[0], A.shape[1],
                                  args[3], args[5])
    result = {"label": opt.label, "root": root, "ptxas": ptxas,
              "sites": [{"site": i, "kind": k, "line": ln, "phase": ph}
                        for i, (k, ln, ph) in enumerate(sites)], "cases": []}
    print(json.dumps({"label": opt.label, "ptxas": ptxas}), flush=True)
    for name in opt.cases.split(","):
        args, At = inputs(torch, P, name)
        rec = split_case(torch, lib, sites, name, args, At, fa.fused_admm_loop, plan_of)
        rec["label"] = opt.label
        result["cases"].append(rec)
        print(json.dumps({k: v for k, v in rec.items() if k != "sites"}), flush=True)
        print(json.dumps({"case": name, "label": opt.label, "sites": [
            (r["site"], r["kind"], r["line"], r["phase"][:24], round(r["us_per_iter"], 3),
             r["count"]) for r in rec["sites"]]}), flush=True)
    if not opt.no_barriers:
        result["barrier_loop"] = k3_split.barrier_table(build_dir)
        print(json.dumps({"barrier_loop": result["barrier_loop"]}), flush=True)
    out = opt.out or os.path.join(REPO, "build", f"k1_split_{opt.label}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
