#!/usr/bin/env python3
"""Where an iteration of the cone kernel (K3) goes, on the card.

    python3 tools/k3_split.py [--root TREE] [--label NAME] [--cases a,b,...]
                              [--no-barriers] [--out FILE]

Builds a timed copy of ``TREE/pogs_tpu_torch/csrc/fused_hsde.cu`` (default:
this checkout) in which thread 0 of block 0 reads ``%globaltimer`` before and
after every grid barrier and after every cross-block reduction of the kernel
body, and adds the time since its previous reading to that site's total.
The copy is built with nvcc into ``build/k3_split/`` and launched through
TREE's own wrapper (``ops/fused_hsde.py``), so an older tree's kernel is
timed with its own interface.  Per case it prints one JSON line: the solve's
time and iterations, and each site's microseconds per iteration:

  * ``work``: block 0's work since the previous reading (its products,
    elementwise loops, SOC work and, in a tree where block 0 projects the
    exponential cones, their projection), up to the barrier that follows;
  * ``barrier``: from block 0's arrival at a barrier to its release, i.e. the
    wait for the slowest block plus the barrier itself;
  * ``reduce``: the fixed-order reduction of partial sums after a barrier.

Then, unless --no-barriers, the bare barrier loop of tools/barrier_loop.cu at
grids of 1, 8, 33, 66 and 132 blocks.  Everything is also written to
``--out`` (default ``build/k3_split_<label>.json``).  Needs a CUDA device
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
MAX_SITES = 64
CASES = ("socp_ball_804x200_f64", "lp_ineq_1100x300_f64", "exp_3x1", "socp_8004x2000_f32")

PRELUDE = r"""
__device__ unsigned long long g_k3_ns[%(n)d];
__device__ unsigned long long g_k3_cnt[%(n)d];
__device__ __forceinline__ unsigned long long k3_now() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K3_STAMP(id)                                          \
  if (blockIdx.x == 0 && threadIdx.x == 0) {                  \
    const unsigned long long k3_t = k3_now();                 \
    g_k3_ns[id] += k3_t - k3_last;                            \
    g_k3_cnt[id] += 1;                                        \
    k3_last = k3_t;                                           \
  }
extern "C" void k3_split_read(unsigned long long* ns, unsigned long long* cnt) {
  cudaMemcpyFromSymbol(ns, g_k3_ns, sizeof(g_k3_ns));
  cudaMemcpyFromSymbol(cnt, g_k3_cnt, sizeof(g_k3_cnt));
}
extern "C" void k3_split_reset() {
  static unsigned long long zero[%(n)d] = {0};
  cudaMemcpyToSymbol(g_k3_ns, zero, sizeof(zero));
  cudaMemcpyToSymbol(g_k3_cnt, zero, sizeof(zero));
}
"""

# The timed copy's stamps accumulate in thread 0's local memory instead
# (local=True), flushed to the counters when the kernel ends: a global
# read-modify-write per stamp would add an L2 round trip to every phase.
LOCAL = r"""
#define K3_LSTAMP(id)                                         \
  if (blockIdx.x == 0 && threadIdx.x == 0) {                  \
    const unsigned long long k3_t = k3_now();                 \
    k3_acc[id] += k3_t - k3_last;                             \
    k3_n[id] += 1;                                            \
    k3_last = k3_t;                                           \
  }
"""

BARRIER = re.compile(r"^(\s*)(grid\.sync\(\);|grid_sync\([^;]*\);)\s*$")
REDUCE = re.compile(r"^(\s*)(grid_partials\([^;]*\);)\s*$")
PHASE = re.compile(r"//\s*(---.*|C\d.*)")


def instrument(src: str, kernel: str = "fused_hsde_kernel", marks=(), local=False):
    """The timed copy of a persistent kernel's source (its __global__
    function ``kernel``), and the sites: a list of (kind, source line, phase
    comment) in the order of their ids.  A body line that matches one of the
    regexes ``marks`` gets a "work" stamp after it; with ``local`` the
    stamps add up in thread 0's local memory (flushed at the kernel's end)."""
    marks = [re.compile(mk) for mk in marks]
    stamp = "K3_LSTAMP" if local else "K3_STAMP"
    lines = src.split("\n")
    start = next(i for i, ln in enumerate(lines)
                 if f"{kernel}(" in ln and ("__global__" in ln or "__global__" in lines[i - 1]))
    while not lines[start].rstrip().endswith("{"):
        start += 1
    end = next(i for i in range(start + 1, len(lines)) if lines[i] == "}")
    sites, out, phase = [], [], ""
    for i, ln in enumerate(lines):
        if start < i < end:
            m = PHASE.search(ln)
            if m:
                phase = m.group(1).strip("- ").strip()
            mb, mr = BARRIER.match(ln), REDUCE.match(ln)
            if mb:
                ind, stmt = mb.groups()
                a, b = len(sites), len(sites) + 1
                sites += [("work", i + 1, phase), ("barrier", i + 1, phase)]
                out.append(f"{ind}{stamp}({a}); {stmt} {stamp}({b});")
                continue
            if mr:
                ind, stmt = mr.groups()
                sites.append(("reduce", i + 1, phase))
                out.append(f"{ind}{stmt} {stamp}({len(sites) - 1});")
                continue
            if any(mk.search(ln) for mk in marks):
                sites.append(("work", i + 1, phase))
                out.append(f"{ln} {stamp}({len(sites) - 1});")
                continue
        if i == end and local:
            # The last two counters: the kernel's nanoseconds and SM clock
            # cycles on thread 0 of block 0 (their ratio is the SM clock).
            out.append("  if (blockIdx.x == 0 && threadIdx.x == 0) {")
            out.append(f"    for (int k3_i = 0; k3_i < {MAX_SITES - 2}; ++k3_i) {{")
            out.append("      g_k3_ns[k3_i] += k3_acc[k3_i];")
            out.append("      g_k3_cnt[k3_i] += k3_n[k3_i];")
            out.append("    }")
            out.append(f"    g_k3_ns[{MAX_SITES - 2}] += k3_now() - k3_t0;")
            out.append(f"    g_k3_ns[{MAX_SITES - 1}] += clock64() - k3_c0;")
            out.append("  }")
        out.append(ln)
        if i == start:
            out.append("  unsigned long long k3_last = k3_now();")
            if local:
                out.append(f"  unsigned long long k3_acc[{MAX_SITES}] = {{0}}, "
                           f"k3_n[{MAX_SITES}] = {{0}};")
                out.append("  const unsigned long long k3_t0 = k3_last;")
                out.append("  const long long k3_c0 = clock64();")
    if len(sites) > MAX_SITES - (2 if local else 0):
        raise RuntimeError(f"{len(sites)} timing sites, at most {MAX_SITES}")
    last_inc = max(i for i, ln in enumerate(out) if ln.startswith("#include"))
    out.insert(last_inc + 1, PRELUDE % {"n": MAX_SITES} + (LOCAL if local else ""))
    return "\n".join(out), sites


def nvcc(src_path, out_path, include):
    cmd = [shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", include, "-o", out_path, src_path]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src_path}:\n{res.stdout}\n{res.stderr}")
    return [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
            if "registers" in ln or "spill" in ln or "Function properties" in ln
            or "Compiling entry" in ln]


def build_timed(root, build_dir, name="fused_hsde", kernel="fused_hsde_kernel", marks=(),
                local=False):
    """Build the timed copy of TREE's csrc/<name>.cu; returns the library's
    path, the sites and what ptxas said."""
    csrc = os.path.join(root, "pogs_tpu_torch", "csrc")
    with open(os.path.join(csrc, f"{name}.cu")) as fh:
        timed, sites = instrument(fh.read(), kernel, marks, local)
    src = os.path.join(build_dir, f"{name}_timed.cu")
    with open(src, "w") as fh:
        fh.write(timed)
    lib = os.path.join(build_dir, f"lib{name}_timed.so")
    ptxas = nvcc(src, lib, csrc)
    return lib, sites, ptxas


def cases(torch, P, cs, names):
    """(name, args, At, tol, max_iter) of each case, from the port's cone
    init on the card."""
    problems, _ = cs.cone_problems()
    by_name = {c[0]: c for c in cs.k3_cases(P)}
    out = []
    for name in names:
        if name == "socp_8004x2000_f32":
            p = problems.socp_ball(n=2000, n_balls=4)
            A, b, c, cones = p["A"], p["b"], p["c"], P.dims_to_cones(p["dims"])
            tol, max_iter, dt = cs.CONE_TOL["abs_tol"], cs.CONE_MAX_ITER, torch.float32
        else:
            _, A, b, c, cones, tol, max_iter, dname, _ = by_name[name]
            dt = getattr(torch, dname)
        args, At = cs.hsde_inputs(torch, P, A, b, c, cones, dt)
        out.append((name, list(A.shape), args, At, tol, max_iter))
    return out


def split_case(torch, lib, sites, name, shape, args, At, tol, max_iter, fused_hsde_solve):
    ns = (ctypes.c_ulonglong * MAX_SITES)()
    cnt = (ctypes.c_ulonglong * MAX_SITES)()
    run = lambda: fused_hsde_solve(*args, tol, tol, max_iter, At=At)  # noqa: E731
    run()
    torch.cuda.synchronize()
    lib.k3_split_reset()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = run()
    stop.record()
    torch.cuda.synchronize()
    lib.k3_split_read(ns, cnt)
    it = int(out["final_iter"])
    iters = it + 1 if it < max_iter else max_iter
    ms = start.elapsed_time(stop)
    rows, totals = [], {"work": 0.0, "barrier": 0.0, "reduce": 0.0}
    for i, (kind, line, phase) in enumerate(sites):
        us = ns[i] / 1e3 / iters
        totals[kind] += us
        rows.append({"site": i, "kind": kind, "line": line, "phase": phase,
                     "count": int(cnt[i]), "us_per_iter": us,
                     "us_per_occurrence": ns[i] / 1e3 / max(int(cnt[i]), 1)})
    return {"case": name, "shape": shape, "status": int(out["status"]), "iterations": iters,
            "ms": ms, "us_per_iter": 1e3 * ms / iters, "totals_us_per_iter": totals,
            "sites": rows}


def barrier_table(build_dir):
    src = os.path.join(HERE, "barrier_loop.cu")
    lib_path = os.path.join(build_dir, "libbarrier_loop.so")
    nvcc(src, lib_path, os.path.join(REPO, "pogs_tpu_torch", "csrc"))
    lib = ctypes.CDLL(lib_path)
    lib.barrier_loop_us.argtypes = [ctypes.c_int] * 3
    lib.barrier_loop_us.restype = ctypes.c_double
    rows = []
    for grid in (1, 8, 33, 66, 132):
        row = {"grid": grid,
               "grid_sync_us": lib.barrier_loop_us(grid, 20000, 0),
               "grid_sync_reduce5_us": lib.barrier_loop_us(grid, 20000, 1)}
        if grid == 1:
            row["syncthreads_reduce5_us"] = lib.barrier_loop_us(grid, 20000, 2)
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO, help="tree whose kernel and wrapper are timed")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--no-barriers", action="store_true")
    ap.add_argument("--out", help="JSON file for the results")
    opt = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k3_split: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(opt.root)
    sys.path.insert(0, root)
    sys.path.insert(1, REPO)
    import pogs_tpu_torch as P
    from pogs_tpu_torch.ops import _build
    from pogs_tpu_torch.ops.fused_hsde import fused_hsde_solve
    import chip_smoke as cs

    if not os.path.abspath(P.__file__).startswith(root):
        raise RuntimeError(f"imported {P.__file__}, not the tree {root}")
    build_dir = os.path.join(REPO, "build", "k3_split", opt.label)
    os.makedirs(build_dir, exist_ok=True)
    lib_path, sites, ptxas = build_timed(root, build_dir)
    plain = _build.library_path
    _build.library_path = lambda name: Path(lib_path) if name == "fused_hsde" else plain(name)
    lib = ctypes.CDLL(lib_path)
    lib.k3_split_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.k3_split_reset.argtypes = []
    result = {"label": opt.label, "root": root, "ptxas": ptxas,
              "sites": [{"site": i, "kind": k, "line": ln, "phase": ph}
                        for i, (k, ln, ph) in enumerate(sites)], "cases": []}
    print(json.dumps({"label": opt.label, "ptxas": ptxas}), flush=True)
    for name, shape, args, At, tol, max_iter in cases(torch, P, cs, opt.cases.split(",")):
        rec = split_case(torch, lib, sites, name, shape, args, At, tol, max_iter,
                         fused_hsde_solve)
        rec["label"] = opt.label
        result["cases"].append(rec)
        print(json.dumps({k: v for k, v in rec.items() if k != "sites"}), flush=True)
        print(json.dumps({"case": name, "label": opt.label, "sites": [
            (r["site"], r["kind"], r["line"], round(r["us_per_iter"], 3), r["count"])
            for r in rec["sites"]]}), flush=True)
    if not opt.no_barriers:
        result["barrier_loop"] = barrier_table(build_dir)
        print(json.dumps({"barrier_loop": result["barrier_loop"]}), flush=True)
    out = opt.out or os.path.join(REPO, "build", f"k3_split_{opt.label}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
