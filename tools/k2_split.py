#!/usr/bin/env python3
"""Where an iteration of the resident batched kernel (K2 below L2) goes, on
the card.

    python3 tools/k2_split.py [--label NAME] [--cases a,b,...]
                              [--plan C,smem|global] [--out FILE]

Builds a timed copy of this checkout's
``pogs_tpu_torch/csrc/fused_admm_batch.cu`` in which thread 0 of block 0
(rank 0 of the first cluster) reads ``%globaltimer`` before and after every
cluster barrier and after every gather, product, elementwise pass and
per-lane block sum of the kernel body, and adds the time since its previous
reading to that site's total (a fire-and-forget atomic add, which does not
wait for L2).  The copy is built with nvcc into ``build/k2_split/`` and
launched through the port's wrapper (``ops/fused_admm_batch.py``, the
resident route forced).  Per case it
prints one JSON line: the kernel's time on block 0 from its start to its
exit (no wrapper or launch overhead) and its SM clock (clock64 cycles over
that time), the call's time by CUDA events, the
plan (C, Kc, clusters), the iterations of the slowest lane, and each site's
microseconds per iteration of block 0's cluster:

  * ``work``: block 0's work since the previous reading, up to the site;
  * ``barrier``: from block 0's arrival at a cluster barrier to its
    release, i.e. the wait for the slowest block plus the barrier itself.

``--plan`` forces the cluster size and where the slices sit.  The cases are lasso sweeps of the bench problem
generator (chip_smoke.py's make_lasso, λ from 1 to 0.5 λ_bench) at the
bench tolerances: NAME = lasso_MxN_KK_DTYPE.  Everything is also written to
``--out`` (default ``build/k2_split_<label>.json``).  Needs a CUDA device
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import k3_split  # noqa: E402

MAX_SITES = 64
CASES = ("lasso_500x300_K128_f32", "lasso_500x300_K8_f32", "lasso_120x80_K8_f32",
         "lasso_300x500_K16_f32", "lasso_500x300_K128_f64", "lasso_1000x600_K32_f32")

PRELUDE = r"""
__device__ unsigned long long g_k2_ns[%(n)d];
__device__ unsigned long long g_k2_cnt[%(n)d];
__device__ __forceinline__ unsigned long long k2_now() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K2_STAMP(id)                                          \
  if (blockIdx.x == 0 && threadIdx.x == 0) {                  \
    const unsigned long long k2_t = k2_now();                 \
    atomicAdd(&g_k2_ns[id], k2_t - k2_last);                  \
    atomicAdd(&g_k2_cnt[id], 1ULL);                           \
    k2_last = k2_t;                                           \
  }
extern "C" void k2_split_read(unsigned long long* ns, unsigned long long* cnt) {
  cudaMemcpyFromSymbol(ns, g_k2_ns, sizeof(g_k2_ns));
  cudaMemcpyFromSymbol(cnt, g_k2_cnt, sizeof(g_k2_cnt));
}
extern "C" void k2_split_reset() {
  static unsigned long long zero[%(n)d] = {0};
  cudaMemcpyToSymbol(g_k2_ns, zero, sizeof(zero));
  cudaMemcpyToSymbol(g_k2_cnt, zero, sizeof(zero));
}
"""

BARRIER = re.compile(r"^(\s*)cluster_barrier\(cluster, C\);(.*)$")
CALL = re.compile(r"^\s*(?:const T\* \w+ = )?(whole|gather|product|lane_sums)<|^\s*(element_pass)\(")
BEFORE = (re.compile(r"^\s*bool any_near = false;"), re.compile(r"^\s*// --- Per-lane decisions"),
          re.compile(r"^\s*// --- F:"), re.compile(r"^\s*par \^= 1;"))
PHASE = re.compile(r"//\s*(---.*|barrier.*)")


def instrument(src: str, kernel: str = "cluster_kernel"):
    """The timed copy of the kernel's source, and its sites: a list of
    (kind, source line, label) in the order of their ids.  The last site
    is the kernel's whole time on block 0."""
    lines = src.split("\n")
    start = next(i for i, ln in enumerate(lines) if f"{kernel}(" in ln and "__global__" in ln)
    while not lines[start].rstrip().endswith("{"):
        start += 1
    end = next(i for i in range(start + 1, len(lines)) if lines[i] == "}")
    sites, out, label, depth, call = [], [], "", 0, None
    for i, ln in enumerate(lines):
        if start < i < end:
            m = PHASE.search(ln)
            if m:
                label = m.group(1).strip("- ").strip()
            if any(b.search(ln) for b in BEFORE):
                sites.append(("work", i + 1, f"before: {ln.strip()[:40]}"))
                out.append(f"K2_STAMP({len(sites) - 1});")
            mb = BARRIER.match(ln)
            if mb:
                ind, rest = mb.groups()
                a, b = len(sites), len(sites) + 1
                sites += [("work", i + 1, f"to {rest.strip('/ ') or 'barrier'}"),
                          ("barrier", i + 1, rest.strip("/ ") or "barrier")]
                out.append(f"{ind}K2_STAMP({a}); cluster_barrier(cluster, C); K2_STAMP({b});")
                continue
            mc = CALL.match(ln)
            if mc and call is None:
                call, depth = mc.group(1) or mc.group(2), 0
            if call is not None:
                depth += ln.count("(") - ln.count(")")
                out.append(ln)
                if depth <= 0 and ln.rstrip().endswith(";"):
                    sites.append(("work", i + 1, f"{call} ({label})"))
                    out.append(f"K2_STAMP({len(sites) - 1});")
                    call = None
                continue
        if i == end:
            sites.append(("kernel", start + 1, "whole kernel on block 0"))
            # The kernel's nanoseconds and SM clock cycles on block 0.
            sites.append(("cycles", start + 1, "SM cycles of the kernel on block 0"))
            out.append("  if (blockIdx.x == 0 && threadIdx.x == 0) {")
            out.append(f"    atomicAdd(&g_k2_ns[{len(sites) - 2}], k2_now() - k2_t0);")
            out.append(f"    atomicAdd(&g_k2_ns[{len(sites) - 1}], "
                       "(unsigned long long)(clock64() - k2_c0));")
            out.append("  }")
        out.append(ln)
        if i == start:
            out.append("  unsigned long long k2_last = k2_now();")
            out.append("  const unsigned long long k2_t0 = k2_last;")
            out.append("  const long long k2_c0 = clock64();")
    if len(sites) > MAX_SITES:
        raise RuntimeError(f"{len(sites)} timing sites, at most {MAX_SITES}")
    last_inc = max(i for i, ln in enumerate(out) if ln.startswith("#include"))
    out.insert(last_inc + 1, PRELUDE % {"n": MAX_SITES})
    return "\n".join(out), sites


def case_inputs(torch, P, cs, name):
    """K2's arguments for a named lasso sweep from the port's init on the
    card."""
    _, shape, k, dname = name.split("_")
    m, n = (int(v) for v in shape.split("x"))
    K = int(k[1:])
    dt = {"f32": torch.float32, "f64": torch.float64}[dname]
    A, b, lam = cs.make_lasso(m, n)
    if dt == torch.float64:
        A = A.astype("float64")
    args, _, _, _, _ = cs.sweep_inputs(torch, P, A, b, [lam * (1.0 - 0.5 * i / max(K - 1, 1))
                                                        for i in range(K)], dt)
    return (m, n, K, dt), args + (P.SolverSettings(**cs.BENCH_TOL), 1.0)


def split_case(torch, fab, lib, sites, name, dims, args):
    m, n, K, dt = dims
    ns = (ctypes.c_ulonglong * MAX_SITES)()
    cnt = (ctypes.c_ulonglong * MAX_SITES)()
    run = lambda: fab.fused_batched_lasso_sweep(*args)  # noqa: E731
    run()
    torch.cuda.synchronize()
    lib.k2_split_reset()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = run()
    stop.record()
    torch.cuda.synchronize()
    lib.k2_split_read(ns, cnt)
    iters = int(out["final_iter"].max()) + 1
    plan = fab.cluster_plan(m, n, 8 if dt == torch.float64 else 4)
    slots = fab.cluster_slots(fab._lib(), args[0].device, dt == torch.float64, m, n, plan)
    kc = fab.chunk_for(K, slots)
    # Block 0's cluster runs until its own last lane is done.
    it0 = int(out["final_iter"][:kc].max()) + 1
    rows, totals = [], {"work": 0.0, "barrier": 0.0}
    for i, (kind, line, label) in enumerate(sites):
        if kind in ("kernel", "cycles"):
            continue
        us = ns[i] / 1e3 / it0
        totals[kind] += us
        rows.append({"site": i, "kind": kind, "line": line, "label": label,
                     "count": int(cnt[i]), "us_per_iter": us})
    return {"case": name, "plan": {"C": plan["C"], "in_smem": plan["in_smem"], "kc": kc,
                                   "clusters": -(-K // kc), "slots": slots},
            "status": sorted(set(out["status"].cpu().tolist())), "iterations": iters,
            "block0_iterations": it0, "call_ms": start.elapsed_time(stop),
            "kernel_us_block0": ns[len(sites) - 2] / 1e3,
            "kernel_us_per_iter_block0": ns[len(sites) - 2] / 1e3 / it0,
            "sm_ghz_block0": ns[len(sites) - 1] / max(ns[len(sites) - 2], 1),
            "totals_us_per_iter": totals, "sites": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--plan", help="force the plan: C,smem or C,global")
    ap.add_argument("--out", help="JSON file for the results")
    opt = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k2_split: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import pogs_tpu_torch as P
    from pogs_tpu_torch.ops import _build
    from pogs_tpu_torch.ops import fused_admm_batch as fab
    import chip_smoke as cs

    build_dir = os.path.join(REPO, "build", "k2_split", opt.label)
    os.makedirs(build_dir, exist_ok=True)
    csrc = os.path.join(REPO, "pogs_tpu_torch", "csrc")
    with open(os.path.join(csrc, "fused_admm_batch.cu")) as fh:
        timed, sites = instrument(fh.read())
    src = os.path.join(build_dir, "fused_admm_batch_timed.cu")
    with open(src, "w") as fh:
        fh.write(timed)
    lib_path = os.path.join(build_dir, "libfused_admm_batch_timed.so")
    ptxas = k3_split.nvcc(src, lib_path, csrc)
    lib = ctypes.CDLL(lib_path)
    lib.k2_split_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.k2_split_reset.argtypes = []
    _build._LIBS["fused_admm_batch"] = lib
    fab.route_for = lambda m, n, itemsize, K: "resident"
    if opt.plan:
        C, where = opt.plan.split(",")
        layout = fab.cluster_layout
        fab.cluster_plan = lambda m, n, i: layout(m, n, i, int(C), where == "smem")
    result = {"label": opt.label, "plan": opt.plan, "ptxas": ptxas, "cases": []}
    print(json.dumps({"label": opt.label, "sites": len(sites),
                      "ptxas": [ln for ln in ptxas if "registers" in ln or "spill" in ln]}),
          flush=True)
    for name in opt.cases.split(","):
        dims, args = case_inputs(torch, P, cs, name)
        rec = split_case(torch, fab, lib, sites, name, dims, args)
        rec["label"] = opt.label
        result["cases"].append(rec)
        print(json.dumps({k: v for k, v in rec.items() if k != "sites"}), flush=True)
        print(json.dumps({"case": name, "sites": [
            (r["kind"][0], r["line"], r["label"][:28], round(r["us_per_iter"], 2))
            for r in rec["sites"] if r["count"]]}), flush=True)
    out = opt.out or os.path.join(REPO, "build", f"k2_split_{opt.label}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
