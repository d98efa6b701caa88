#!/usr/bin/env python3
"""The control of a cell's check: the plain reference, computed one
precision below the configuration's (TF32 for float32 with TF32 off), put
in the program's place at the cell's own size and load.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 [--precision tf32]

For each seed it makes the requests a run would make, answers as many of
them as a run judges with the reference in that precision, and judges
those answers exactly as a run judges the program's (``harness.judge``).
It prints one JSON line per seed with every number beside its limit and
whether the answers would pass; the control has to fail.  The benchmark's
own runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_run(name, seed, precision="tf32", device="cuda:0", overrides=None, P=None,
                traffic_overrides=None, calls=None):
    """The checks of one control run: {number: (value, limit)}, and the
    statuses and iterations of its answers.  ``calls`` answers are judged
    (by default as many as a run judges)."""
    from perfbench import harness

    if P is None:
        import pogs_tpu_torch as P
    cell = harness.load_cell(name, overrides=overrides, traffic_overrides=traffic_overrides)
    entry = harness.make_entry(cell, P, seed, device)
    entry.setup()
    entry.release()
    entry.precision = precision
    win = harness.run_window(entry, float("inf"), device, False, call=entry.control,
                             max_calls=calls or cell.sample)
    verdict = harness.judge(cell, entry, win, seed, 0)
    return verdict, win


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control of a cell's check")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--precision", default="tf32", choices=("tf32", "float32", "float64"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        verdict, win = control_run(args.workload, seed, args.precision)
        checks = verdict["checks"]
        print(json.dumps({
            "workload": args.workload, "seed": seed, "precision": args.precision,
            "passes": all(v <= lim for v, lim in checks.values()),
            "checks": {k: [v, lim] for k, (v, lim) in checks.items()},
            "info": verdict["info"],
            "statuses": [s for r in win.records for s in r["status"]],
            "iters": [i for r in win.records for i in r["iters"]],
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
