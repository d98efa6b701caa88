#!/usr/bin/env python3
"""The benchmark of pogs_tpu_torch: one run of one cell on one card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (loading the cell's kernels, building the inputs on the card from the
seed, initialising the solver and one warm-up call) is timed as
``setup_s``; then a closed loop with one client calls the program for
``--seconds``; then the plain reference judges a sample of the answers.
The last line of standard output is the result's JSON object; the last
lines of standard error give each number compared beside its limit.  With
``--trace 1`` the window runs under ``torch.profiler`` and the result holds
the cell's per-layer metrics instead of its end-to-end ones.  See
``perfbench/README.md``.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# Python's bytecode of torch and of the port, cached at a fixed path inside
# the checkout: where the installation ships no .pyc and the environment
# says not to write any, every run would compile torch's 2141 modules from
# source again (5 to 8 s, spreading with the host's load).  The first run
# of a checkout writes the cache; later runs read it.
sys.dont_write_bytecode = False
sys.pycache_prefix = str(ROOT / "build" / "pycache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "pogs_tpu_torch").is_dir():
        print("the program (pogs_tpu_torch) is not in this checkout", file=sys.stderr)
        return 2
    import torch

    # Set-up's first phases, each printed on its own: the import, and the
    # CUDA driver's start (cudaGetDeviceCount runs cuInit).
    early = [("import_torch", time.perf_counter())]
    found_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    early.append(("cuda_driver", time.perf_counter()))

    from perfbench import harness

    chips = next(w["chips"] for w in harness.benchmark(ROOT)["workloads"]
                 if w["name"] == args.workload)
    if found_cards < chips:
        print(f"no CUDA card for {args.workload} (needs {chips}; torch sees {found_cards})",
              file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           device="cuda:0", t_process=T_PROCESS, root=ROOT, early=early)
    found = harness.foreign_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for line in out["lines"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
