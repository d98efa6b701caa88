"""The least time the card could take for the port's solves: the yardstick
of the ``*_roofline_share`` metrics.

Bytes and FLOPs follow from the shapes and the executed iterations only, so
a kernel's plan, tile or route never changes the work it is held to.  Each
input is counted once, each output once, and every executed iteration's
arithmetic; data-dependent extra checks near tolerance are left out, so
the bound is a floor.  The arithmetic is ``chip_smoke.py``'s ``bound_ms``,
``solve_work`` and ``sweep_bound``.
"""

from __future__ import annotations

# Published peaks of one H100 SXM (NVIDIA's data sheet, 700 W): HBM bytes
# per second, and FLOP/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def bound_ms(n_bytes, flops, dtype):
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the FLOPs over the CUDA-core peak of the type.  Returns
    (milliseconds, "bytes" or "operations")."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def solve_work(m, n, iters, exact, itemsize, lanes=1, lane_in=0, lane_out=0):
    """Bytes and FLOPs of graph-form solves on an (m, n) A.  Inputs are read
    once (A, Ginv, the f and g parameters, and lane_in elements per lane),
    outputs written once (lane_out elements per lane).  Every executed
    iteration projects (2 (2mn + k^2) FLOPs); ``exact`` counts the exact
    residual checks (4mn each) the run needed at least: one per converged
    solve."""
    k = min(m, n)
    n_bytes = itemsize * (m * n + k * k + 5 * (m + n) + lanes * (lane_in + lane_out))
    flops = 2 * (2 * m * n + k * k) * iters + 4 * m * n * exact
    return n_bytes, flops


def sweep_work(m, n, iters, exact, lanes, itemsize, fb=False):
    """Bytes and FLOPs of one batched (K2) call: ``iters`` executed
    lane-iterations in all, ``exact`` converged lanes, per-lane c (and f.b
    with ``fb``) in, x, y and four statistics out per lane."""
    return solve_work(m, n, iters, exact, itemsize, lanes=lanes,
                      lane_in=n + (m if fb else 0), lane_out=n + m + 4)
