"""k2_roofline: the batched kernel's share of its roofline, in %: the least
time of every λ-path in the window (``roofline.sweep_work``: each input
once, every executed lane-iteration's projection, one exact check per
converged lane) over sweep_kernel's summed device time."""

from perfbench import roofline
from perfbench.layers import roofline_share


def read(ctx):
    e = ctx.entry

    def bound(rec):
        work = roofline.sweep_work(e.m, e.n, sum(rec["iters"]),
                                   sum(int(s == 0) for s in rec["status"]),
                                   len(rec["status"]), e.itemsize)
        return roofline.bound_ms(*work, e.dtype_name)[0]

    return roofline_share(ctx, "sweep_kernel", bound)
