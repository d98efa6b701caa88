"""k1_roofline: K1's share of its roofline, in %: the least time of every
solve in the window (``roofline.solve_work``: each input once, each
executed iteration's projection, one exact check per converged solve)
over fused_admm_kernel's summed device time."""

from perfbench import roofline
from perfbench.layers import roofline_share


def read(ctx):
    e = ctx.entry

    def bound(rec):
        return sum(roofline.bound_ms(*roofline.solve_work(e.m, e.n, it, int(st == 0),
                                                          e.itemsize), e.dtype_name)[0]
                   for it, st in zip(rec["iters"], rec["status"]))

    return roofline_share(ctx, "fused_admm_kernel", bound)
