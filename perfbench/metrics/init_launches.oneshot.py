"""init_launches.oneshot: the mean count of kernels a call launches before
its solve kernel's launch."""

from perfbench.layers import mean_launches_before


def read(ctx):
    return mean_launches_before(ctx, ctx.entry.kernel)
