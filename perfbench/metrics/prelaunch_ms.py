"""prelaunch_ms: the mean time from a call's start to the host's launch of
its solve kernel (entry and solver set-up, before the kernel runs)."""

from perfbench.layers import mean_prelaunch_ms


def read(ctx):
    return mean_prelaunch_ms(ctx, ctx.entry.kernel)
