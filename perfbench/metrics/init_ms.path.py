"""The mean time from a call's start to the host's launch of its solve
kernel: the call's init (equilibration, the norm estimate, the projector's
factor) and its entry work before the kernel."""

from perfbench.layers import mean_prelaunch_ms


def read(ctx):
    return mean_prelaunch_ms(ctx, ctx.entry.kernel)
