"""prepare_ms: the mean per call of the summed ``pogs.prepare`` spans, the
solve's host work from the scaled prox parameters to the solve kernel's
launch."""

from perfbench.spans import mean_total_ms


def read(ctx):
    return mean_total_ms(ctx, "pogs.prepare")
