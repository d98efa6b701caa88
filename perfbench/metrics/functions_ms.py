"""functions_ms: the mean per call of the summed ``pogs.functions`` spans,
the objective's parameters made into tensors (``FunctionVector``)."""

from perfbench.spans import mean_total_ms


def read(ctx):
    return mean_total_ms(ctx, "pogs.functions")
