"""The mean, over the calls that init, from the start of ``pogs.init`` to
its extended end: equilibration, the norm estimate, the projector's factor
and the kernel-ready copy of A, with the device work they launched."""

from perfbench.spans import init_span_ms


def read(ctx):
    return init_span_ms(ctx)
