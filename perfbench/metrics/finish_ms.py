"""finish_ms: the mean per call from the device end of its last solve
kernel to the extended end of its outermost ``pogs.call``: the unscale, the
wait for the status and the result."""

from perfbench.spans import finish_ms


def read(ctx):
    return finish_ms(ctx)
