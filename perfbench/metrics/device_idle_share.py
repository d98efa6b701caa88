"""device_idle_share: the share of the traced window, in %, in which no
operation ran on the card (1 − the union of the device operations'
intervals over the window)."""

from perfbench.layers import device_busy_us


def read(ctx):
    w0, w1 = ctx.window
    if w1 <= w0 or not ctx.trace.device_ops:
        return None
    return 100.0 * (1.0 - device_busy_us(ctx.trace, w0, w1) / (w1 - w0))
