"""program_idle_ms: the mean per call of the traced window's device-idle
time that lies inside some ``pogs.*`` span: the card waiting on the
program's own host work, not on the benchmark's."""

from perfbench.spans import program_idle_ms


def read(ctx):
    return program_idle_ms(ctx)
