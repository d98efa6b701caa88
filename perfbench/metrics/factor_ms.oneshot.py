"""factor_ms.oneshot: the mean, over the calls that init, of
``pogs.init.factor``'s share of the init's critical path
(``perfbench/spans.py::init_parts``): the projector's Gram, Cholesky and
inverse."""

from perfbench.spans import init_part_ms


def read(ctx):
    return init_part_ms(ctx, "pogs.init.factor")
