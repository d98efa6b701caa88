"""equil_ms.oneshot: the mean, over the calls that init, of
``pogs.init.equilibrate``'s share of the init's critical path
(``perfbench/spans.py::init_parts``): Sinkhorn-Knopp and the scaled A."""

from perfbench.spans import init_part_ms


def read(ctx):
    return init_part_ms(ctx, "pogs.init.equilibrate")
