"""norm_est_ms.oneshot: the mean, over the calls that init, of
``pogs.init.norm_est``'s share of the init's critical path
(``perfbench/spans.py::init_parts``): the power iteration for ‖A‖₂."""

from perfbench.spans import init_part_ms


def read(ctx):
    return init_part_ms(ctx, "pogs.init.norm_est")
