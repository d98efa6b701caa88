"""iters_per_solve.oneshot: what metrics/iters_per_solve.py reads, in the
one-shot cells, where it moves solves_per_s.oneshot."""

from perfbench.harness import reader

read = reader("iters_per_solve")
