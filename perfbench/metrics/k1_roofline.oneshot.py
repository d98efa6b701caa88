"""k1_roofline.oneshot: what metrics/k1_roofline.py reads, in the
one-shot cells, where it moves solves_per_s.oneshot."""

from perfbench.harness import reader

read = reader("k1_roofline")
