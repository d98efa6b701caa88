"""device_idle_share.oneshot: what metrics/device_idle_share.py reads, in the
one-shot cells, where it moves solves_per_s.oneshot."""

from perfbench.harness import reader

read = reader("device_idle_share")
