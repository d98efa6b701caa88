"""program_idle_ms.oneshot: what metrics/program_idle_ms.py reads, in the
one-shot cells, where it moves solves_per_s.oneshot."""

from perfbench.harness import reader

read = reader("program_idle_ms")
