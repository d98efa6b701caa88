"""Seed streams and device generators for the benchmark's inputs.

Every input of a run follows from ``--seed`` through a named stream: the
fixed matrix from ``MATRIX``, the warm-up request from ``WARMUP``, request
i from (``REQUEST``, i), and the sample of answers the reference judges
from ``SAMPLE``.  The same seed gives the same inputs, and a request can be
made again after the window, bit for bit, for the reference.
"""

from __future__ import annotations

import numpy as np
import torch

MATRIX, WARMUP, REQUEST, SAMPLE = 0, 1, 2, 3


def stream_seed(seed: int, *key: int) -> int:
    """A 63-bit seed for the stream ``key`` of run seed ``seed`` (any
    non-negative integer, more than 32 bits included)."""
    if seed < 0:
        raise ValueError(f"seed must be non-negative, not {seed}")
    words = []
    while True:
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
        if not seed:
            break
    state = np.random.SeedSequence(words + [k & 0xFFFFFFFF for k in key]).generate_state(2)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(device, seed: int, *key: int) -> torch.Generator:
    """A torch generator on ``device`` seeded for the stream ``key``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, *key))
    return gen


def sample(seed: int, count: int, size: int, must=()) -> list:
    """``size`` indices of range(count), drawn from the seed, with the
    indices in ``must`` among them; sorted."""
    must = sorted(set(must))
    rest = [i for i in range(count) if i not in set(must)]
    rng = np.random.default_rng(stream_seed(seed, SAMPLE))
    take = max(0, min(size, count) - len(must))
    picked = rng.choice(len(rest), size=take, replace=False) if take else []
    return sorted(must + [rest[int(j)] for j in picked])
