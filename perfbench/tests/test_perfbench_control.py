"""The control of each cell's check comes out not correct: the plain
reference with every product in TF32 (emulated by rounding both operands,
so that it runs on the CPU too), put in the program's place at a size a
test run holds, on three seeds.  At the cells' own sizes on the card the
same control is ``perfbench/control.py`` (readings in PERF.md)."""

import pytest

from perfbench import control

# (config, traffic, answers judged).
SMALL = {"lasso-10000x5000.refit": (dict(m=1000, n=500), None, None),
         "lasso-10000x5000.oneshot": (dict(m=1000, n=500), None, None),
         "lasso-10000x5000.path100": (dict(m=600, n=300), {"nlambda": 8}, None)}
SEEDS = (11, 2 ** 32 + 12, 13)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails(cell, seed):
    ov, tr, calls = SMALL[cell]
    verdict, win = control.control_run(cell, seed, "tf32", device="cpu", overrides=ov,
                                       traffic_overrides=tr, calls=calls)
    checks = verdict["checks"]
    assert not all(v <= lim for v, lim in checks.values()), checks

