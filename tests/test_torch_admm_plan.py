"""The graph-form kernel's launch plan (ops/fused_admm.py::admm_plan) on the
CPU: its grid, shared memory and barriers, as functions of the
problem and the SM count alone.  The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import os
import re

import numpy as np
import pytest
import torch

import pogs_tpu_torch as P
from pogs_tpu_torch.ops import fused_admm as pf

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SIZES = [(1, 1), (3, 2), (2, 3), (60, 40), (40, 60), (120, 80), (500, 300), (300, 500),
          (2000, 1000), (5000, 2500), (2500, 5000), (20000, 5000), (100000, 50)]


def _kernel_source():
    return open(os.path.join(ROOT, "pogs_tpu_torch", "csrc", "fused_admm.cu")).read()


def _rnd(x, itemsize):
    per = 16 // itemsize
    return -(-x // per) * per


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", _SIZES)
def test_plan_blocks_within_the_limit(m, n, itemsize):
    """Blocks within the occupancy limit passed in and the SM count."""
    for sms, limit in ((132, 132), (132, 66), (132, 7), (132, 1), (8, 16), (114, 114),
                       (132, 264)):
        plan = pf.admm_plan(m, n, itemsize, sms, limit)
        assert 1 <= plan["blocks"] <= min(sms, limit)
        assert plan["threads"] == pf.THREADS


@pytest.mark.parametrize("m,n", _SIZES)
def test_plan_depends_only_on_the_problem(m, n):
    """One problem, one plan: the same dict on every call, whatever was
    planned in between."""
    first = pf.admm_plan(m, n, 4, 132, 132, 7)
    pf.admm_plan(n, m, 8, 66, 3, 9000)
    assert pf.admm_plan(m, n, 4, 132, 132, 7) == first


@pytest.mark.parametrize("sms", [132, 114, 8])
def test_plan_one_block_below_the_threshold(sms):
    """One block up to ONE_BLOCK_ELEMS matrix elements (2mn + k²), whose
    barriers are __syncthreads; half the SMs up to HALF_GRID_ELEMS; beyond,
    every SM."""
    for m, n in _SIZES + [(64, 48), (48, 64), (80, 50), (90, 60), (70, 70), (120, 80),
                          (150, 100), (200, 120)]:
        plan = pf.admm_plan(m, n, 4, sms, sms)
        elems = 2 * m * n + min(m, n) ** 2
        if elems <= pf.ONE_BLOCK_ELEMS:
            assert plan["blocks"] == 1
        elif elems <= pf.HALF_GRID_ELEMS:
            assert plan["blocks"] == sms // 2 > 1
        else:
            assert plan["blocks"] == sms > 1
    assert pf.admm_plan(60, 40, 4, sms, sms)["blocks"] == 1
    assert pf.admm_plan(80, 50, 4, sms, sms)["blocks"] == 1
    assert pf.admm_plan(90, 60, 4, sms, sms)["blocks"] == sms // 2
    assert pf.admm_plan(120, 80, 4, sms, sms)["blocks"] == sms // 2
    assert pf.admm_plan(200, 120, 4, sms, sms)["blocks"] == sms
    assert pf.admm_plan(500, 300, 4, sms, sms)["blocks"] == sms
    assert pf.admm_plan(500, 300, 4, sms, 7)["blocks"] == min(sms, 7)


# K1's route table: µs per iteration on 1, 8, 16, 33, 66 and 132 blocks,
# 1000 iterations (200 beyond a million elements of A) at tolerance 0
# (chip_smoke.py::admm_route_table on an NVIDIA H100 80GB HBM3, 700 W).
_ROUTE_GRIDS = (1, 8, 16, 33, 66, 132)
_ROUTE_TABLE = [
    ('lasso_60x40', 60, 40, 4, (13.8, 15.4, 14.9, 14.5, 14.6, 14.8)),
    ('lasso_60x40', 60, 40, 8, (17.4, 19.1, 19.2, 18.1, 19.7, 20.0)),
    ('lasso_40x60', 40, 60, 4, (13.7, 16.0, 15.5, 14.8, 14.9, 15.1)),
    ('lasso_40x60', 40, 60, 8, (17.2, 19.4, 19.4, 18.3, 19.7, 20.0)),
    ('lasso_80x50', 80, 50, 4, (14.7, 16.3, 15.5, 14.8, 14.6, 14.8)),
    ('lasso_80x50', 80, 50, 8, (18.9, 19.5, 19.4, 18.7, 18.4, 20.0)),
    ('lasso_90x60', 90, 60, 4, (16.8, 16.2, 15.5, 15.2, 14.7, 15.0)),
    ('lasso_90x60', 90, 60, 8, (20.8, 19.0, 19.2, 18.8, 18.3, 19.9)),
    ('lasso_100x70', 100, 70, 4, (17.9, 16.4, 15.8, 15.5, 14.9, 14.8)),
    ('lasso_100x70', 100, 70, 8, (21.9, 19.7, 19.2, 19.4, 18.2, 19.8)),
    ('lasso_120x80', 120, 80, 4, (17.1, 16.0, 15.9, 15.6, 14.8, 15.0)),
    ('lasso_120x80', 120, 80, 8, (22.2, 19.2, 19.7, 19.6, 18.4, 20.1)),
    ('lasso_200x120', 200, 120, 4, (23.0, 16.9, 15.9, 16.1, 15.2, 15.1)),
    ('lasso_200x120', 200, 120, 8, (28.1, 20.6, 19.7, 19.8, 19.0, 18.7)),
    ('lasso_300x200', 300, 200, 4, (38.3, 18.4, 16.9, 16.6, 16.3, 15.9)),
    ('lasso_300x200', 300, 200, 8, (48.9, 22.5, 20.5, 20.3, 20.0, 19.4)),
    ('lasso_500x300', 500, 300, 4, (55.9, 19.0, 16.5, 16.7, 16.3, 16.4)),
    ('lasso_500x300', 500, 300, 8, (81.4, 24.2, 20.0, 20.6, 20.1, 20.3)),
    ('lasso_300x500', 300, 500, 4, (56.1, 19.2, 16.8, 16.9, 16.7, 17.0)),
    ('lasso_300x500', 300, 500, 8, (82.5, 24.6, 20.6, 21.0, 20.5, 20.3)),
    ('lasso_1000x600', 1000, 600, 4, (141.8, 30.9, 24.1, 19.0, 16.6, 16.2)),
    ('lasso_1000x600', 1000, 600, 8, (207.8, 43.3, 32.5, 23.1, 19.9, 19.3)),
    ('lasso_2000x1000', 2000, 1000, 4, (315.7, 54.2, 36.3, 25.9, 21.4, 20.6)),
    ('lasso_3000x1500', 3000, 1500, 4, (743.3, 127.8, 76.5, 49.9, 40.1, 36.4)),
    ('lasso_5000x2500', 5000, 2500, 4, (2205.2, 302.7, 168.3, 100.3, 74.2, 67.7)),
    ('lasso_2500x5000', 2500, 5000, 4, (2246.1, 307.9, 169.1, 99.8, 73.2, 66.7)),
]
# The same call on the plan's grid: µs per iteration with the shared side
# forced on (3 barriers) and off (4); ``iterative`` logistic proxes on the
# shared side.
_SHARED_TABLE = [
    ('lasso_60x40', 60, 40, 4, 0, 13.9, 14.2),
    ('lasso_60x40', 60, 40, 8, 0, 17.5, 17.9),
    ('lasso_40x60', 40, 60, 4, 0, 13.6, 14.0),
    ('lasso_40x60', 40, 60, 8, 0, 17.3, 17.8),
    ('lasso_80x50', 80, 50, 4, 0, 15.0, 15.3),
    ('lasso_80x50', 80, 50, 8, 0, 18.8, 19.3),
    ('lasso_90x60', 90, 60, 4, 0, 14.9, 16.7),
    ('lasso_90x60', 90, 60, 8, 0, 19.9, 21.5),
    ('lasso_100x70', 100, 70, 4, 0, 14.8, 16.7),
    ('lasso_100x70', 100, 70, 8, 0, 19.8, 21.4),
    ('lasso_120x80', 120, 80, 4, 0, 15.0, 16.9),
    ('lasso_120x80', 120, 80, 8, 0, 20.2, 21.8),
    ('lasso_200x120', 200, 120, 4, 0, 15.1, 17.1),
    ('lasso_200x120', 200, 120, 8, 0, 18.7, 20.9),
    ('lasso_300x200', 300, 200, 4, 0, 15.9, 17.8),
    ('lasso_300x200', 300, 200, 8, 0, 19.4, 21.3),
    ('lasso_500x300', 500, 300, 4, 0, 16.5, 18.3),
    ('lasso_500x300', 500, 300, 8, 0, 20.3, 21.9),
    ('lasso_300x500', 300, 500, 4, 0, 17.2, 18.6),
    ('lasso_300x500', 300, 500, 8, 0, 20.4, 22.0),
    ('lasso_1000x600', 1000, 600, 4, 0, 16.3, 19.3),
    ('lasso_1000x600', 1000, 600, 8, 0, 19.2, 23.6),
    ('lasso_2000x1000', 2000, 1000, 4, 0, 20.6, 22.7),
    ('lasso_3000x1500', 3000, 1500, 4, 0, 34.7, 35.9),
    ('lasso_5000x2500', 5000, 2500, 4, 0, 68.3, 67.5),
    ('lasso_2500x5000', 2500, 5000, 4, 0, 69.1, 66.7),
    ('logistic_400x200', 400, 200, 4, 400, 18.6, 20.1),
    ('logistic_600x300', 600, 300, 4, 600, 22.2, 21.4),
    ('logistic_1000x500', 1000, 500, 4, 1000, 23.2, 21.6),
    ('logistic_2000x1000', 2000, 1000, 4, 2000, 35.1, 26.0),
]


# The one pass's route table: µs per iteration on the plan's grid on the one
# pass and on the plain products (chip_smoke.py::admm_route_table, 200
# iterations at tolerance 0, two runs each; an NVIDIA H100 80GB HBM3, 700 W).
_ONE_PASS_TABLE = [
    ('lasso_5000x2500', 5000, 2500, 4, 66.3, 67.2),
    ('lasso_6000x3000', 6000, 3000, 4, 79.0, 85.5),
    ('lasso_8000x4000', 8000, 4000, 4, 106.5, 132.5),
    ('lasso_10000x5000', 10000, 5000, 4, 137.2, 193.9),
    ('lasso_20000x2000', 20000, 2000, 4, 156.3, 143.1),
    ('lasso_20000x2500', 20000, 2500, 4, 162.2, 173.0),
    ('lasso_5000x2500', 5000, 2500, 8, 141.6, 117.7),
    ('lasso_6000x3000', 6000, 3000, 8, 173.8, 156.6),
]


@pytest.mark.parametrize("case,m,n,itemsize,one_us,plain_us", _ONE_PASS_TABLE,
                         ids=[f"{r[0]}-f{8 * r[3]}" for r in _ONE_PASS_TABLE])
def test_plan_picks_the_faster_route(case, m, n, itemsize, one_us, plain_us):
    """At every measured size the plan's route (the one pass or the plain
    products) is within 5% of the faster; it takes the one pass wherever
    that saves more than 5%."""
    plan = pf.admm_plan(m, n, itemsize, 132, 132)
    us = one_us if plan["one_pass"] else plain_us
    assert us <= 1.05 * min(one_us, plain_us)
    assert plan["one_pass"] or one_us > 0.95 * plain_us


@pytest.mark.parametrize("case,m,n,itemsize,us", _ROUTE_TABLE,
                         ids=[f"{r[0]}-f{8 * r[3]}" for r in _ROUTE_TABLE])
def test_plan_picks_a_fast_grid(case, m, n, itemsize, us):
    """At every measured size the plan's grid (on 132 SMs) is one of the
    measured grids and within 5% of the fastest."""
    blocks = pf.admm_plan(m, n, itemsize, 132, 132)["blocks"]
    assert blocks in _ROUTE_GRIDS
    assert us[_ROUTE_GRIDS.index(blocks)] <= 1.05 * min(us)


@pytest.mark.parametrize("case,m,n,itemsize,iterative,shared_us,four_us", _SHARED_TABLE,
                         ids=[f"{r[0]}-f{8 * r[3]}" for r in _SHARED_TABLE])
def test_plan_picks_a_fast_barrier_order(case, m, n, itemsize, iterative, shared_us, four_us):
    """At every measured size the plan's order (the shared side and 3
    barriers, or 4) is within 5% of the faster one; every lasso runs 3."""
    plan = pf.admm_plan(m, n, itemsize, 132, 132, iterative)
    us = shared_us if plan["shared_side"] else four_us
    assert us <= 1.05 * min(shared_us, four_us)
    if not iterative:
        assert plan["barriers_per_iter"] == 3


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", [(500, 300), (5000, 2500), (20000, 5000), (2500, 5000),
                                 (100000, 50)])
def test_plan_shared_memory(m, n, itemsize):
    """At most the 232,448 bytes a block may use (SMEM_BUDGET leaves room
    for the kernel's static arrays), the staging buffer in whole 16-byte
    units, and with the shared side the whole side staged and kept."""
    plan = pf.admm_plan(m, n, itemsize, 132, 132)
    per = 16 // itemsize
    assert 0 < plan["smem"] <= pf.SMEM_BUDGET < 232_448
    assert plan["xs"] % per == 0 and plan["xs"] >= per
    side = -(-max(m, n) // per) * per
    if plan["shared_side"]:
        assert plan["xs"] >= side
        assert plan["smem"] >= (9 * side + plan["xs"]) * itemsize


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("m,n", _SIZES)
def test_plan_shared_memory_layout(m, n, itemsize):
    """The plan's shared memory is its parts: the staging buffer, the
    shared side (9 vectors of its length: state and prox parameters) and the
    one pass's ring; the owned elements' state is in global memory.  The
    staging buffer holds both vectors of the exact residuals wherever they
    fit beside the rest."""
    for sms in (132, 8):
        plan = pf.admm_plan(m, n, itemsize, sms, sms)
        parts = 9 * _rnd(max(m, n), itemsize) if plan["shared_side"] else 0
        parts += plan["ring"]
        assert plan["smem"] == (plan["xs"] + parts) * itemsize
        pair = _rnd(m, itemsize) + _rnd(n, itemsize)
        assert (plan["xs"] == pair) == ((parts + pair) * itemsize <= pf.SMEM_BUDGET)


def test_plan_owned_state_in_global_memory_where_it_does_not_fit():
    """A problem too large for shared memory still runs: the owned
    elements' state is in global memory at any size, the shared side is
    off, and the staging buffer takes column tiles."""
    plan = pf.admm_plan(2_000_000, 20, 8, 132, 132)
    assert set(plan) == {"blocks", "threads", "shared_side", "one_pass", "ring", "xs", "smem",
                         "barriers_per_iter", "barriers_per_check", "slots_per_iter",
                         "slots_per_check", "passes_per_iter"}
    assert not plan["shared_side"] and plan["barriers_per_iter"] == 4
    assert plan["xs"] * 8 == plan["smem"] <= pf.SMEM_BUDGET
    assert plan["xs"] < 2_000_020


def test_plan_barriers_and_the_logistic_rule():
    """3 barriers per ordinary iteration where every block computes the
    first product's side itself, 4 where that side has more iterative
    proxes than a block has threads or does not fit in shared memory, and 3
    on the one pass (a tall A beyond ONE_PASS_BYTES), whose side is never
    shared; one more on an iteration near tolerance.  12 slots reduced per
    iteration, 2 per check."""
    assert pf.iterative_count([P.Function.LOGISTIC] * 5 + [P.Function.SQUARE] * 3
                              + [P.Function.EXP, P.Function.NEGENTR, P.Function.ABS]) == 7
    for m, n, iterative, bars in ((500, 300, 0, 3), (300, 500, 0, 3), (200, 100, 200, 3),
                                  (2000, 1000, 2000, 4), (2000, 1000, pf.THREADS, 3),
                                  (2000, 1000, pf.THREADS + 1, 4), (20000, 5000, 0, 3),
                                  (2048, 1000, 0, 3), (2049, 1000, 0, 3), (1000, 2049, 0, 3),
                                  (5000, 2500, 0, 3), (2500, 5000, 0, 3), (5400, 10, 0, 3),
                                  (5800, 10, 0, 4), (10, 5800, 0, 4)):
        plan = pf.admm_plan(m, n, 4, 132, 132, iterative)
        assert plan["barriers_per_iter"] == bars
        assert plan["one_pass"] == pf.one_pass_for(m, n, 4, iterative)
        assert plan["shared_side"] == (bars == 3 and not plan["one_pass"])
        assert plan["barriers_per_check"] == 1
        assert plan["slots_per_iter"] == 12 and plan["slots_per_check"] == 2
    slots = re.search(r"enum Slot \{(.*?)\};", _kernel_source(), re.S).group(1)
    names = [t.split("=")[0].strip() for t in re.sub(r"//[^\n]*", "", slots).split(",")
             if t.strip()]
    assert names.index("S_R2") == 12 and names.index("S_OPT") - names.index("S_R2") == 2


def test_kernel_barriers_in_the_source():
    """The kernel's loop, counted in its source: one barrier before the
    first product only without the shared side, two between the three
    products (tall and wide alike), one after them, one more after the
    exact residuals; the sums of one block need no barrier."""
    src = _kernel_source()
    loop = src.split("for (;;) {")[1].split("// --- Exit")[0]
    prox, rest = loop.split("// --- The projection")
    assert prox.count("grid_sync(grid)") == 1
    assert re.search(r"if \(!shared_side\) \{\s*grid_sync\(grid\);\s*\}", prox)
    tall, wide = rest.split("} else {", 1)
    assert tall.count("grid_sync(grid)") == 2
    wide_part, after = wide.split("partial(v, iter_partials, S_DY_PREV);", 1)
    assert wide_part.count("grid_sync(grid)") == 2
    scalars, exact = after.split("if (near) {", 1)
    assert scalars.count("grid_sync(grid)") == 1
    assert re.search(r"if \(G > 1\) \{\s*grid_sync\(grid\);", scalars)
    assert exact.split("bool conv_now")[0].count("grid_sync(grid)") == 1
    assert "warp_dot" not in src
    assert "warp_dot" not in open(os.path.join(ROOT, "pogs_tpu_torch", "csrc",
                                               "coop.cuh")).read()


@pytest.mark.parametrize("m,n", [(2000, 1000), (200, 100)])
def test_launch_plan_counts_the_first_products_side(m, n):
    """launch_plan's count of iterative proxes is of the side the first
    product reads: f's (m) for a tall A, g's (n) for a wide one."""
    h_f = np.full(m, int(P.Function.LOGISTIC), np.int32)
    h_g = np.full(n, int(P.Function.ABS), np.int32)
    tall = pf.admm_plan(m, n, 4, 132, 132, pf.iterative_count(h_f))
    wide = pf.admm_plan(n, m, 4, 132, 132, pf.iterative_count(h_f))
    assert tall["shared_side"] == (m <= pf.THREADS)
    assert wide["shared_side"] == (m <= pf.THREADS)
    assert pf.admm_plan(n, m, 4, 132, 132, pf.iterative_count(h_g))["shared_side"]


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
def test_plan_one_pass_route_by_shape(itemsize, monkeypatch):
    """The one pass where a tall f32 A and Ginv lie beyond ONE_PASS_BYTES
    with rows of at least ONE_PASS_MIN_N and no iterative prox in f; the
    plain products below it (in L2), for a wide A, for short rows, for a
    logistic f, for f64, where the candidates' partial sums would not fit in
    registers (n > PASS_COLS * THREADS), and in f64 even where forced (the
    kernel's one pass is built for f32 alone); where forced in f32, the ring
    (PASS_STAGES steps of PASS_ROWS rows, then each of a block's rows'
    state) after the staged x."""
    per = 16 // itemsize
    for m, n in ((10000, 5000), (6000, 3000), (20000, 5000), (8000, 4000), (20000, 2500)):
        assert pf.admm_plan(m, n, itemsize, 132, 132)["one_pass"] == (itemsize == 4)
    monkeypatch.setattr(pf, "one_pass_for", lambda m, n, itemsize, iterative=0: True)
    for m, n in ((10000, 5000), (6000, 3000), (20000, 5000), (8000, 4000), (20000, 2500)):
        if itemsize == 8:
            assert not pf.admm_plan(m, n, itemsize, 132, 132)["one_pass"]
            continue
        plan = pf.admm_plan(m, n, itemsize, 132, 132)
        assert plan["one_pass"] and not plan["shared_side"]
        rows = -(-m // plan["blocks"])
        ring = (pf.PASS_STAGES * pf.PASS_ROWS * (_rnd(n, itemsize) + per)
                + _rnd(rows * pf.PASS_ROW_STATE, itemsize))
        assert plan["ring"] == max(ring, pf.THREADS)
        assert plan["xs"] >= _rnd(n, itemsize)
        assert plan["smem"] == (plan["xs"] + plan["ring"]) * itemsize <= pf.SMEM_BUDGET
    monkeypatch.undo()
    logistic = pf.admm_plan(10000, 5000, 4, 132, 132, 10000)
    assert not logistic["one_pass"] and logistic["ring"] == 0
    for m, n in ((500, 300), (2000, 1000), (2500, 5000), (5000, 10000), (100000, 50),
                 (20000, 2000), (30000, 1000), (20000, 6000),
                 (10000, pf.PASS_COLS * pf.THREADS + 1)):
        plan = pf.admm_plan(m, n, itemsize, 132, 132)
        assert not plan["one_pass"] and plan["ring"] == 0
        assert plan["passes_per_iter"] == 2
    assert pf.one_pass_for(100000, pf.ONE_PASS_MIN_N, 4)
    assert not pf.one_pass_for(100000, pf.ONE_PASS_MIN_N - 1, 4)
    assert pf.one_pass_for(20000, 2500, 4) and not pf.one_pass_for(20000, 2500, 8)
    assert not pf.one_pass_for(2500, 20000, 4)
    assert not pf.one_pass_for(5000, 2500, 4) and pf.one_pass_for(6000, 3000, 4)


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
def test_plan_one_pass_counts(itemsize, monkeypatch):
    """The one pass's barriers and slots: 3 barriers an ordinary iteration
    (commit and rhs, Ginv rhs, the pass), one more near tolerance, the same
    12 and 2 slots as the plain route, and one pass over A an iteration
    against two; the plan, like every plan, a function of the problem.  In
    f64, even forced onto it, the plan is the plain route's."""
    m, n = 10000, 5000
    if itemsize == 8:
        plain = pf.admm_plan(m, n, itemsize, 132, 132)
        monkeypatch.setattr(pf, "one_pass_for", lambda m, n, itemsize, iterative=0: True)
        assert pf.admm_plan(m, n, itemsize, 132, 132) == plain
        assert not plain["one_pass"] and plain["passes_per_iter"] == 2
        return
    plan = pf.admm_plan(m, n, itemsize, 132, 132)
    assert plan["one_pass"] and plan["blocks"] == 132
    assert (plan["barriers_per_iter"], plan["barriers_per_check"]) == (3, 1)
    assert (plan["slots_per_iter"], plan["slots_per_check"]) == (12, 2)
    assert plan["passes_per_iter"] == 1
    pf.admm_plan(500, 300, itemsize, 132, 132)
    pf.admm_plan(n, m, itemsize, 132, 132, m)
    assert pf.admm_plan(m, n, itemsize, 132, 132) == plan
    slim = pf.admm_plan(m, n, itemsize, 132, 66)
    assert slim["blocks"] == 66 and slim["one_pass"]


def test_kernel_one_pass_in_the_source():
    """The one pass in the kernel's source: its constants are the plan's,
    the plain A^T product is skipped only where the last pass holds the
    step's candidate, and the rho step picks the candidate (no float
    atomics anywhere), for float alone."""
    src = _kernel_source()
    assert re.search(r"constexpr int kPassRows = %d;" % pf.PASS_ROWS, src)
    assert re.search(r"constexpr int kRowState = %d;" % pf.PASS_ROW_STATE, src)
    assert re.search(r"constexpr int kStages = %d;" % pf.PASS_STAGES, src)
    assert re.search(r"constexpr int kCols = %d;" % pf.PASS_COLS, src)
    loop = src.split("for (;;) {")[1].split("// --- Exit")[0]
    assert "const bool commit = kPass && cand >= 0;" in loop
    assert re.search(r"if \(!commit\) \{\s*mv\(C\.At,", loop)
    assert "if (kPass) one_pass(v);" in loop
    assert "cand = kPass && step != kRhoSpectral ? step : -1;" in loop
    assert "atomicAdd" not in src
    # the one pass is instantiated for float alone; the stats end with
    # a_passes and checks
    assert "if constexpr (sizeof(T) == 4)" in src.split("const void* kernel_of(")[1]
    assert "st[9] = T(passes);" in src and "st[10] = T(checks);" in src
    assert pf.STATS == 11
    prox = open(os.path.join(ROOT, "pogs_tpu_torch", "csrc", "prox.cuh")).read()
    assert re.search(r"enum RhoStep \{ kRhoKeep = 0, kRhoUp = 1, kRhoDown = 2, "
                     r"kRhoSpectral = 3 \};", prox)
