"""K graph-form ADMM solves as ONE hand-written CUDA kernel: λ-sweeps and
multi-right-hand-side fits that share A, f and g.

Counterpart of ``pogs_tpu/ops/fused_admm_batch.py::fused_batched_lasso_sweep``.
Lane k solves the problem with g.c replaced by ``c_batch[k]`` (a λ-sweep)
and, optionally, f.b replaced by ``fb_batch[k]`` (multi-RHS).  Two
hand-written kernels compute it, and :func:`route_for` picks one by the
first one's plan:

  * ``csrc/fused_admm_batch.cu`` runs each chunk of Kc lanes
    (:func:`chunk_for`) on one thread block cluster that holds A's and
    Ginv's row slices in its blocks' shared memory (:func:`cluster_plan`:
    C blocks, C picked by m, n and the dtype, never by K) for the whole
    while-loop; it takes every sweep whose slices sit in shared memory or,
    read from L2, stay within ``GLOBAL_SLICE_BYTES`` a block;
  * ``csrc/fused_admm_sweep.cu`` runs one cooperative grid that streams
    each matrix once per iteration for 32 lanes at a time, its products
    split over every SM (:func:`sweep_plan`); it takes the rest.

Their source notes say what bounds them on the card and what the designs do
about it.

``fused_batched_lasso_sweep`` takes the same arguments and returns the same
dict as the JAX function:

  * on a CUDA tensor it launches the kernel or raises — there is no fallback;
  * on a CPU tensor it runs the plain version,
    :func:`fused_batched_lasso_sweep_ref`, an eager loop over (K, ·) tensors.

``fused_batched_lasso_sweep.launches`` counts kernel launches, and
``fused_batched_lasso_sweep.launches_by_route`` counts them by kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from pogs_tpu_torch.types import FunctionVector, SolverSettings, Status
from pogs_tpu_torch.prox.scalar import FUNC
from pogs_tpu_torch.prox.vector import _dispatch, prox_eval
from pogs_tpu_torch.ops.fused_admm import _fv, fused_admm_supported
from pogs_tpu_torch.solver.admm import (
    DONE_CHECK_EVERY, K_DELTA_MIN, rho_schedule, rho_schedule_constants,
)

_DTYPES = (torch.float32, torch.float64)
_SLOTS: dict = {}
# Lanes per cluster the resident kernel is built for (Kc).
LANE_CHUNKS = (1, 2, 4, 8)


def _sum2(v):
    """Per-lane sum of squares: (K, d) -> (K, 1)."""
    return torch.sum(v * v, dim=1, keepdim=True)


def _nrm(v):
    """Per-lane 2-norm: (K, d) -> (K, 1)."""
    return torch.sqrt(_sum2(v))


def _dot(u, v):
    return torch.sum(u * v, dim=1, keepdim=True)


def _feval(fv: FunctionVector, x):
    """Per-lane objective: (K, d) -> (K, 1); parameters broadcast per lane."""
    a, b, c, d, e = fv.params
    hval = _dispatch(FUNC, fv.h, a * x - b)
    return torch.sum(c * hval + d * x + 0.5 * e * x * x, dim=1, keepdim=True)


def _lane_inputs(A, h_f, f_params, h_g, g_params, c_batch, fb_batch):
    """The (K, ·) view of the objective: g with the lanes' c, f with the
    lanes' b when given."""
    dt, dev = A.dtype, A.device
    m, n = A.shape

    def vec(v, length):
        t = torch.as_tensor(v, dtype=dt, device=dev)
        if tuple(t.shape) != (length,):
            raise ValueError(f"a parameter of shape {tuple(t.shape)}, expected ({length},)")
        return t

    fa, fb, fc, fd, fe = (vec(p, m) for p in f_params)
    ga, gb, _, gd, ge = (vec(p, n) for p in g_params)
    cb = torch.as_tensor(c_batch, dtype=dt, device=dev)
    if cb.dim() != 2 or cb.shape[1] != n or cb.shape[0] < 1:
        raise ValueError(f"c_batch has shape {tuple(cb.shape)}, expected (K, {n})")
    if fb_batch is not None:
        fb = torch.as_tensor(fb_batch, dtype=dt, device=dev)
        if tuple(fb.shape) != (cb.shape[0], m):
            raise ValueError(f"fb_batch has shape {tuple(fb.shape)}, "
                             f"expected {(cb.shape[0], m)}")
    return (_fv(h_f, (fa, fb, fc, fd, fe)), _fv(h_g, (ga, gb, cb, gd, ge)))


def fused_batched_lasso_sweep_ref(A, Ginv, norm_A, h_f, f_params, h_g, g_params,
                                  c_batch, settings: SolverSettings, rho0,
                                  fb_batch=None):
    """The kernel's plain version: every lane's ADMM iteration, as (K, ·)
    tensors, in an eager loop.

    Per lane, as the single solve: the prox with the lane's c (and b), the
    gap and tolerances, the projection as one product per phase for all
    lanes, both residual branches with the per-lane ``near`` select, the
    per-lane ρ schedule, and the monotone done / converged / NaN latches.
    x12, y12 and optval are latched at each lane's firing iteration.  Once
    a lane is done its whole state freezes.  The host reads "all lanes
    done" every ``DONE_CHECK_EVERY`` iterations.
    """
    m, n = A.shape
    dt, dev = A.dtype, A.device
    f_l, g_l = _lane_inputs(A, h_f, f_params, h_g, g_params, c_batch, fb_batch)
    K = g_l.c.shape[0]
    tall = m >= n
    At = A.T
    Ginv = torch.as_tensor(Ginv, dtype=dt, device=dev)

    def T(v):
        return torch.as_tensor(v, dtype=dt, device=dev)

    one, alpha = T(1.0), T(1.7)
    abs_tol, rel_tol = T(settings.abs_tol), T(settings.rel_tol)
    sqrtn_atol = torch.sqrt(T(n)) * abs_tol
    sqrtm_atol = torch.sqrt(T(m)) * abs_tol
    sqrtmn_atol = torch.sqrt(T(m + n)) * abs_tol
    norm_A = T(norm_A)
    sched = rho_schedule_constants(dt, dev)
    max_iter = settings.max_iter

    def project(x0, y0):
        if tall:
            x = (x0 + y0 @ A) @ Ginv
            return x, x @ At
        w = (x0 @ At - y0) @ Ginv
        return x0 - w @ A, y0 + w

    def body(st):
        zx, zy, ztx, zty, rho = st["zx"], st["zy"], st["ztx"], st["zty"], st["rho"]
        zin_x, zin_y = zx - ztx, zy - zty
        x12 = prox_eval(g_l, zin_x, rho)
        y12 = prox_eval(f_l, zin_y, rho)
        zmx, zmy = zin_x - x12, zin_y - y12
        gap = torch.abs(_dot(zmx, x12) + _dot(zmy, y12))
        eps_gap = sqrtmn_atol + rel_tol * (
            torch.sqrt(_sum2(zmx) + _sum2(zmy)) * torch.sqrt(_sum2(x12) + _sum2(y12)))
        eps_pri = sqrtm_atol + rel_tol * _nrm(y12)
        eps_dua = rho * (sqrtn_atol + rel_tol * _nrm(zmx))

        zor_x = ztx + alpha * x12 + (one - alpha) * zx
        zor_y = zty + alpha * y12 + (one - alpha) * zy
        zx_new, zy_new = project(zor_x, zor_y)

        nrm_s_a = rho * (norm_A * _nrm(zy - zy_new) + _nrm(zx - zx_new))
        nrm_r_a = norm_A * _nrm(x12 - zx_new) + _nrm(y12 - zy_new)
        near = (nrm_r_a < 10 * eps_pri) & (nrm_s_a < 10 * eps_dua)
        r_vec = x12 @ At - y12
        s_vec = (y12 + zty - zy) @ A + (x12 + ztx - zx)
        nrm_r = torch.where(near, _nrm(r_vec), nrm_r_a)
        nrm_s = torch.where(near, rho * _nrm(s_vec), nrm_s_a)

        converged = near & (nrm_r < eps_pri) & (nrm_s < eps_dua)
        if settings.gap_stop:
            converged = converged & (gap < eps_gap)
        nan_found = ~(torch.isfinite(nrm_r) & torch.isfinite(
            torch.sum(zx_new, 1, keepdim=True) + torch.sum(zy_new, 1, keepdim=True)))
        k = st["k"]
        done = st["done"] | converged | nan_found | (k >= max_iter - 1)

        ztx_new = ztx + alpha * x12 + (one - alpha) * zx - zx_new
        zty_new = zty + alpha * y12 + (one - alpha) * zy - zy_new
        rho_new, delta_new, xi_new, kd_new, ku_new = (
            rho, st["delta"], st["xi"], st["kd"], st["ku"])
        if settings.adaptive_rho:
            rho_new, zt_scale, delta_new, xi_new, kd_new, ku_new = rho_schedule(
                k, rho, st["delta"], st["xi"], st["kd"], st["ku"],
                nrm_r, nrm_s, eps_pri, eps_dua, **sched)
            ztx_new = ztx_new * zt_scale
            zty_new = zty_new * zt_scale

        optval = _feval(f_l, y12) + _feval(g_l, x12)

        # A firing lane keeps its z̃ and ρ (the solve breaks before those
        # updates) and latches its iterate, objective and status.
        def sel(new, old):
            return torch.where(done, old, new)

        return {
            "zx": zx_new, "zy": zy_new,
            "ztx": sel(ztx_new, ztx), "zty": sel(zty_new, zty),
            "rho": sel(rho_new, rho), "delta": sel(delta_new, st["delta"]),
            "xi": sel(xi_new, st["xi"]), "kd": sel(kd_new, st["kd"]),
            "ku": sel(ku_new, st["ku"]),
            "k": torch.where(done, k, k + 1),
            "done": done, "converged": converged, "nan_found": nan_found,
            "x12": x12, "y12": y12, "optval": optval,
        }

    def zeros(d, dtype=dt):
        return torch.zeros((K, d), dtype=dtype, device=dev)

    false = zeros(1, torch.bool)
    st = {
        "zx": zeros(n), "zy": zeros(m), "ztx": zeros(n), "zty": zeros(m),
        "rho": torch.full((K, 1), float(rho0), dtype=dt, device=dev),
        "delta": torch.full((K, 1), K_DELTA_MIN, dtype=dt, device=dev),
        "xi": torch.ones((K, 1), dtype=dt, device=dev),
        "kd": zeros(1), "ku": zeros(1), "k": zeros(1, torch.int32),
        "done": false, "converged": false, "nan_found": false,
        "x12": zeros(n), "y12": zeros(m), "optval": zeros(1),
    }
    for it in range(max_iter):
        new = body(st)
        was_done = st["done"]
        st = {key: torch.where(was_done, st[key], val) for key, val in new.items()}
        if (it + 1) % DONE_CHECK_EVERY == 0 and bool(torch.all(st["done"])):
            break

    status = torch.where(
        st["converged"], Status.SUCCESS.value,
        torch.where(st["nan_found"], Status.NAN_FOUND.value, Status.MAX_ITER.value),
    ).to(torch.int32)
    return {
        "x12": st["x12"],
        "y12": st["y12"],
        "optval": st["optval"][:, 0],
        "final_iter": st["k"][:, 0],
        "status": status[:, 0],
        "rho": st["rho"][:, 0],
    }


def chunk_for(K: int, clusters: int) -> int:
    """Lanes per cluster of the resident kernel: the smallest of
    ``LANE_CHUNKS`` whose ⌈K / Kc⌉ clusters all fit the card at once
    (``clusters``: the plan's clusters the device holds, by
    ``cudaOccupancyMaxActiveClusters``); 8 when none does.

    A cluster holds A's and Ginv's slices once and applies each element to
    all its lanes, so more clusters finish sooner only while they fit one
    wave; and fewer lanes per cluster wait less for their slowest lane.  A
    lane's results do not depend on the choice."""
    for kc in LANE_CHUNKS:
        if -(-K // kc) <= clusters:
            return kc
    return LANE_CHUNKS[-1]


# The resident kernel's decomposition (csrc/fused_admm_batch.cu, which
# reports its plan through pogs_batch_cluster_plan; _checked_plan holds the
# two together before a shape's first launch).
CLUSTER_SIZES = (1, 2, 4, 8, 16)   # thread blocks per cluster; above 8 non-portable
SMEM_LIMIT = 232_448               # dynamic shared memory a Hopper block may use
PLAN_LANES = 8                     # lane stride of a staged vector: Kc <= 8
_WARPS = 8                         # 256 threads a block
_SCRATCH = _WARPS * 32 * PLAN_LANES
_STATE = 5 + 2                     # per owned element: 5 state vectors, 2 exchanged
_SMALL_ELEMS = 784                 # per-lane sums, scalars and warp sums
_SMALL_INTS = 5 * PLAN_LANES


def _al4(x: int) -> int:
    return (x + 3) & ~3


def cluster_layout(m: int, n: int, itemsize: int, C: int, in_smem: bool = True) -> dict:
    """The resident kernel's layout on clusters of ``C`` blocks: block r
    owns rows [r·HA, (r+1)·HA) of A, elements [r·HX, (r+1)·HX) of x, and
    the matching HG rows of Ginv (x's when tall, y's when wide); with
    ``in_smem`` its slices of A and Ginv sit in its shared memory (odd row
    strides), else it reads them from global memory.  ``smem`` counts the
    bytes of dynamic shared memory: the slices, three (n, 8) staged vectors
    (a gathered input, two sets of Aᵀ partials), per owned element the 8
    lanes' state (z, z̃, prox value, projection input, projected iterate),
    two exchanged vectors and the prox parameters, a product's split
    partials and the per-lane sums and scalars."""
    k = min(m, n)
    HA, HX = -(-m // C), -(-n // C)
    HG = HX if m >= n else HA
    slices = _al4(HA * (n | 1)) + _al4(HG * (k | 1)) if in_smem else 0
    owned = HA + HX
    elems = (slices + 3 * n * PLAN_LANES + _STATE * owned * PLAN_LANES + _SCRATCH
             + _SMALL_ELEMS + owned * (5 + PLAN_LANES))
    return {"C": C, "in_smem": bool(in_smem), "HA": HA, "HX": HX, "HG": HG,
            "smem": elems * itemsize + 4 * (_SMALL_INTS + owned)}


def cluster_plan(m: int, n: int, itemsize: int) -> Optional[dict]:
    """The resident kernel's plan for an (m, n) A: the smallest cluster size
    of ``CLUSTER_SIZES`` whose row slices of A and Ginv, with the vector
    staging for 8 lanes, fit ``SMEM_LIMIT`` bytes of shared memory; where
    none does, the largest, with its slices read from global memory; None
    when even that staging does not fit.  It depends on m, n and the dtype
    alone, never on K, so a lane's arithmetic does not depend on the lanes
    that ride with it."""
    for C in CLUSTER_SIZES:
        plan = cluster_layout(m, n, itemsize, C, True)
        if plan["smem"] <= SMEM_LIMIT:
            return plan
    plan = cluster_layout(m, n, itemsize, CLUSTER_SIZES[-1], False)
    return plan if plan["smem"] <= SMEM_LIMIT else None


# The rule as defined here, which _checked_plan holds the kernel's twin to
# even where a test or chip_smoke.py forces another plan.
_RULE = cluster_plan

# On the global-memory plan a block reads its slices of A and Ginv from L2
# every iteration; beyond this many bytes a block, the streaming kernel was
# the faster (chip_smoke.py phase 7's route table, PERF.md §6: 242 KB at
# 1000x600 f32 the resident kernel, 960 KB at 2000x1200 the streaming one).
GLOBAL_SLICE_BYTES = 512 * 1024
# The streaming kernel's decomposition (csrc/fused_admm_sweep.cu, which
# reports its own through pogs_sweep_constants; sweep_grid checks that the
# two agree before the first launch).
SWEEP_LANES = 32            # lanes in flight: a larger K runs in groups of 32
SWEEP_ROWS_PER_STAGE = 16   # matrix rows per ring stage
SWEEP_STAGES = 4            # ring stages (cp.async, 16 bytes a copy)


def route_for(m: int, n: int, itemsize: int, K: int) -> str:
    """Which of the two batched kernels runs a sweep of K lanes over an
    (m, n) A.

    ``"resident"`` (``csrc/fused_admm_batch.cu``: a cluster of thread
    blocks per chunk of lanes, no grid sync) when its plan holds A's and
    Ginv's row slices in the cluster's shared memory, or reads them from
    L2 with at most ``GLOBAL_SLICE_BYTES`` a block.  Otherwise
    ``"stream"`` (``csrc/fused_admm_sweep.cu``: one cooperative grid that
    streams each matrix once per iteration, 32 lanes at a time), and so for
    every problem beyond the 50 MB L2, where a block of 16 would hold more
    than 1.6 MB of slices.  chip_smoke.py phase 7's route table (PERF.md
    §6) set it; K does not enter."""
    plan = cluster_plan(m, n, itemsize)
    if plan is None:
        return "stream"
    slice_bytes = itemsize * (plan["HA"] * n + plan["HG"] * min(m, n))
    return "resident" if plan["in_smem"] or slice_bytes <= GLOBAL_SLICE_BYTES else "stream"


def sweep_tile_cols(itemsize: int) -> int:
    """Columns of a product tile: 64 column groups of one 16-byte load."""
    return 64 * (16 // itemsize)


def sweep_smem_bytes(itemsize: int) -> int:
    """Dynamic shared memory of the ring: each stage holds a tile's rows of
    the matrix and the same rows of the 32 lane vectors."""
    return (SWEEP_STAGES * SWEEP_ROWS_PER_STAGE
            * (sweep_tile_cols(itemsize) + SWEEP_LANES) * itemsize)


def slice_rows(R: int, C: int, itemsize: int, grid: int) -> int:
    """Rows per row slice (split-K) of a product over an (R, C) matrix: as
    many slices as the column tiles leave room for on a grid of ``grid``
    blocks, each a whole number of ring stages."""
    col_tiles = -(-C // sweep_tile_cols(itemsize))
    slices = max(1, grid // col_tiles)
    rows = -(-R // slices)
    return -(-rows // SWEEP_ROWS_PER_STAGE) * SWEEP_ROWS_PER_STAGE


def sweep_plan(m: int, n: int, itemsize: int, grid: int) -> tuple:
    """The streaming kernel's row-slice heights for its products over A
    (m, n), Aᵀ (n, m) and Ginv (k, k) on a grid of ``grid`` blocks; the
    kernel derives the rest.  They depend on m, n, the dtype and the grid
    alone, never on K, so a lane's arithmetic does not depend on the lanes
    that ride with it."""
    k = min(m, n)
    return tuple(slice_rows(R, C, itemsize, grid) for R, C in ((m, n), (n, m), (k, k)))


def _lib():
    from pogs_tpu_torch.ops._build import load

    lib = load("fused_admm_batch")
    if not getattr(lib, "_pogs_typed", False):
        vp, ci, cd, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
        lib.pogs_batch_sweep.argtypes = ([ci, ci] + [vp] * 12
                                         + [ci] * 6 + [cd, cd, ci, ci, ci, vp])
        lib.pogs_batch_sweep.restype = ci
        lib.pogs_batch_cluster_plan.argtypes = [ci] * 5 + [ctypes.POINTER(cll)]
        lib.pogs_batch_cluster_plan.restype = None
        lib.pogs_batch_max_clusters.argtypes = [ci] * 6 + [ctypes.POINTER(ci)]
        lib.pogs_batch_max_clusters.restype = ci
        lib.pogs_batch_error_string.argtypes = [ci]
        lib.pogs_batch_error_string.restype = ctypes.c_char_p
        lib._pogs_error = lib.pogs_batch_error_string
        lib._pogs_typed = True
    return lib


def _sweep_lib():
    from pogs_tpu_torch.ops._build import load

    lib = load("fused_admm_sweep")
    if not getattr(lib, "_pogs_typed", False):
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.pogs_sweep.argtypes = ([ci, ci] + [vp] * 14 + [ci] * 9
                                   + [cd, cd, ci, ci, ci, ci, vp])
        lib.pogs_sweep.restype = ci
        lib.pogs_sweep_grid.argtypes = [ci, ci, ctypes.POINTER(ci)]
        lib.pogs_sweep_grid.restype = ci
        lib.pogs_sweep_work_elems.argtypes = [ci] * 6
        lib.pogs_sweep_work_elems.restype = ctypes.c_longlong
        lib.pogs_sweep_constants.argtypes = [ci, ctypes.POINTER(ctypes.c_longlong)]
        lib.pogs_sweep_constants.restype = None
        lib.pogs_sweep_error_string.argtypes = [ci]
        lib.pogs_sweep_error_string.restype = ctypes.c_char_p
        lib._pogs_error = lib.pogs_sweep_error_string
        lib._pogs_typed = True
    return lib


def _check(lib, rc: int, what: str):
    if rc != 0:
        msg = lib._pogs_error(rc).decode()
        raise RuntimeError(f"batched ADMM kernel: {what} failed: {msg} ({rc})")


def _twin_plan(lib, m: int, n: int, itemsize: int, C: int, in_smem: bool) -> Optional[dict]:
    """The kernel's own plan (C = 0: its rule), in cluster_layout's form."""
    out = (ctypes.c_longlong * 6)()
    lib.pogs_batch_cluster_plan(int(itemsize == 8), m, n, C, int(in_smem), out)
    if out[0] == 0:
        return None
    return {"C": out[0], "in_smem": bool(out[1]), "HA": out[2], "HX": out[3], "HG": out[4],
            "smem": out[5]}


def _checked_plan(lib, m: int, n: int, itemsize: int) -> dict:
    """``cluster_plan``'s plan for this shape, after checking (once per
    shape and plan) that the library was built with the same rule and
    computes the same layout for it."""
    plan = cluster_plan(m, n, itemsize)
    if plan is None:
        raise RuntimeError(f"batched ADMM kernel: no cluster plan fits shared memory "
                           f"for a {m}x{n} A ({itemsize}-byte elements)")
    key = ("plan", m, n, itemsize, plan["C"], plan["in_smem"])
    if key not in _SLOTS:
        rule, twin = _RULE(m, n, itemsize), _twin_plan(lib, m, n, itemsize, 0, True)
        if twin != rule:
            raise RuntimeError(f"resident batch kernel: the library's plan {twin} is not "
                               f"the wrapper's {rule}")
        twin = _twin_plan(lib, m, n, itemsize, plan["C"], plan["in_smem"])
        if twin != plan:
            raise RuntimeError(f"resident batch kernel: the library lays out {twin}, "
                               f"the wrapper {plan}")
        _SLOTS[key] = True
    return plan


def cluster_slots(lib, device: torch.device, is_double: bool, m: int, n: int,
                  plan: dict) -> int:
    """Clusters of ``plan`` the card holds at once (a cluster of 16 must
    fit one GPC); raises when none fits."""
    key = ("resident", device.index, is_double, plan["C"], plan["in_smem"], plan["smem"])
    if key not in _SLOTS:
        s = ctypes.c_int(0)
        _check(lib, lib.pogs_batch_max_clusters(int(is_double), device.index, m, n, plan["C"],
                                                int(plan["in_smem"]), ctypes.byref(s)),
               "occupancy query")
        if s.value < 1:
            raise RuntimeError(f"batched ADMM kernel: a cluster of {plan['C']} blocks with "
                               f"{plan['smem']} bytes of shared memory does not fit the card")
        _SLOTS[key] = s.value
    return _SLOTS[key]


def sweep_grid(lib, device: torch.device, is_double: bool) -> int:
    """Blocks of the streaming kernel's cooperative grid (one per SM); also
    checks that the library was built with the decomposition this module
    plans with."""
    key = ("stream", device.index, is_double)
    if key not in _SLOTS:
        consts = (ctypes.c_longlong * 5)()
        lib.pogs_sweep_constants(int(is_double), consts)
        itemsize = 8 if is_double else 4
        want = [SWEEP_LANES, sweep_tile_cols(itemsize), SWEEP_ROWS_PER_STAGE, SWEEP_STAGES,
                sweep_smem_bytes(itemsize)]
        if list(consts) != want:
            raise RuntimeError(f"streaming sweep kernel: the library's decomposition "
                               f"{list(consts)} is not the wrapper's {want}")
        g = ctypes.c_int(0)
        _check(lib, lib.pogs_sweep_grid(int(is_double), device.index, ctypes.byref(g)),
               "occupancy query")
        if g.value < 1:
            raise RuntimeError("streaming sweep kernel: a block does not fit on an SM")
        _SLOTS[key] = g.value
    return _SLOTS[key]


def _pad_cols(M: torch.Tensor, mult: int) -> torch.Tensor:
    """M with zero columns appended up to a multiple of ``mult`` (so that
    every row starts on 16 bytes), contiguous."""
    extra = -M.shape[1] % mult
    return torch.nn.functional.pad(M, (0, extra)).contiguous() if extra else M


def _lanes_inner(v: torch.Tensor, groups: int) -> torch.Tensor:
    """(K, d) per-lane rows as (groups, d, 32), lanes innermost; the lanes
    past K are zero."""
    K, d = v.shape
    out = torch.zeros((groups * SWEEP_LANES, d), dtype=v.dtype, device=v.device)
    out[:K] = v
    return out.reshape(groups, SWEEP_LANES, d).transpose(1, 2).contiguous()


def _run_resident(lib, A, At, Ginv, hf, fp, hg, gp, cb, fbb, scal, out, settings):
    m, n = A.shape
    K = cb.shape[0]
    dev, dt = A.device, A.dtype
    is_double = dt == torch.float64
    plan = _checked_plan(lib, m, n, A.element_size())
    kc = chunk_for(K, cluster_slots(lib, dev, is_double, m, n, plan))
    stream = torch.cuda.current_stream(dev).cuda_stream
    return lib.pogs_batch_sweep(
        int(is_double), dev.index,
        A.data_ptr(), Ginv.data_ptr(), hf.data_ptr(), fp.data_ptr(),
        hg.data_ptr(), gp.data_ptr(), cb.data_ptr(),
        fbb.data_ptr() if fbb is not None else None, scal.data_ptr(),
        out["x12"].data_ptr(), out["y12"].data_ptr(), out["stats"].data_ptr(),
        m, n, K, kc, plan["C"], int(plan["in_smem"]),
        float(settings.abs_tol), float(settings.rel_tol),
        int(settings.max_iter), int(bool(settings.gap_stop)),
        int(bool(settings.adaptive_rho)), stream,
    )


def _run_stream(lib, A, At, Ginv, hf, fp, hg, gp, cb, fbb, scal, out, settings):
    m, n = A.shape
    K = cb.shape[0]
    dev, dt = A.device, A.dtype
    is_double = dt == torch.float64
    grid = sweep_grid(lib, dev, is_double)
    H = sweep_plan(m, n, A.element_size(), grid)
    mult = 16 // A.element_size()
    A, At, Ginv = (_pad_cols(M, mult) for M in (A, At, Ginv))
    groups = -(-K // SWEEP_LANES)
    cbl = _lanes_inner(cb, groups)
    fbl = _lanes_inner(fbb, groups) if fbb is not None else None
    work = torch.empty(lib.pogs_sweep_work_elems(m, n, *H, grid), dtype=dt, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    return lib.pogs_sweep(
        int(is_double), dev.index,
        A.data_ptr(), At.data_ptr(), Ginv.data_ptr(), hf.data_ptr(), fp.data_ptr(),
        hg.data_ptr(), gp.data_ptr(), cbl.data_ptr(),
        fbl.data_ptr() if fbl is not None else None, scal.data_ptr(),
        out["x12"].data_ptr(), out["y12"].data_ptr(), out["stats"].data_ptr(),
        work.data_ptr(), m, n, K, A.shape[1], At.shape[1], Ginv.shape[1], *H,
        float(settings.abs_tol), float(settings.rel_tol), int(settings.max_iter),
        int(bool(settings.gap_stop)), int(bool(settings.adaptive_rho)), grid, stream,
    )


def _launch(A, Ginv, norm_A, h_f, f_params, h_g, g_params, c_batch, settings,
            rho0, fb_batch, At):
    if A.dtype not in _DTYPES:
        raise TypeError(f"batched ADMM kernel takes float32 or float64, not {A.dtype}")
    if not fused_admm_supported(settings):
        raise ValueError("the batched kernel does not support anderson, "
                         "exact-tol or verbose > 1")
    dev, dt = A.device, A.dtype
    m, n = A.shape
    k = min(m, n)
    if tuple(Ginv.shape) != (k, k):
        raise ValueError(f"Ginv has shape {tuple(Ginv.shape)}, expected {(k, k)}")
    A = A.contiguous()
    if At is not None:
        At = At.contiguous()
        if tuple(At.shape) != (n, m):
            raise ValueError(f"At has shape {tuple(At.shape)}, expected {(n, m)}")
    Ginv = Ginv.to(dtype=dt).contiguous()
    for t in (At, Ginv):
        if t is not None and (t.device != dev or t.dtype != dt):
            raise ValueError("A, At and Ginv must share device and dtype")
    h_f, h_g = np.asarray(h_f, np.int32), np.asarray(h_g, np.int32)
    if h_f.shape != (m,) or h_g.shape != (n,):
        raise ValueError(f"h codes of shapes {h_f.shape}, {h_g.shape}, expected ({m},), ({n},)")
    if h_f.size and (h_f.min() < 0 or h_f.max() > 15) or h_g.size and (
            h_g.min() < 0 or h_g.max() > 15):
        raise ValueError("h codes must be Function values 0..15")
    f_l, g_l = _lane_inputs(A, h_f, f_params, h_g, g_params, c_batch, fb_batch)
    K = g_l.c.shape[0]
    cb = g_l.c.contiguous()
    fbb = f_l.b.contiguous() if fb_batch is not None else None
    # The kernels read g's c from cb and, with fb_batch, f's b from fbb; their
    # rows of fp / gp are unused.
    zm = torch.zeros(m, dtype=dt, device=dev)
    zn = torch.zeros(n, dtype=dt, device=dev)
    fp = torch.stack([f_l.a, zm if fbb is not None else f_l.b, f_l.c, f_l.d, f_l.e])
    gp = torch.stack([g_l.a, g_l.b, zn, g_l.d, g_l.e])
    hf = torch.as_tensor(h_f, device=dev)
    hg = torch.as_tensor(h_g, device=dev)
    scal = torch.stack([torch.as_tensor(rho0, dtype=dt, device=dev).reshape(()),
                        torch.as_tensor(norm_A, dtype=dt, device=dev).reshape(())])

    route = route_for(m, n, A.element_size(), K)
    if route == "stream":
        # The resident kernel reads no Aᵀ; the streaming one does.
        At = A.T.contiguous() if At is None else At
        lib, run = _sweep_lib(), _run_stream
    else:
        lib, run = _lib(), _run_resident
    out = {"x12": torch.empty((K, n), dtype=dt, device=dev),
           "y12": torch.empty((K, m), dtype=dt, device=dev),
           "stats": torch.empty((K, 4), dtype=dt, device=dev)}
    rc = run(lib, A, At, Ginv, hf, fp, hg, gp, cb, fbb, scal, out, settings)
    _check(lib, rc, "launch")
    fused_batched_lasso_sweep.launches += 1
    fused_batched_lasso_sweep.launches_by_route[route] += 1
    stats = out["stats"]
    return {
        "x12": out["x12"],
        "y12": out["y12"],
        "optval": stats[:, 0],
        "final_iter": stats[:, 1].to(torch.int32),
        "status": stats[:, 2].to(torch.int32),
        "rho": stats[:, 3],
    }


def fused_batched_lasso_sweep(A, Ginv, norm_A, h_f, f_params, h_g, g_params,
                              c_batch, settings: SolverSettings, rho0,
                              fb_batch=None, At: Optional[torch.Tensor] = None):
    """Run K lanes of the graph-form solve: lane k with g.c = ``c_batch[k]``
    ((K, n)) and, when ``fb_batch`` ((K, m)) is given, f.b = ``fb_batch[k]``.

    Inputs are the *scaled* pieces from the solver init, as for
    :func:`pogs_tpu_torch.ops.fused_admm.fused_admm_loop`: the equilibrated
    dense ``A``, ``Ginv`` = (Gram + I)⁻¹, ``f_params`` / ``g_params`` the
    scaled (a, b, c, d, e) tuples (g's c is replaced per lane); ``At``
    optionally passes a contiguous Aᵀ kept by the caller (only the
    streaming kernel reads one).  Returns x12
    (K, n), y12 (K, m), and optval, final_iter, status and rho, each (K,).
    A CUDA ``A`` runs the kernel; a CPU ``A`` runs
    :func:`fused_batched_lasso_sweep_ref`.
    """
    if A.device.type == "cuda":
        return _launch(A, Ginv, norm_A, h_f, f_params, h_g, g_params, c_batch,
                       settings, rho0, fb_batch, At)
    if A.device.type == "cpu":
        return fused_batched_lasso_sweep_ref(A, Ginv, norm_A, h_f, f_params, h_g,
                                             g_params, c_batch, settings, rho0,
                                             fb_batch=fb_batch)
    raise ValueError(f"batched ADMM sweep: unsupported device {A.device}")


fused_batched_lasso_sweep.launches = 0
fused_batched_lasso_sweep.launches_by_route = {"resident": 0, "stream": 0}
