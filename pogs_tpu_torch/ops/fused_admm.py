"""The whole graph-form ADMM solve as ONE hand-written CUDA kernel.

Counterpart of ``pogs_tpu/ops/fused_admm.py::fused_admm_loop``.  The kernel
(``csrc/fused_admm.cu``) is a persistent cooperative kernel: one launch runs
every iteration of the solve for a dense, equilibrated A with the explicit
(G + I)⁻¹ of the direct projector.  Its source note says what bounds it on
the card and what the design does about it.

``fused_admm_loop`` takes the same arguments and returns the same dict as
the JAX function (without the TPU's 128-lane padding):

  * on a CUDA tensor it launches the kernel or raises — there is no fallback;
  * on a CPU tensor it runs the plain version, :func:`fused_admm_loop_ref`,
    which is the eager ``admm_loop`` with the inverse projector.

``admm_plan`` gives the launch plan the kernel takes: blocks (one for a
small problem, else half or all of the SMs), threads, dynamic shared memory and the
barriers (3 per iteration where every block computes the first product's
side itself, else 4; one more on an iteration near tolerance), and the route:
a tall A beyond ``ONE_PASS_BYTES`` takes one pass over A per iteration
(``one_pass_for``).  ``fused_admm_loop.launches`` counts kernel launches; the
result's ``a_passes`` the passes over A or Aᵀ the solve made, and ``checks``
its iterations near tolerance.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from pogs_tpu_torch.types import Function, FunctionVector, SolverSettings
from pogs_tpu_torch.prox.vector import prox_eval, func_eval
from pogs_tpu_torch.projector.direct import DirectProjector
from pogs_tpu_torch.solver.admm import admm_loop

_DTYPES = (torch.float32, torch.float64)
THREADS = 512               # threads per block (csrc/coop.cuh kThreads)
SMEM_BUDGET = 229_376       # dynamic shared memory a block may take (of 232,448)
ONE_BLOCK_ELEMS = 11_000    # matrix elements (2mn + k²) run on one block
HALF_GRID_ELEMS = 32_768    # ... on half the SMs (blocks_for)
# The one-pass route (csrc/fused_admm.cu, kPassRows, kRowState, kStages,
# kCols): rows of A a step takes, the state staged for each row, the ring's
# steps, and columns per thread (n at most PASS_COLS * THREADS).
PASS_ROWS = 2
PASS_ROW_STATE = 9
PASS_STAGES = 4
PASS_COLS = 10
ONE_PASS_BYTES = 90_000_000  # A and Ginv, (mn + n²)·itemsize, beyond which a tall A takes it
ONE_PASS_MIN_N = 2_500       # ... with at least this many columns
STATS = 11                   # entries of the kernel's stats vector
# Functions whose prox iterates (Newton, bisection, Lambert W): logistic,
# exp, negative entropy.
ITERATIVE_PROX = (int(Function.EXP), int(Function.LOGISTIC), int(Function.NEGENTR))
_PER_SM: dict = {}


def fused_admm_supported(settings: SolverSettings) -> bool:
    """True if the kernel implements the settings' mode."""
    return not (settings.use_anderson or settings.use_exact_tol
                or settings.verbose > 1)


def shared_side_for(iterative: int) -> bool:
    """Whether every block computes the first product's side for itself,
    saving the barrier before the first product, where ``iterative`` of
    that side's elements have an iterative prox: not where there are more
    of them than a block has threads, since a second logistic prox per
    thread costs more than the barrier.  K1's route table (chip_smoke.py's
    phase 3; an NVIDIA H100 80GB HBM3, 700 W), µs per iteration with the
    shared side / without: logistic 400x200 18.6 / 20.1, 600x300 22.2 /
    21.4, 1000x500 23.2 / 21.6, 2000x1000 35.1 / 26.0.  Without an
    iterative prox the shared side is within 5% of the faster order in
    every cell, from 60x40 to 5000x2500 (faster up to 3000x1500: 34.7 / 35.9;
    5000x2500 68.3 / 67.5, 2500x5000 69.1 / 66.7)."""
    return iterative <= THREADS


def one_pass_for(m: int, n: int, itemsize: int, iterative: int = 0) -> bool:
    """Whether a tall (m, n) problem, ``iterative`` of whose m f elements
    have an iterative prox, takes the one-pass route: one pass over A an
    iteration, y = A x fused with the next iteration's Aᵀ products under
    each ρ step the balancing can take, in f32, where A and Ginv lie beyond
    ONE_PASS_BYTES, rows are at least ONE_PASS_MIN_N long and no prox of f
    iterates.  K1's route table (chip_smoke.py's phase 3; an NVIDIA H100
    80GB HBM3, 700 W), µs per iteration on the one pass / the plain
    products, f32: 10000x5000 137.2 / 193.9, 8000x4000 106.5 / 132.5,
    20000x2500 162.2 / 173.0, 6000x3000 79.0 / 85.5; 5000x2500 (75 MB)
    66.3 / 67.2, a draw; 20000x2000 156.3 / 143.1.  Below the bytes the pass
    saves too little; on shorter rows its block sync every two rows costs
    more than the bytes; an iterative prox runs three times a row on one
    thread each (logistic 5000x2500: 128 / 83); in f64 the pass's registers
    spill (5000x2500 141.6 / 117.7, 6000x3000 173.8 / 156.6); a wide A keeps
    the plain products."""
    return (itemsize == 4 and m >= n >= ONE_PASS_MIN_N and iterative == 0
            and (m * n + n * n) * itemsize > ONE_PASS_BYTES)


def blocks_for(m: int, n: int, sms: int) -> int:
    """Blocks the kernel runs on for an (m, n) problem, before the
    occupancy limit, by its matrix elements 2mn + k²: one (its barriers are
    __syncthreads) up to ONE_BLOCK_ELEMS, half the SMs up to
    HALF_GRID_ELEMS, else every SM.  K1's route table (chip_smoke.py's
    phase 3; an NVIDIA H100 80GB HBM3, 700 W) has this grid within 5% of
    the fastest of 1, 8, 16, 33, 66 and 132 blocks in all 26 cells from
    60x40 to 5000x2500, f32 and f64: one block is fastest or within 3% up to
    80x50 (10,500 elements) and 14% slower at 90x60 (14,400); in f64, 132
    blocks are 9% slower than 66 from 90x60 to 120x80 (25,600) and the
    fastest from 200x120 (62,400).  The cone kernel's rule (about 8 rows
    per block) is 7% slower at 120x80 f32."""
    k = min(m, n)
    elems = 2 * m * n + k * k
    if elems <= ONE_BLOCK_ELEMS:
        return 1
    return max(1, sms // 2) if elems <= HALF_GRID_ELEMS else sms


def admm_plan(m: int, n: int, itemsize: int, sms: int, limit: int,
              iterative: int = 0) -> dict:
    """The kernel's launch plan for an (m, n) problem on a card of ``sms``
    SMs, where at most ``limit`` blocks are co-resident (the occupancy
    limit), and ``iterative`` elements of the first product's side (f's for
    a tall A, g's for a wide one) have an iterative prox:

      * ``blocks``: ``blocks_for``, at most ``limit``;
      * ``threads``: per block;
      * ``shared_side``: every block computes the side the first product
        reads (y tall, x wide) into its shared memory and keeps that side's
        z, z̃, prox value and prox parameters there (``shared_side_for``,
        where it fits), so the first product waits for no barrier;
      * ``one_pass``: the one-pass route (``one_pass_for``, in f32, the
        kernel's one pass being built for it alone, where n is at most
        PASS_COLS · THREADS and the ring fits beside the staged x): the
        shared side off, and ``ring`` elements of shared memory after the
        staging buffer, PASS_STAGES steps of PASS_ROWS rows of A, then the
        state of each of a block's rows (at least THREADS elements, the
        scratch of the sum of the blocks' products; 0 off the route);
      * ``xs``: elements of the vector staging buffer, both vectors of the
        exact residuals where they fit (else column tiles; on the one pass
        x alone, which leaves the static arrays and L1 their room);
      * ``smem``: dynamic shared memory in bytes;
      * ``barriers_per_iter`` (3, or 4 without the shared side or the one
        pass) and ``barriers_per_check`` (1: the exact residuals near
        tolerance), the partial-sum slots reduced across blocks per
        iteration and per check (``slots_per_iter``, ``slots_per_check``),
        and the passes over A or Aᵀ an ordinary iteration makes
        (``passes_per_iter``: 1 on the one pass, else 2; the one pass's
        k = 0 and spectral ρ steps add one pass and one barrier, each check
        two passes).

    It depends on nothing else, so one problem always runs the same plan
    and sums in the same order."""
    if itemsize not in (4, 8):
        raise ValueError(f"itemsize {itemsize}: the kernel takes float32 or float64")
    per = 16 // itemsize                     # elements of one 16-byte load

    def rnd(x):
        return -(-x // per) * per

    budget = SMEM_BUDGET // itemsize
    side = max(m, n)                         # the shared side: y tall, x wide
    blocks = max(1, min(blocks_for(m, n, sms), sms, limit))
    pair = rnd(m) + rnd(n)
    state = 9 * rnd(side)
    rows = -(-m // blocks)                   # a block's rows of A at most
    ring = max(PASS_STAGES * PASS_ROWS * (rnd(n) + per) + rnd(rows * PASS_ROW_STATE), THREADS)
    one = (one_pass_for(m, n, itemsize, iterative) and itemsize == 4
           and n <= PASS_COLS * THREADS and rnd(n) + ring <= budget)
    ring = ring if one else 0
    shared = not one and shared_side_for(iterative) and state + pair <= budget
    base = state if shared else ring
    xs = pair if base + pair <= budget else rnd(n) if one else (budget - base) // per * per
    return {
        "blocks": blocks,
        "threads": THREADS,
        "shared_side": shared,
        "one_pass": one,
        "ring": ring,
        "xs": xs,
        "smem": (base + xs) * itemsize,
        "barriers_per_iter": 3 if shared or one else 4,
        "barriers_per_check": 1,
        "slots_per_iter": 12,
        "slots_per_check": 2,
        "passes_per_iter": 1 if one else 2,
    }


def iterative_count(h) -> int:
    """Elements of a function-code vector whose prox iterates."""
    return int(np.isin(np.asarray(h), ITERATIVE_PROX).sum())


def _fv(h, params) -> FunctionVector:
    fv = FunctionVector.__new__(FunctionVector)
    fv.h = np.asarray(h, np.int32)
    fv.n = fv.h.shape[0]
    fv.a, fv.b, fv.c, fv.d, fv.e = params
    return fv


def fused_admm_loop_ref(A, Ginv, norm_A, h_f, f_params, h_g, g_params,
                        settings: SolverSettings, z0, zt0, rho0):
    """The kernel's plain version: the eager loop with the inverse projector."""
    f_s = _fv(h_f, f_params)
    g_s = _fv(h_g, g_params)
    projector = DirectProjector("inverse")
    factor = {"op": Ginv, "s": torch.ones((), dtype=A.dtype, device=A.device)}

    def prox_fn(x_in, y_in, rho):
        return prox_eval(g_s, x_in, rho), prox_eval(f_s, y_in, rho)

    def eval_fn(x12, y12):
        return func_eval(f_s, y12) + func_eval(g_s, x12)

    def project_fn(x0, y0, tol, x_warm):
        return projector.project(A, factor, x0, y0)

    return admm_loop(A, norm_A, None, None, prox_fn, eval_fn, project_fn,
                     settings, z0, zt0, rho0)


def _lib():
    from pogs_tpu_torch.ops._build import load

    lib = load("fused_admm")
    if not getattr(lib, "_pogs_typed", False):
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.pogs_fused_admm.argtypes = ([ci, ci] + [vp] * 14
                                        + [ci, ci, cd, cd] + [ci] * 8 + [vp])
        lib.pogs_fused_admm.restype = ci
        lib.pogs_fused_admm_blocks_per_sm.argtypes = [ci, ci, ci, ci, ctypes.POINTER(ci)]
        lib.pogs_fused_admm_blocks_per_sm.restype = ci
        lib.pogs_fused_admm_smem_bytes.argtypes = [ci] * 7
        lib.pogs_fused_admm_smem_bytes.restype = ctypes.c_longlong
        lib.pogs_fused_admm_work_elems.argtypes = [ci] * 4
        lib.pogs_fused_admm_work_elems.restype = ctypes.c_longlong
        lib.pogs_fused_admm_error_string.argtypes = [ci]
        lib.pogs_fused_admm_error_string.restype = ctypes.c_char_p
        lib._pogs_typed = True
    return lib


def _check(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.pogs_fused_admm_error_string(rc).decode()
        raise RuntimeError(f"fused ADMM kernel: {what} failed: {msg} ({rc})")


def _per_sm(lib, device: torch.device, is_double: bool, smem: int, one_pass: bool) -> int:
    """Blocks of a route's kernel an SM holds at once with ``smem`` bytes of
    dynamic shared memory."""
    key = (device.index, is_double, smem, one_pass)
    if key not in _PER_SM:
        g = ctypes.c_int(0)
        _check(lib, lib.pogs_fused_admm_blocks_per_sm(int(is_double), device.index, smem,
                                                      int(one_pass), ctypes.byref(g)),
               "occupancy query")
        if g.value < 1:
            raise RuntimeError("fused ADMM kernel: a block does not fit on an SM")
        _PER_SM[key] = g.value
    return _PER_SM[key]


def launch_plan(lib, device: torch.device, dtype, m: int, n: int, h_f, h_g) -> dict:
    """``admm_plan`` for this card (its SM count and the occupancy limit at
    the plan's shared memory) and these function codes."""
    itemsize = 8 if dtype == torch.float64 else 4
    is_double = dtype == torch.float64
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    iterative = iterative_count(h_f if m >= n else h_g)
    plan = admm_plan(m, n, itemsize, sms, sms, iterative)
    limit = sms * _per_sm(lib, device, is_double, plan["smem"], plan["one_pass"])
    if limit < plan["blocks"]:
        plan = admm_plan(m, n, itemsize, sms, limit, iterative)
        if plan["blocks"] > sms * _per_sm(lib, device, is_double, plan["smem"],
                                          plan["one_pass"]):
            raise RuntimeError("fused ADMM kernel: the plan's blocks are not co-resident")
    return plan


def _codes(h: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The function codes h on dev, copied from pinned host memory without
    waiting: a copy from pageable memory waits for the stream, which would
    keep the host from preparing a solve while the last one runs."""
    t = torch.empty(h.shape, dtype=torch.int32, pin_memory=True)
    t.numpy()[...] = h
    return t.to(dev, non_blocking=True)


def _scalar(v, dt, dev: torch.device) -> torch.Tensor:
    """A 0-d tensor on dev: a number is filled in there (no host copy)."""
    if isinstance(v, torch.Tensor):
        if v.numel() != 1:
            raise ValueError(f"a scalar expected, not a tensor of shape {tuple(v.shape)}")
        return v.to(device=dev, dtype=dt).reshape(())
    return torch.full((), float(v), dtype=dt, device=dev)


def _launch(A, Ginv, norm_A, h_f, f_params, h_g, g_params, settings, z0, zt0,
            rho0, At):
    if A.dtype not in _DTYPES:
        raise TypeError(f"fused ADMM kernel takes float32 or float64, not {A.dtype}")
    if not fused_admm_supported(settings):
        raise ValueError("the fused kernel does not support anderson, "
                         "exact-tol or verbose > 1")
    dev, dt = A.device, A.dtype
    m, n = A.shape
    k = min(m, n)
    if tuple(Ginv.shape) != (k, k):
        raise ValueError(f"Ginv has shape {tuple(Ginv.shape)}, expected {(k, k)}")
    A = A.contiguous()
    At = A.T.contiguous() if At is None else At.contiguous()
    if tuple(At.shape) != (n, m):
        raise ValueError(f"At has shape {tuple(At.shape)}, expected {(n, m)}")
    Ginv = Ginv.to(dtype=dt).contiguous()
    for t in (At, Ginv):
        if t.device != dev or t.dtype != dt:
            raise ValueError("A, At and Ginv must share device and dtype")

    def vec(v, length):
        t = torch.as_tensor(v, dtype=dt, device=dev).reshape(-1)
        if t.shape[0] != length:
            raise ValueError(f"vector of length {t.shape[0]}, expected {length}")
        return t

    h_f, h_g = np.asarray(h_f, np.int32), np.asarray(h_g, np.int32)
    if h_f.shape != (m,) or h_g.shape != (n,):
        raise ValueError(f"h codes of shapes {h_f.shape}, {h_g.shape}, expected ({m},), ({n},)")
    if h_f.size and (h_f.min() < 0 or h_f.max() > 15) or h_g.size and (
            h_g.min() < 0 or h_g.max() > 15):
        raise ValueError("h codes must be Function values 0..15")
    hf, hg = _codes(h_f, dev), _codes(h_g, dev)
    fp = torch.stack([vec(p, m) for p in f_params]).contiguous()
    gp = torch.stack([vec(p, n) for p in g_params]).contiguous()
    z = vec(z0, m + n).clone()
    zt = vec(zt0, m + n).clone()
    scal = torch.stack([_scalar(rho0, dt, dev), _scalar(norm_A, dt, dev)])

    lib = _lib()
    is_double = dt == torch.float64
    plan = launch_plan(lib, dev, dt, m, n, h_f, h_g)
    grid = plan["blocks"]
    xy12 = torch.empty(m + n, dtype=dt, device=dev)
    munu = torch.empty(m + n, dtype=dt, device=dev)
    one_pass = int(plan["one_pass"])
    work = torch.empty(lib.pogs_fused_admm_work_elems(m, n, grid, one_pass), dtype=dt,
                       device=dev)
    stats = torch.empty(STATS, dtype=dt, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.pogs_fused_admm(
        int(is_double), dev.index,
        A.data_ptr(), At.data_ptr(), Ginv.data_ptr(), hf.data_ptr(), fp.data_ptr(),
        hg.data_ptr(), gp.data_ptr(), scal.data_ptr(), xy12.data_ptr(),
        munu.data_ptr(), z.data_ptr(), zt.data_ptr(), work.data_ptr(),
        stats.data_ptr(), m, n, float(settings.abs_tol), float(settings.rel_tol),
        int(settings.max_iter), int(bool(settings.gap_stop)),
        int(bool(settings.adaptive_rho)), grid, plan["smem"], plan["xs"],
        int(plan["shared_side"]), one_pass, stream,
    )
    _check(lib, rc, "launch")
    fused_admm_loop.launches += 1
    return {
        "x12": xy12[:n],
        "y12": xy12[n:],
        "mu_scaled": munu[:n],
        "nu_scaled": munu[n:],
        "optval": stats[0],
        "final_iter": stats[1].to(torch.int32),
        "status": stats[2].to(torch.int32),
        "rho": stats[3],
        "nrm_r": stats[4],
        "nrm_s": stats[5],
        "gap": stats[6],
        "eps_pri": stats[7],
        "eps_dua": stats[8],
        "a_passes": stats[9].to(torch.int32),
        "checks": stats[10].to(torch.int32),
        "z": z,
        "zt": zt,
    }


def fused_admm_loop(A, Ginv, norm_A, h_f, f_params, h_g, g_params,
                    settings: SolverSettings, z0, zt0, rho0,
                    At: Optional[torch.Tensor] = None):
    """Fused counterpart of :func:`pogs_tpu_torch.solver.admm.admm_loop`.

    ``A`` is the equilibrated dense matrix, ``Ginv`` the SPD inverse of
    (Gram + I) from ``DirectProjector(method='inverse')``, ``f_params`` /
    ``g_params`` the *scaled* (a, b, c, d, e) tuples.  ``At`` optionally
    passes a contiguous Aᵀ kept by the caller.  A CUDA ``A`` runs the
    kernel, whose result also holds ``a_passes``, the passes over A or Aᵀ
    the solve made, and ``checks``, its iterations near tolerance (two of
    those passes each); a CPU ``A`` runs :func:`fused_admm_loop_ref`.
    """
    if A.device.type == "cuda":
        return _launch(A, Ginv, norm_A, h_f, f_params, h_g, g_params, settings,
                       z0, zt0, rho0, At)
    if A.device.type == "cpu":
        return fused_admm_loop_ref(A, Ginv, norm_A, h_f, f_params, h_g, g_params,
                                   settings, z0, zt0, rho0)
    raise ValueError(f"fused ADMM loop: unsupported device {A.device}")


fused_admm_loop.launches = 0
