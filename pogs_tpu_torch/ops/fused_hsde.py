"""The whole HSDE cone solve as ONE hand-written CUDA kernel.

Counterpart of ``pogs_tpu/ops/fused_hsde.py::fused_hsde_solve``.  The kernel
(``csrc/fused_hsde.cu``) is a persistent cooperative kernel: one launch runs
every Douglas–Rachford iteration of the homogeneous self-dual embedding for
a dense, equilibrated A with the SMW factor of the cone init.  Its source
note says what bounds it on the card and what the design does about it.

``fused_hsde_solve`` takes the same arguments and returns the same dict as
the JAX function (without the TPU's 128-lane padding):

  * on a CUDA tensor it launches the kernel or raises — there is no fallback;
  * on a CPU tensor it runs the plain version, :func:`fused_hsde_solve_ref`,
    which is the eager ``hsde_solve`` with the SMW solve through the given
    Kinv (Woodbury when A is wide), no polish and no Anderson.

``hsde_plan`` gives the launch plan the kernel takes: blocks (sized to the
problem: one for a small problem, about 8 rows of the longest product per
block beyond), threads, dynamic shared memory and each segment's owner
block.  ``fused_hsde_solve.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from pogs_tpu_torch.types import Cone
from pogs_tpu_torch.cones.sets import ConeSet
from pogs_tpu_torch.cones.projections import exp_grid
from pogs_tpu_torch.solver.hsde import hsde_solve

_DTYPES = (torch.float32, torch.float64)
MAX_SEGMENTS = 16
THREADS = 512                # threads per block (csrc/coop.cuh kThreads)
SMEM_VECTORS = 196_608       # dynamic shared memory that stages vectors (of 232,448)
_PER_SM: dict = {}
_EXP_GRIDS: dict = {}
# Row codes of the kernel: the separable kinds; segment rows are 16 + index.
_ROW_CODE = {Cone.ZERO: 1, Cone.NON_NEG: 2, Cone.NON_POS: 3}
_SEG_ROW = 16


def segments(Ky: ConeSet):
    """(kind, start, length) of the SOC / SDP / exponential constraints in
    order; None if one of them is not a contiguous index range."""
    segs = []
    for con in Ky.constraints:
        if con.cone in _ROW_CODE:
            continue
        idx = list(con.indices)
        if idx != list(range(idx[0], idx[0] + len(idx))):
            return None
        segs.append((con.cone, idx[0], len(idx)))
    return segs


def fused_hsde_eligible(dtype, Ky: ConeSet, has_P: bool, use_anderson: bool) -> bool:
    """The JAX package's gate without its VMEM budget: float32 or float64,
    no P, no Anderson, at most 16 contiguous SOC / exponential segments,
    no SDP."""
    if dtype not in _DTYPES or has_P or use_anderson:
        return False
    segs = segments(Ky)
    return (segs is not None and len(segs) <= MAX_SEGMENTS
            and all(kind != Cone.SDP for kind, _, _ in segs))


# Matrix elements (2mn + k², k = min(m, n)) up to which the kernel runs as
# one block, and the rows of the longest product a block takes beyond it.
# From the route table of chip_smoke.py's phase 10 (an NVIDIA H100): one
# block is fastest up to 64x48 (8,448 elements) and 19 to 20% slower than
# the best grid at 90x60 (14,400); beyond, the fastest grid gives each
# block about 8 rows (8 at 90x60, 16 at 128x96, 33 at 200x120, 33 to 66 at
# 300x200 and 60x300, 66 to 132 at 804x200, 132 at 1100x300).
ONE_BLOCK_ELEMS = 11_000
ROWS_PER_BLOCK = 8


def blocks_for(m: int, n: int, sms: int) -> int:
    """Blocks the kernel runs on for an (m, n) problem, before the
    occupancy limit: one (its barriers are __syncthreads) up to
    ONE_BLOCK_ELEMS matrix elements, else the fewest of sms, sms/2, sms/4,
    ... (halved, rounded down) that leave each block at most ROWS_PER_BLOCK
    rows of the longest product (max(m, n) rows)."""
    k = min(m, n)
    if 2 * m * n + k * k <= ONE_BLOCK_ELEMS:
        return 1
    blocks = sms
    while blocks // 2 >= 1 and (blocks // 2) * ROWS_PER_BLOCK >= max(m, n):
        blocks //= 2
    return blocks


def hsde_plan(m: int, n: int, itemsize: int, segs, sms: int, limit: int) -> dict:
    """The kernel's launch plan for an (m, n) problem with ``segs`` (kind,
    start, length) segments on a card of ``sms`` SMs, where at most
    ``limit`` blocks are co-resident (the occupancy limit):

      * ``blocks``: ``blocks_for``, at most ``limit``;
      * ``threads``: per block;
      * ``smem``: dynamic shared memory in bytes, the staged vectors of a
        paired product: two of the longer side, in column tiles when they
        exceed ``SMEM_VECTORS``;
      * ``owners``: each segment's owner block, segment s on block s % blocks;
      * ``barriers_per_iter`` (4 tall, 6 wide), ``barriers_per_check`` (2, or
        1 with no segment), and the partial-sum slots reduced across blocks
        per iteration and per check (``slots_per_iter``,
        ``slots_per_check``).

    It depends on nothing else, so one problem always runs the same plan
    and sums in the same order."""
    if itemsize not in (4, 8):
        raise ValueError(f"itemsize {itemsize}: the kernel takes float32 or float64")
    per = 16 // itemsize                 # columns of one 16-byte load
    cols = -(-max(m, n) // per) * per
    cap = SMEM_VECTORS // itemsize // (2 * per) * (2 * per)
    nseg = len(segs)
    blocks = max(1, min(blocks_for(m, n, sms), sms, limit))
    return {
        "blocks": blocks,
        "threads": THREADS,
        "smem": min(2 * cols, cap) * itemsize,
        "owners": [s % blocks for s in range(nseg)],
        "barriers_per_iter": 4 if m >= n else 6,
        "barriers_per_check": 2 if nseg else 1,
        "slots_per_iter": 2 + 5,
        "slots_per_check": 11 + (2 if nseg else 0),
    }


def fused_hsde_solve_ref(A, b, c, Ky: ConeSet, Kinv, t_x, t_y, s_den,
                         abs_tol: float, rel_tol: float, max_iter: int, u0=None):
    """The kernel's plain version: the eager loop, SMW through Kinv."""
    m, n = A.shape
    if m >= n:
        def apply_kinv(v):
            return torch.mv(Kinv, v)
    else:
        def apply_kinv(v):  # Woodbury through the m×m (I + AAᵀ)⁻¹
            return v - torch.mv(A.T, torch.mv(Kinv, torch.mv(A, v)))
    factor = {"apply": apply_kinv, "t_x": t_x, "t_y": t_y, "s_den": s_den}
    return hsde_solve(A, b, c, Ky, strategy="smw", abs_tol=abs_tol, rel_tol=rel_tol,
                      max_iter=max_iter, smw_factor=factor, u0=u0)


def _lib():
    from pogs_tpu_torch.ops._build import load

    lib = load("fused_hsde")
    if not getattr(lib, "_pogs_typed", False):
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.pogs_fused_hsde.argtypes = ([ci, ci] + [vp] * 16 + [ci, ci, ci, vp]
                                        + [cd, cd, ci, ci, ci, vp])
        lib.pogs_fused_hsde.restype = ci
        lib.pogs_fused_hsde_blocks_per_sm.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
        lib.pogs_fused_hsde_blocks_per_sm.restype = ci
        lib.pogs_fused_hsde_work_elems.argtypes = [ci, ci, ci]
        lib.pogs_fused_hsde_work_elems.restype = ctypes.c_longlong
        lib.pogs_fused_hsde_error_string.argtypes = [ci]
        lib.pogs_fused_hsde_error_string.restype = ctypes.c_char_p
        lib._pogs_typed = True
    return lib


def _check(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.pogs_fused_hsde_error_string(rc).decode()
        raise RuntimeError(f"fused HSDE kernel: {what} failed: {msg} ({rc})")


def _per_sm(lib, device: torch.device, is_double: bool, smem: int) -> int:
    """Blocks an SM holds at once with ``smem`` bytes of dynamic shared memory."""
    key = (device.index, is_double, smem)
    if key not in _PER_SM:
        g = ctypes.c_int(0)
        _check(lib, lib.pogs_fused_hsde_blocks_per_sm(int(is_double), device.index, smem,
                                                      ctypes.byref(g)), "occupancy query")
        if g.value < 1:
            raise RuntimeError("fused HSDE kernel: a block does not fit on an SM")
        _PER_SM[key] = g.value
    return _PER_SM[key]


def launch_plan(lib, device: torch.device, dtype, m: int, n: int, segs) -> dict:
    """``hsde_plan`` for this card: its SM count and the occupancy limit at
    the plan's shared memory."""
    itemsize = 8 if dtype == torch.float64 else 4
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    smem = hsde_plan(m, n, itemsize, segs, sms, 1)["smem"]
    limit = sms * _per_sm(lib, device, dtype == torch.float64, smem)
    return hsde_plan(m, n, itemsize, segs, sms, limit)


def _row_codes(Ky: ConeSet, segs, dev: torch.device) -> torch.Tensor:
    """The kernel's row codes of Ky on dev, made once per cone set and
    device (a solver's repeated solves copy nothing to the card for them)."""
    cache = Ky.__dict__.setdefault("_fused_hsde_codes", {})
    if dev not in cache:
        code = np.zeros(Ky.dim, np.int32)
        for con in Ky.constraints:
            if con.cone in _ROW_CODE:
                code[list(con.indices)] = _ROW_CODE[con.cone]
        for s, (_, start, length) in enumerate(segs):
            code[start:start + length] = _SEG_ROW + s
        cache[dev] = torch.as_tensor(code, device=dev)
    return cache[dev]


def _exp_grid(dtype, dev: torch.device) -> torch.Tensor:
    """The exponential-cone scan points on dev, made once per dtype and device."""
    key = (dtype, dev)
    if key not in _EXP_GRIDS:
        _EXP_GRIDS[key] = exp_grid(dtype).to(dev).contiguous()
    return _EXP_GRIDS[key]


def _launch(A, b, c, Ky, Kinv, t_x, t_y, s_den, abs_tol, rel_tol, max_iter, u0, At):
    if A.dtype not in _DTYPES:
        raise TypeError(f"fused HSDE kernel takes float32 or float64, not {A.dtype}")
    dev, dt = A.device, A.dtype
    m, n = A.shape
    if Ky.dim != m:
        raise ValueError(f"cone set of dimension {Ky.dim}, expected {m}")
    segs = segments(Ky)
    if segs is None or len(segs) > MAX_SEGMENTS or any(k == Cone.SDP for k, _, _ in segs):
        raise ValueError("the fused HSDE kernel takes at most 16 contiguous SOC or "
                         "exponential segments and no SDP cone")
    k = n if m >= n else m
    if tuple(Kinv.shape) != (k, k):
        raise ValueError(f"Kinv has shape {tuple(Kinv.shape)}, expected {(k, k)}")
    A = A.contiguous()
    At = A.T.contiguous() if At is None else At.contiguous()
    if tuple(At.shape) != (n, m):
        raise ValueError(f"At has shape {tuple(At.shape)}, expected {(n, m)}")
    Kinv = Kinv.contiguous()
    for t in (At, Kinv):
        if t.device != dev or t.dtype != dt:
            raise ValueError("A, At and Kinv must share device and dtype")

    def vec(v, length):
        t = torch.as_tensor(v, dtype=dt, device=dev).reshape(-1)
        if t.shape[0] != length:
            raise ValueError(f"vector of length {t.shape[0]}, expected {length}")
        return t.contiguous()

    b, c, t_x, t_y = vec(b, m), vec(c, n), vec(t_x, n), vec(t_y, m)
    code_t, grid_pts = _row_codes(Ky, segs, dev), _exp_grid(dt, dev)
    if u0 is None:
        u = torch.cat([torch.zeros(n + m, dtype=dt, device=dev),
                       torch.ones(1, dtype=dt, device=dev)])
    else:
        u = vec(u0, n + m + 1).clone()
    ux, uy = u[:n].clone(), u[n:n + m].clone()
    scal = torch.stack([vec(s_den, 1)[0], torch.linalg.vector_norm(b),
                        torch.linalg.vector_norm(c), u[n + m]]).contiguous()

    lib = _lib()
    is_double = dt == torch.float64
    plan = launch_plan(lib, dev, dt, m, n, segs)
    seg_table = np.zeros(4 * MAX_SEGMENTS, np.int32)
    for s, ((kind, start, length), owner) in enumerate(zip(segs, plan["owners"])):
        seg_table[4 * s:4 * s + 4] = (int(kind), start, length, owner)
    wx = torch.empty(n, dtype=dt, device=dev)
    wy = torch.empty(m, dtype=dt, device=dev)
    stats = torch.empty(8, dtype=dt, device=dev)
    work = torch.empty(lib.pogs_fused_hsde_work_elems(m, n, plan["blocks"]), dtype=dt,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.pogs_fused_hsde(
        int(is_double), dev.index,
        A.data_ptr(), At.data_ptr(), Kinv.data_ptr(), b.data_ptr(), c.data_ptr(),
        t_x.data_ptr(), t_y.data_ptr(), code_t.data_ptr(), grid_pts.data_ptr(),
        scal.data_ptr(), ux.data_ptr(), uy.data_ptr(), wx.data_ptr(), wy.data_ptr(),
        stats.data_ptr(), work.data_ptr(), m, n, len(segs),
        seg_table.ctypes.data_as(ctypes.c_void_p), float(abs_tol), float(rel_tol),
        int(max_iter), plan["blocks"], plan["smem"], stream,
    )
    _check(lib, rc, "launch")
    fused_hsde_solve.launches += 1
    return {
        "w": torch.cat([wx, wy, stats[0:1]]),
        "u": torch.cat([ux, uy, stats[7:8]]),
        "status": stats[2].to(torch.int32),
        "final_iter": stats[1].to(torch.int32),
        "fp_resid": stats[3],
        "r_pri": stats[4],
        "r_dua": stats[5],
        "gap": stats[6],
    }


def fused_hsde_solve(A, b, c, Ky: ConeSet, Kinv, t_x, t_y, s_den,
                     abs_tol: float, rel_tol: float, max_iter: int, u0=None,
                     At: Optional[torch.Tensor] = None):
    """Fused counterpart of :func:`pogs_tpu_torch.solver.hsde.hsde_solve`
    (SMW strategy).

    ``A`` is the equilibrated dense matrix and ``b``, ``c`` the scaled data;
    ``Kinv`` is (I + AᵀA)⁻¹ (n×n) for a tall A and (I + AAᵀ)⁻¹ (m×m) for a
    wide one, as the cone init caches it; ``t_x``, ``t_y``, ``s_den`` the
    rest of the SMW factor; ``u0`` an optional warm start [x; y; τ]; ``At``
    optionally a contiguous Aᵀ kept by the caller.  A CUDA ``A`` runs the
    kernel; a CPU ``A`` runs :func:`fused_hsde_solve_ref`.
    """
    if A.device.type == "cuda":
        return _launch(A, b, c, Ky, Kinv, t_x, t_y, s_den, abs_tol, rel_tol,
                       max_iter, u0, At)
    if A.device.type == "cpu":
        return fused_hsde_solve_ref(A, b, c, Ky, Kinv, t_x, t_y, s_den, abs_tol,
                                    rel_tol, max_iter, u0)
    raise ValueError(f"fused HSDE solve: unsupported device {A.device}")


fused_hsde_solve.launches = 0
