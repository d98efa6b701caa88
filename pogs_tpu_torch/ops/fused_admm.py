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

``fused_admm_loop.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from pogs_tpu_torch.types import FunctionVector, SolverSettings
from pogs_tpu_torch.prox.vector import prox_eval, func_eval
from pogs_tpu_torch.projector.direct import DirectProjector
from pogs_tpu_torch.solver.admm import admm_loop

_DTYPES = (torch.float32, torch.float64)
_GRIDS: dict = {}


def fused_admm_supported(settings: SolverSettings) -> bool:
    """True if the kernel implements the settings' mode."""
    return not (settings.use_anderson or settings.use_exact_tol
                or settings.verbose > 1)


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
        lib.pogs_fused_admm.argtypes = [ci, ci] + [vp] * 14 + [ci, ci, cd, cd, ci, ci, ci, ci, vp]
        lib.pogs_fused_admm.restype = ci
        lib.pogs_fused_admm_grid.argtypes = [ci, ci, ctypes.POINTER(ci)]
        lib.pogs_fused_admm_grid.restype = ci
        lib.pogs_fused_admm_work_elems.argtypes = [ci, ci, ci]
        lib.pogs_fused_admm_work_elems.restype = ctypes.c_longlong
        lib.pogs_fused_admm_error_string.argtypes = [ci]
        lib.pogs_fused_admm_error_string.restype = ctypes.c_char_p
        lib._pogs_typed = True
    return lib


def _check(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.pogs_fused_admm_error_string(rc).decode()
        raise RuntimeError(f"fused ADMM kernel: {what} failed: {msg} ({rc})")


def _grid(lib, device: torch.device, is_double: bool) -> int:
    key = (device.index, is_double)
    if key not in _GRIDS:
        g = ctypes.c_int(0)
        _check(lib, lib.pogs_fused_admm_grid(int(is_double), device.index, ctypes.byref(g)),
               "occupancy query")
        if g.value < 1:
            raise RuntimeError("fused ADMM kernel: a block does not fit on an SM")
        _GRIDS[key] = g.value
    return _GRIDS[key]


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
    hf = torch.as_tensor(h_f, device=dev)
    hg = torch.as_tensor(h_g, device=dev)
    fp = torch.stack([vec(p, m) for p in f_params]).contiguous()
    gp = torch.stack([vec(p, n) for p in g_params]).contiguous()
    z = vec(z0, m + n).clone()
    zt = vec(zt0, m + n).clone()
    scal = torch.stack([vec(rho0, 1)[0], vec(norm_A, 1)[0]])

    lib = _lib()
    is_double = dt == torch.float64
    grid = _grid(lib, dev, is_double)
    xy12 = torch.empty(m + n, dtype=dt, device=dev)
    munu = torch.empty(m + n, dtype=dt, device=dev)
    work = torch.empty(lib.pogs_fused_admm_work_elems(m, n, grid), dtype=dt, device=dev)
    stats = torch.empty(9, dtype=dt, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.pogs_fused_admm(
        int(is_double), dev.index,
        A.data_ptr(), At.data_ptr(), Ginv.data_ptr(), hf.data_ptr(), fp.data_ptr(),
        hg.data_ptr(), gp.data_ptr(), scal.data_ptr(), xy12.data_ptr(),
        munu.data_ptr(), z.data_ptr(), zt.data_ptr(), work.data_ptr(),
        stats.data_ptr(), m, n, float(settings.abs_tol), float(settings.rel_tol),
        int(settings.max_iter), int(bool(settings.gap_stop)),
        int(bool(settings.adaptive_rho)), grid, stream,
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
    kernel; a CPU ``A`` runs :func:`fused_admm_loop_ref`.
    """
    if A.device.type == "cuda":
        return _launch(A, Ginv, norm_A, h_f, f_params, h_g, g_params, settings,
                       z0, zt0, rho0, At)
    if A.device.type == "cpu":
        return fused_admm_loop_ref(A, Ginv, norm_A, h_f, f_params, h_g, g_params,
                                   settings, z0, zt0, rho0)
    raise ValueError(f"fused ADMM loop: unsupported device {A.device}")


fused_admm_loop.launches = 0
