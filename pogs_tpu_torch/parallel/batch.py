"""Batched graph-form solves on one GPU: λ-sweeps, multi-right-hand-side
sweeps and warm-started λ-paths.

Counterpart of the graph-form parts of ``pogs_tpu/parallel/batch.py``.  All
lanes share one init: equilibration, the ‖A‖₂ estimate and the explicit
(Gram + I)⁻¹ of the direct projector.  Lane k then solves the problem with
its own g.c, g.e or f.b:

  * a sweep the batched kernel takes (per-lane c and/or f.b, shared e) runs
    as ONE launch of ``ops.fused_admm_batch.fused_batched_lasso_sweep``;
  * any other batch runs lane after lane from the shared init, each from a
    cold start, through the single-solve path (the solve kernel on CUDA,
    the eager loop elsewhere) — where the JAX package vmaps the loop.

The warm λ-path walks the λ values in order and carries (z, z̃, ρ) on the
device from one step to the next.  The JAX package's mesh arguments have no
counterpart here: the port runs on one GPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pogs_tpu_torch.types import Function, FunctionVector, SolverSettings
from pogs_tpu_torch.prox.vector import prox_eval, func_eval, scale_f, scale_g
from pogs_tpu_torch.linalg.equil import equilibrate
from pogs_tpu_torch.linalg.norm import norm2_est
from pogs_tpu_torch.projector.direct import DirectProjector
from pogs_tpu_torch.solver.admm import admm_loop
from pogs_tpu_torch.linalg.matrix import is_sparse_input
from pogs_tpu_torch.solver.graph import _use_fused, resolve_device
from pogs_tpu_torch.ops.fused_admm import _fv, fused_admm_loop, fused_admm_supported
from pogs_tpu_torch.ops.fused_admm_batch import fused_batched_lasso_sweep
from pogs_tpu_torch.utils.precision import highest_precision


def _fused_batch_eligible(dtype, device, settings: SolverSettings, c_kind: str,
                          e_kind: str, fb_kind: str) -> bool:
    """Select the batched kernel (``ops/fused_admm_batch.py``) for a batch.

    The kernel takes a dense A, a shared g.e, a g.c that is per lane
    (``lane_scalar`` or ``lane_vec``) or shared with a per-lane f.b, and no
    anderson, exact-tol or verbose > 1.  float32 on CUDA selects it by
    default; ``use_fused=True`` forces it (float64 and the CPU's plain
    version included) and raises ``ValueError`` on a batch it cannot take;
    ``use_fused=False`` opts out.
    """
    if settings.use_fused is False:
        return False
    supported = (
        e_kind == "shared"
        and c_kind in ("lane_scalar", "lane_vec", "shared")
        and not (c_kind == "shared" and fb_kind == "shared")
        and fused_admm_supported(settings)
        and dtype in (torch.float32, torch.float64)
    )
    if settings.use_fused:
        if not supported:
            raise ValueError(
                "use_fused=True but the batched kernel does not take this batch "
                "(needs a shared g.e, a per-lane g.c or f.b, and no "
                "anderson/exact-tol/verbose>1)")
        return True
    return supported and dtype == torch.float32 and torch.device(device).type == "cuda"


def _matrix(A, device) -> torch.Tensor:
    """A as a dense tensor on ``device``: float64 input solves in float64,
    anything else in float32, as ``GraphFormSolver``."""
    if is_sparse_input(A):
        # As in the JAX package, whose batches take A through jnp.asarray.
        raise NotImplementedError(
            "batched solves take a dense A: the JAX package takes no sparse A here either")
    A_t = A if isinstance(A, torch.Tensor) else torch.as_tensor(np.asarray(A))
    dtype = torch.float64 if A_t.dtype == torch.float64 else torch.float32
    return A_t.to(device=device, dtype=dtype)


def _params(fv: FunctionVector, dt, dev):
    return tuple(torch.as_tensor(p).to(device=dev, dtype=dt) for p in fv.params)


def _batch_arg(arr, K: int, length: int, dt, dev, per_lane_scalar_ok=True):
    """(tensor, kind) of one batch argument, in its natural shape: a per-lane
    scalar stays (K,), a per-lane vector is (K, length)."""
    if arr is None:
        return None, "shared"
    t = torch.as_tensor(arr).to(device=dev, dtype=dt)
    if t.dim() == 1 and per_lane_scalar_ok:
        if t.shape[0] != K:
            raise ValueError(f"a per-lane scalar batch must be ({K},), not {tuple(t.shape)}")
        return t, "lane_scalar"
    if tuple(t.shape) != (K, length):
        raise ValueError(f"a per-lane batch must be {(K, length)}, not {tuple(t.shape)}")
    return t, "lane_vec"


def _lanes(t, kind, shared, K, length):
    """The (K, length) per-lane values of a batch argument, broadcast on the
    device."""
    if kind == "shared":
        return shared.expand(K, length)
    if kind == "lane_scalar":
        return t[:, None].expand(K, length)
    return t


def batched_graph_solve(
    A,
    f: FunctionVector,
    g: FunctionVector,
    g_c_batch=None,
    g_e_batch=None,
    f_b_batch=None,
    settings: Optional[SolverSettings] = None,
    device=None,
):
    """Solve min f_k(y) + g_k(x) s.t. y = Ax for a batch of parameter
    overrides: ``g_c_batch[k]`` replaces g.c and ``g_e_batch[k]`` replaces
    g.e (regularisation sweeps; each (K,) or (K, n)), ``f_b_batch[k]``
    replaces f.b (multi-right-hand-side; (K, m)).

    One init serves every lane.  A batch the batched kernel takes runs as
    one launch of it (``_fused_batch_eligible``); any other runs lane after
    lane, each from a cold start, through the single-solve path: the solve
    kernel on CUDA where it applies, the eager loop elsewhere.  Both report
    each lane's iterate, objective, iteration count and status from the
    iteration at which that lane stopped.  So does the JAX package's
    vmapped loop: its batched while-loop leaves a finished lane unchanged,
    and the tests hold the port to it lane for lane.

    Returns a dict of tensors: x (K, n), y (K, m), optval, iterations and
    status, each (K,).
    """
    settings = settings or SolverSettings()
    dev = resolve_device(A, device)
    A = _matrix(A, dev)
    dt = A.dtype
    m, n = A.shape
    if g_c_batch is not None:
        K = len(g_c_batch)
    elif f_b_batch is not None:
        K = len(f_b_batch)
    else:
        raise ValueError("provide at least one of g_c_batch / f_b_batch")
    if f.n != m or g.n != n:
        raise ValueError(f"f and g have lengths {f.n}, {g.n}, expected {m}, {n}")

    c_arg, c_kind = _batch_arg(g_c_batch, K, n, dt, dev)
    e_arg, e_kind = _batch_arg(g_e_batch, K, n, dt, dev)
    fb_arg, fb_kind = _batch_arg(f_b_batch, K, m, dt, dev, per_lane_scalar_ok=False)
    fused = _fused_batch_eligible(dt, dev, settings, c_kind, e_kind, fb_kind)

    with highest_precision():
        eq = equilibrate(A)
        norm_A = norm2_est(eq.A)
        factor = DirectProjector("inverse").init(eq.A, s=1.0)
        fa, fb, fc, fd, fe = _params(f, dt, dev)
        ga, gb, gc, gd, ge = _params(g, dt, dev)
        rho0 = torch.as_tensor(settings.rho, dtype=dt, device=dev)
        if fused:
            # scale_f and scale_g leave b and c alone, so the lanes' raw c
            # and b feed the kernel.
            f_s = scale_f(_fv(f.h, (fa, fb, fc, fd, fe)), eq.d)
            g_s = scale_g(_fv(g.h, (ga, gb, gc, gd, ge)), eq.e)
            out = fused_batched_lasso_sweep(
                eq.A, factor["op"], norm_A, f.h, tuple(f_s.params), g.h,
                tuple(g_s.params), _lanes(c_arg, c_kind, gc, K, n), settings, rho0,
                fb_batch=fb_arg if fb_kind == "lane_vec" else None)
            return {
                "x": out["x12"] * eq.e[None, :],
                "y": out["y12"] / eq.d[None, :],
                "optval": out["optval"],
                "iterations": out["final_iter"],
                "status": out["status"],
            }

        cs = _lanes(c_arg, c_kind, gc, K, n)
        es = _lanes(e_arg, e_kind, ge, K, n)
        fbs = _lanes(fb_arg, fb_kind, fb, K, m)
        kernel = _use_fused(dt, dev, settings, "inverse")
        At = eq.A.T.contiguous() if kernel else None
        projector = DirectProjector("inverse")
        z0 = torch.zeros(m + n, dtype=dt, device=dev)
        lanes = []
        for k in range(K):
            f_s = scale_f(_fv(f.h, (fa, fbs[k], fc, fd, fe)), eq.d)
            g_s = scale_g(_fv(g.h, (ga, gb, cs[k], gd, es[k])), eq.e)
            if kernel:
                out = fused_admm_loop(eq.A, factor["op"], norm_A, f.h, tuple(f_s.params),
                                      g.h, tuple(g_s.params), settings, z0, z0, rho0,
                                      At=At)
            else:
                out = admm_loop(
                    eq.A, norm_A, eq.d, eq.e,
                    lambda x_in, y_in, rho, f_s=f_s, g_s=g_s: (
                        prox_eval(g_s, x_in, rho), prox_eval(f_s, y_in, rho)),
                    lambda x12, y12, f_s=f_s, g_s=g_s: (
                        func_eval(f_s, y12) + func_eval(g_s, x12)),
                    lambda px, py, tol, xw: projector.project(eq.A, factor, px, py),
                    settings, z0, z0, rho0)
            lanes.append(out)
    return {
        "x": torch.stack([o["x12"] for o in lanes]) * eq.e[None, :],
        "y": torch.stack([o["y12"] for o in lanes]) / eq.d[None, :],
        "optval": torch.stack([o["optval"] for o in lanes]),
        "iterations": torch.stack([o["final_iter"] for o in lanes]),
        "status": torch.stack([o["status"] for o in lanes]),
    }


def warm_path_graph_solve(
    A,
    f: FunctionVector,
    g: FunctionVector,
    g_c_batch,
    settings: Optional[SolverSettings] = None,
    device=None,
):
    """A warm-started regularisation path: step k solves with g.c =
    ``g_c_batch[k]`` ((K,) or (K, n)) from the previous step's final
    iterate, scaled dual and ρ (the reference's LassoPath pattern), so a
    fine grid costs far fewer iterations than independent solves.  Order the
    λ values the way a path should be walked (large to small for lasso).

    Each step is one launch of the solve kernel where the single-solve path
    would take it (CUDA), and the eager loop otherwise.  (z, z̃, ρ) stay on
    the device from step to step, so the kernel path makes no host sync
    until the caller reads the results.  Returns a dict of stacked tensors:
    x (K, n), optval, iterations and status, each (K,).
    """
    settings = settings or SolverSettings()
    dev = resolve_device(A, device)
    A = _matrix(A, dev)
    dt = A.dtype
    m, n = A.shape
    K = len(g_c_batch)
    c_arg, c_kind = _batch_arg(g_c_batch, K, n, dt, dev)
    kernel = _use_fused(dt, dev, settings, "inverse")
    projector = DirectProjector("inverse" if kernel else "cholesky")

    with highest_precision():
        eq = equilibrate(A)
        norm_A = norm2_est(eq.A)
        factor = projector.init(eq.A, s=1.0)
        At = eq.A.T.contiguous() if kernel else None
        f_s = scale_f(_fv(f.h, _params(f, dt, dev)), eq.d)
        ga, gb, gc, gd, ge = _params(g, dt, dev)
        cs = _lanes(c_arg, c_kind, gc, K, n)
        z = torch.zeros(m + n, dtype=dt, device=dev)
        zt = z
        rho = torch.as_tensor(settings.rho, dtype=dt, device=dev)
        steps = []
        for k in range(K):
            g_s = scale_g(_fv(g.h, (ga, gb, cs[k], gd, ge)), eq.e)
            if kernel:
                out = fused_admm_loop(eq.A, factor["op"], norm_A, f.h, tuple(f_s.params),
                                      g.h, tuple(g_s.params), settings, z, zt, rho, At=At)
            else:
                out = admm_loop(
                    eq.A, norm_A, eq.d, eq.e,
                    lambda x_in, y_in, r, g_s=g_s: (
                        prox_eval(g_s, x_in, r), prox_eval(f_s, y_in, r)),
                    lambda x12, y12, g_s=g_s: func_eval(f_s, y12) + func_eval(g_s, x12),
                    lambda px, py, tol, xw: projector.project(eq.A, factor, px, py, tol, xw),
                    settings, z, zt, rho)
            z, zt, rho = out["z"], out["zt"], out["rho"]
            steps.append(out)
    return {
        "x": torch.stack([o["x12"] for o in steps]) * eq.e[None, :],
        "optval": torch.stack([o["optval"] for o in steps]),
        "iterations": torch.stack([o["final_iter"] for o in steps]),
        "status": torch.stack([o["status"] for o in steps]),
    }


def solve_lasso_path(
    A,
    b,
    lambdas,
    settings: Optional[SolverSettings] = None,
    warm: bool = False,
    device=None,
):
    """The lasso λ-path min ½‖Ax − b‖² + λ‖x‖₁ for every λ in ``lambdas``:
    independent lanes by default (``batched_graph_solve``), or warm-started
    one after another (``warm=True``, ``warm_path_graph_solve``; order the
    λ values large to small)."""
    dev = resolve_device(A, device)
    A = _matrix(A, dev)
    m, n = A.shape
    b = torch.as_tensor(b).reshape(-1)
    f = FunctionVector(Function.SQUARE, m, b=b, dtype=A.dtype)
    g = FunctionVector(Function.ABS, n, dtype=A.dtype)
    if warm:
        return warm_path_graph_solve(A, f, g, lambdas, settings=settings, device=dev)
    return batched_graph_solve(A, f, g, lambdas, settings=settings, device=dev)
