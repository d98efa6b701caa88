"""Cone-form problem API with SCS-style dims.

Counterpart of ``pogs_tpu/api/cone.py``.

    solve_cone_problem(c, A, b, dims)  solves
        minimize    c'x (+ ½ x'P x)
        subject to  b − A x ∈ K,   K given by dims:
            f: #equality rows (zero cone)      l: #inequality rows (R₊)
            q: list of SOC sizes               s: list of SDP block sizes
            ep/ed: #primal/dual exp cones

A may be dense or sparse (a scipy matrix or a sparse torch tensor): a
sparse A reaches ConeSolver as it is, kept sparse or densified by
``sparse_policy``.  A quadratic objective (P, dense or a length-n diagonal)
is solved by one of ConeSolver's QP routes (``qp_via``), not by putting P
in the embedding, whose fixed point is not the QP optimum.
"""

from __future__ import annotations

import hashlib
import time
from typing import Optional, Sequence

import numpy as np
import torch

from pogs_tpu_torch.types import Cone, ConeConstraint, SolverSettings, Status
from pogs_tpu_torch.linalg.matrix import _torch_coo, is_sparse_input
from pogs_tpu_torch.solver.cone import ConeSolver

# solve_cone_problem's solvers, keyed by a fingerprint of the matrix.
_CONE_PROBLEM_SOLVERS: dict = {}


def _host_coo(A) -> torch.Tensor:
    """A scipy matrix or a sparse torch tensor as a coalesced float64 COO
    tensor on the CPU."""
    return _torch_coo(A, torch.float64, "cpu")


def dims_to_cones(dims: dict) -> list:
    """SCS-style dims dict → list of ConeConstraint on the y rows, in the
    order f, l, q, s, ep, ed."""
    cones = []
    offset = 0
    nf = int(dims.get("f", 0) or 0)
    if nf > 0:
        cones.append(ConeConstraint(Cone.ZERO, range(offset, offset + nf)))
        offset += nf
    nl = int(dims.get("l", 0) or 0)
    if nl > 0:
        cones.append(ConeConstraint(Cone.NON_NEG, range(offset, offset + nl)))
        offset += nl
    for q_dim in dims.get("q") or []:
        cones.append(ConeConstraint(Cone.SOC, range(offset, offset + int(q_dim))))
        offset += int(q_dim)
    for s_dim in dims.get("s") or []:
        vec = int(s_dim) * (int(s_dim) + 1) // 2
        cones.append(ConeConstraint(Cone.SDP, range(offset, offset + vec)))
        offset += vec
    for _ in range(int(dims.get("ep", 0) or 0)):
        cones.append(ConeConstraint(Cone.EXP_PRIMAL, range(offset, offset + 3)))
        offset += 3
    for _ in range(int(dims.get("ed", 0) or 0)):
        cones.append(ConeConstraint(Cone.EXP_DUAL, range(offset, offset + 3)))
        offset += 3
    return cones


def auto_rho(A, b, c, dims: dict, P=None, mode: Optional[str] = None,
             scale: Optional[float] = None) -> float:
    """Auto-ρ: ‖c‖/‖b‖ clamped to [1e-3, 1e3], or ‖c‖/(‖b‖‖A‖_F) clamped to
    [1e-4, 10] for SOC / SDP / exponential / QP problems."""
    norm_c = float(np.linalg.norm(c))
    norm_b = float(np.linalg.norm(b))
    has_nonsep = bool(dims.get("q")) or bool(dims.get("s")) \
        or int(dims.get("ep", 0) or 0) > 0 or int(dims.get("ed", 0) or 0) > 0
    if mode is None or mode == "auto":
        mode = "ratio_normA" if (has_nonsep or P is not None) else "ratio"
    if mode == "ratio_normA":
        if hasattr(A, "power"):  # scipy sparse
            norm_A = float(np.sqrt(A.power(2).sum()))
        elif is_sparse_input(A):
            norm_A = float(torch.linalg.vector_norm(_host_coo(A).values()))
        else:
            norm_A = float(np.linalg.norm(np.asarray(A)))
        if norm_b > 1e-10 and norm_c > 1e-10 and norm_A > 1e-10:
            rho = min(max(norm_c / (norm_b * norm_A), 1e-4), 1e1)
        else:
            rho = 1.0
    elif mode == "ratio":
        if norm_b > 1e-10 and norm_c > 1e-10:
            rho = min(max(norm_c / norm_b, 1e-3), 1e3)
        else:
            rho = 1.0
    else:
        raise ValueError(f"unknown rho_mode {mode!r}")
    if scale not in (None, 1.0):
        rho *= scale
    return rho


def solve_cone(
    A,
    b,
    c,
    Kx: Sequence[ConeConstraint] = (),
    Ky: Sequence[ConeConstraint] = (),
    P=None,
    rho: Optional[float] = None,
    abs_tol: float = 1e-4,
    rel_tol: float = 1e-4,
    max_iter: int = 2500,
    verbose: int = 0,
    adaptive_rho: bool = True,
    dtype=None,
    strategy: Optional[str] = None,
    solver: Optional[ConeSolver] = None,
    assume_svec: bool = False,
    warm_start: bool = False,
    polish: bool = True,
    use_fused: Optional[bool] = None,
    device=None,
    sparse_policy: str = "auto",
    qp_via: str = "socp",
):
    """General cone-form solve; returns the reference result-dict contract
    (numpy arrays)."""
    settings = SolverSettings(
        abs_tol=abs_tol, rel_tol=rel_tol, max_iter=max_iter, verbose=verbose,
        adaptive_rho=adaptive_rho, rho=rho if rho is not None else 1.0,
        polish=polish, use_fused=use_fused,
    )
    if solver is None:
        solver = ConeSolver(A, Kx=Kx, Ky=Ky, settings=settings, strategy=strategy,
                            dtype=dtype, assume_svec=assume_svec, qp_via=qp_via,
                            device=device, sparse_policy=sparse_policy)
    if rho is not None:
        solver.rho = float(rho)
    t0 = time.perf_counter()
    res = solver.solve(b, c, P=P, settings=settings, warm_start=warm_start)
    x = res.x.cpu().numpy()
    y = res.y.cpu().numpy()
    nu = res.nu.cpu().numpy()
    solve_time = time.perf_counter() - t0

    out = {
        "x": x,
        "y": y,
        "l": nu,
        "z": nu,
        "optval": float(res.optval),
        "iterations": int(res.final_iter),
        "num_iters": int(res.final_iter),
        "status": int(res.status),
        "status_name": Status(int(res.status)).name,
        "solve_time": solve_time,
        "abs_tol": abs_tol,
        "rel_tol": rel_tol,
    }
    out["s"] = np.asarray(b) - y
    # Primal residual diagnostic.
    if isinstance(A, torch.Tensor) and is_sparse_input(A):
        Ax = (_host_coo(A) @ torch.from_numpy(x).double()).numpy()
    else:
        Ax = A @ x if is_sparse_input(A) else np.asarray(A) @ x
    r = Ax - y
    out["primal_res"] = float(np.linalg.norm(r))
    eps_pri = float(np.sqrt(len(y)) * abs_tol
                    + rel_tol * max(np.linalg.norm(x), np.linalg.norm(y)))
    out["eps_pri"] = eps_pri
    if eps_pri > 0:
        out["primal_res_ratio"] = out["primal_res"] / eps_pri
    return out


def solve_cone_problem(
    c,
    A,
    b,
    dims: dict,
    P=None,
    rho: Optional[float] = None,
    rho_mode: Optional[str] = None,
    rho_scale: Optional[float] = None,
    abs_tol: float = 1e-4,
    rel_tol: float = 1e-4,
    max_iter: int = 2500,
    verbose: int = 0,
    dtype=None,
    device=None,
    sparse_policy: str = "auto",
    **kw,
):
    """SCS-style entry point: c, A, b, dims.  The ConeSolver (equilibration
    and factor) is reused across calls with the same matrix, cones, dtype,
    device and options; a sparse A (scipy or torch) stays sparse."""
    sparse = is_sparse_input(A)
    if not sparse:
        A = np.asarray(A)
    cones_y = dims_to_cones(dims)
    if rho is None:
        rho = auto_rho(A, b, c, dims, P=P, mode=rho_mode, scale=rho_scale)
    solver = kw.pop("solver", None)
    if solver is None:
        h = hashlib.sha256()
        h.update(str(tuple(A.shape)).encode())
        if sparse:
            # A sparse matrix by its coordinates and values.
            C = _host_coo(A)
            for part in (C.indices(), C.values()):
                h.update(part.numpy().tobytes())
        else:
            h.update(np.ascontiguousarray(A).tobytes())
        key = (h.hexdigest(), tuple((int(cc.cone), cc.indices) for cc in cones_y),
               str(dtype), str(device), kw.get("assume_svec", False), kw.get("strategy"),
               sparse_policy, kw.get("qp_via", "socp"))
        solver = _CONE_PROBLEM_SOLVERS.get(key)
        if solver is None:
            if len(_CONE_PROBLEM_SOLVERS) > 8:
                _CONE_PROBLEM_SOLVERS.clear()
            settings = SolverSettings(abs_tol=abs_tol, rel_tol=rel_tol,
                                      max_iter=max_iter, verbose=verbose)
            solver = ConeSolver(A, Ky=cones_y, settings=settings,
                                strategy=kw.get("strategy"), dtype=dtype,
                                assume_svec=kw.get("assume_svec", False),
                                qp_via=kw.get("qp_via", "socp"), device=device,
                                sparse_policy=sparse_policy)
            _CONE_PROBLEM_SOLVERS[key] = solver
    return solve_cone(
        A, b, c, Ky=cones_y, P=P, rho=rho, abs_tol=abs_tol, rel_tol=rel_tol,
        max_iter=max_iter, verbose=verbose, dtype=dtype, solver=solver,
        device=device, **kw,
    )
