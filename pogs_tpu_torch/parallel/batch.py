"""Batched solves: λ-sweeps, multi-right-hand-side sweeps, warm-started
λ-paths, and batched and warm-path cone and QP solves, on one GPU or with
the lanes spread over a mesh.

Counterpart of ``pogs_tpu/parallel/batch.py``.  In the graph form all lanes
share one init: equilibration, the ‖A‖₂ estimate and the explicit
(Gram + I)⁻¹ of the direct projector.  Lane k then solves the problem with
its own g.c, g.e or f.b:

  * a sweep the batched kernel takes (per-lane c and/or f.b, shared e) runs
    as ONE launch of ``ops.fused_admm_batch.fused_batched_lasso_sweep``;
  * any other batch runs lane after lane from the shared init, each from a
    cold start, through the single-solve path (the solve kernel on CUDA,
    the eager loop elsewhere) — where the JAX package vmaps the loop.

The warm λ-path walks the λ values in order and carries (z, z̃, ρ) on the
device from one step to the next.

The cone batches (``batched_cone_solve``, ``warm_path_cone_solve``,
``batched_qp_solve``) equilibrate once, with the cone-averaging hook, and
factor the Gram inverse once; each lane then makes its own SMW vectors and
runs one HSDE solve: one launch of the cone kernel on CUDA where it applies
(``ops/fused_hsde.py``), else the eager loop (its plain version), lane after
lane, where the JAX package vmaps the loop.  A lane's result does not
depend on K.

With ``mesh=`` (``parallel/mesh.py``) the lanes split into contiguous
blocks over the mesh's ``batch_axis``; every rank keeps the whole A and
makes the shared init, as the JAX package replicates A and shards the batch
axis.  Each rank's block runs as above: one launch of the batched kernel,
or its cone-kernel launches, or the eager loop.  The lanes never talk to
each other, so a lane's result does not depend on which rank holds it; the
results come back whole on every rank, gathered over the batch axis by one
all_reduce each.  Ranks that differ on the other axes solve the same lanes.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from pogs_tpu_torch.types import (
    Cone, ConeConstraint, Function, FunctionVector, SolverSettings, Status,
)
from pogs_tpu_torch.cones.sets import ConeSet
from pogs_tpu_torch.prox.vector import prox_eval, func_eval, scale_f, scale_g
from pogs_tpu_torch.linalg.equil import equilibrate
from pogs_tpu_torch.linalg.norm import norm2_est
from pogs_tpu_torch.projector.direct import DirectProjector
from pogs_tpu_torch.solver.admm import admm_loop
from pogs_tpu_torch.linalg.matrix import is_sharded, is_sparse_input
from pogs_tpu_torch.solver.graph import _use_fused, resolve_device
from pogs_tpu_torch.ops.fused_admm import _fv, fused_admm_loop, fused_admm_supported
from pogs_tpu_torch.ops.fused_admm_batch import fused_batched_lasso_sweep
from pogs_tpu_torch.ops.fused_hsde import fused_hsde_eligible, fused_hsde_solve
from pogs_tpu_torch.solver.cone import epigraph_extension, epigraph_factor, smw_factor_from
from pogs_tpu_torch.solver.hsde import hsde_solve
from pogs_tpu_torch.solver.qp_polish import active_set_polish, row_kinds
from pogs_tpu_torch.utils.precision import highest_precision
from pogs_tpu_torch.utils.profiling import span
from pogs_tpu_torch.parallel.mesh import all_reduce, split_bounds


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
    if is_sharded(A):
        raise TypeError("batched solves take the whole A on every rank; a mesh's "
                        "batch axis splits the lanes")
    if is_sparse_input(A):
        # As in the JAX package, whose batches take A through jnp.asarray.
        raise NotImplementedError(
            "batched solves take a dense A: the JAX package takes no sparse A here either")
    A_t = A if isinstance(A, torch.Tensor) else torch.as_tensor(np.asarray(A))
    dtype = torch.float64 if A_t.dtype == torch.float64 else torch.float32
    return A_t.to(device=device, dtype=dtype)


def _lane_block(mesh, batch_axis: str, K: int):
    """[lo, hi) of the lanes this rank solves: all of them without a mesh.
    Every rank of the batch axis takes at least one lane."""
    if mesh is None:
        return 0, K
    mesh.check_axis(batch_axis)
    if K < mesh.size(batch_axis):
        raise ValueError(f"{K} lanes over a batch axis of {mesh.size(batch_axis)} ranks: "
                         "every rank needs a lane")
    return split_bounds(K, mesh.size(batch_axis), mesh.index(batch_axis))


def _gather_lanes(mesh, batch_axis: str, out: dict, K: int, lo: int) -> dict:
    """Each (k, ...) tensor of ``out`` (this rank's lanes from ``lo``) whole
    as (K, ...) on every rank: a zero-padded buffer summed over the batch
    axis."""
    if mesh is None:
        return out
    group = mesh.group(batch_axis)
    whole = {}
    for key, v in out.items():
        buf = torch.zeros((K,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
        buf[lo:lo + v.shape[0]] = v
        whole[key] = all_reduce(buf, group)
    return whole


def _mesh_device(mesh, device):
    return device if device is not None or mesh is None else mesh.device


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
    mesh=None,
    batch_axis: str = "batch",
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

    With ``mesh`` the lanes split over ``batch_axis`` (see the module
    note): each rank's block is one launch of the batched kernel where it
    applies.

    Returns a dict of tensors: x (K, n), y (K, m), optval, iterations and
    status, each (K,).
    """
    with span("pogs.call"):
        settings = settings or SolverSettings()
        dev = resolve_device(A, _mesh_device(mesh, device))
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
        lo, hi = _lane_block(mesh, batch_axis, K)
        if mesh is not None:
            # This rank's lanes; the shared arguments stay as they are.
            K_all, K = K, hi - lo
            c_arg = c_arg if c_kind == "shared" else c_arg[lo:hi]
            e_arg = e_arg if e_kind == "shared" else e_arg[lo:hi]
            fb_arg = fb_arg if fb_kind == "shared" else fb_arg[lo:hi]
            out = batched_graph_solve(A, f, g, c_arg if c_kind != "shared" else None,
                                      e_arg if e_kind != "shared" else None,
                                      fb_arg if fb_kind != "shared" else None,
                                      settings=settings, device=dev)
            return _gather_lanes(mesh, batch_axis, out, K_all, lo)

        with highest_precision():
            with span("pogs.init"):
                with span("pogs.init.equilibrate"):
                    eq = equilibrate(A)
                with span("pogs.init.norm_est"):
                    norm_A = norm2_est(eq.A)
                with span("pogs.init.factor"):
                    factor = DirectProjector("inverse").init(eq.A, s=1.0)
            # The host work before the lanes run: on the batched kernel's path to
            # its wrapper's return, which on a CUDA tensor is the launch.
            with span("pogs.prepare"):
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
            if fused:
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
    mesh=None,
    warm: bool = False,
    device=None,
):
    """The lasso λ-path min ½‖Ax − b‖² + λ‖x‖₁ for every λ in ``lambdas``:
    independent lanes by default (``batched_graph_solve``, spread over
    ``mesh``'s ``batch`` axis when given), or warm-started one after
    another (``warm=True``, ``warm_path_graph_solve``; order the λ values
    large to small), which runs on one device and takes no mesh."""
    with span("pogs.call"):
        if warm and mesh is not None:
            raise ValueError(
                "warm=True runs a sequential path on one device; mesh "
                "sharding applies to the independent (warm=False) batch")
        dev = resolve_device(A, _mesh_device(mesh, device))
        A = _matrix(A, dev)
        m, n = A.shape
        b = torch.as_tensor(b).reshape(-1)
        f = FunctionVector(Function.SQUARE, m, b=b, dtype=A.dtype)
        g = FunctionVector(Function.ABS, n, dtype=A.dtype)
        if warm:
            return warm_path_graph_solve(A, f, g, lambdas, settings=settings, device=dev)
        return batched_graph_solve(A, f, g, lambdas, settings=settings, mesh=mesh, device=dev)


# ---------------------------------------------------------------------------
# Batched and warm-path cone solves.
# ---------------------------------------------------------------------------

class _ConeLanes:
    """One init for a batch of cone problems on a dense A: equilibration
    with the cone-averaging hook and the Gram inverse; ``solve`` runs one
    lane's HSDE solve from its scaled data."""

    def __init__(self, A, Ky, settings: SolverSettings, strategy: str, device):
        self.dev = resolve_device(A, device)
        A = _matrix(A, self.dev)
        self.dt = A.dtype
        self.m, self.n = A.shape
        if self.dt == torch.float32 and min(settings.abs_tol, settings.rel_tol) < 1e-5:
            warnings.warn(
                "tolerances below 1e-5 sit at the float32 accuracy floor; "
                "borderline lanes may report MAX_ITER at the optimum", stacklevel=3)
        Ky = [c if isinstance(c, ConeConstraint) else ConeConstraint(*c) for c in Ky]
        self.Ky = ConeSet(Ky, self.m)
        self.settings, self.strategy = settings, strategy
        # The cone kernel takes the lanes on CUDA where it applies; the eager
        # loop (its plain version) everywhere else, and when use_fused=False.
        self.kernel = (strategy == "smw" and self.dev.type == "cuda"
                       and settings.use_fused is not False
                       and fused_hsde_eligible(self.dt, self.Ky, False, settings.use_anderson))
        with highest_precision():
            self.eq = equilibrate(A, constrain_d=self.Ky.constrain_average)
            self.Kinv = (DirectProjector("inverse").init(self.eq.A, s=1.0)["op"]
                         if strategy == "smw" else None)
        self.At = self.eq.A.T.contiguous() if self.kernel else None

    def tensor(self, v):
        return torch.as_tensor(np.asarray(v), dtype=self.dt, device=self.dev)

    def solve(self, b_s, c_s, u0=None):
        st, A = self.settings, self.eq.A
        with highest_precision():
            fac = None if self.Kinv is None else smw_factor_from(A, self.Kinv, b_s, c_s)
            if self.kernel:
                return fused_hsde_solve(A, b_s, c_s, self.Ky, self.Kinv, fac["t_x"], fac["t_y"],
                                        fac["s_den"], st.abs_tol, st.rel_tol, st.max_iter,
                                        u0=u0, At=self.At)
            return hsde_solve(A, b_s, c_s, self.Ky, strategy=self.strategy,
                              abs_tol=st.abs_tol, rel_tol=st.rel_tol, max_iter=st.max_iter,
                              smw_factor=fac, use_anderson=st.use_anderson,
                              anderson_mem=st.anderson_mem, anderson_start=st.anderson_start,
                              u0=u0)

    def unscale(self, out, b_orig, b_s, c_orig):
        """x, y, ν and c'x of one lane; zero where τ ≈ 0 (no certificate ray
        comes back from a batch, as in the JAX package)."""
        m, n = self.m, self.n
        w = out["w"]
        tau = w[n + m]
        ok = tau > 1e-8
        tau_safe = torch.where(ok, tau, torch.ones_like(tau))
        x_s, y_s = w[:n] / tau_safe, w[n:n + m] / tau_safe
        zero_n, zero_m = torch.zeros_like(x_s), torch.zeros_like(y_s)
        s_orig = (b_s - torch.mv(self.eq.A, x_s)) / self.eq.d
        x = torch.where(ok, x_s * self.eq.e, zero_n)
        return {"x": x, "y": torch.where(ok, b_orig - s_orig, zero_m),
                "nu": torch.where(ok, y_s * self.eq.d, zero_m), "optval": torch.dot(c_orig, x),
                "iterations": out["final_iter"], "status": out["status"]}


def _stack(lanes, keys):
    return {key: torch.stack([lane[key] for lane in lanes]) for key in keys}


def batched_cone_solve(
    A,
    b_batch,
    c_batch,
    Ky,
    settings: Optional[SolverSettings] = None,
    strategy: str = "smw",
    mesh=None,
    batch_axis: str = "batch",
    device=None,
):
    """Solve a batch of cone problems  min c_k'x  s.t.  b_k − A x ∈ K_y
    sharing one matrix and cone structure (scenario LPs, MPC over initial
    states): equilibrate and factor once, then one HSDE solve per lane (one
    cone-kernel launch each on CUDA where it applies).

    ``b_batch``: (K, m); ``c_batch``: (K, n) or (n,) for every lane.  With
    ``mesh`` the lanes split over ``batch_axis`` (see the module note).
    Returns a dict of tensors: x (K, n), y (K, m), nu (K, m), optval,
    iterations and status, each (K,).
    """
    lanes = _ConeLanes(A, Ky, settings or SolverSettings(), strategy,
                       _mesh_device(mesh, device))
    bs = lanes.tensor(b_batch)
    cs = lanes.tensor(c_batch)
    K = bs.shape[0]
    if cs.dim() == 1:
        cs = cs.expand(K, -1)
    lo, hi = _lane_block(mesh, batch_axis, K)
    eq = lanes.eq
    out = []
    for k in range(lo, hi):
        b_s, c_s = bs[k] * eq.d, cs[k] * eq.e
        out.append(lanes.unscale(lanes.solve(b_s, c_s), bs[k], b_s, cs[k]))
    out = _stack(out, ("x", "y", "nu", "optval", "iterations", "status"))
    return _gather_lanes(mesh, batch_axis, out, K, lo)


def warm_path_cone_solve(
    A,
    b_batch,
    c,
    Ky,
    settings: Optional[SolverSettings] = None,
    strategy: str = "smw",
    device=None,
):
    """A warm-started sequence of cone problems min cᵀx s.t. b_k − Ax ∈ K_y
    whose b_k drift gradually (MPC steps, scenario sweeps): the HSDE
    embedding u carries from one step to the next (the first starts from
    e_τ), on the device, so each problem starts on the previous solution
    ray.

    ``b_batch``: (K, m); ``c``: (n,).  Returns a dict of tensors: x (K, n),
    optval, iterations and status, each (K,).
    """
    lanes = _ConeLanes(A, Ky, settings or SolverSettings(), strategy, device)
    bs = lanes.tensor(b_batch)
    c_orig = lanes.tensor(c)
    m, n, eq = lanes.m, lanes.n, lanes.eq
    c_s = c_orig * eq.e
    u = torch.zeros(n + m + 1, dtype=lanes.dt, device=lanes.dev)
    u[n + m] = 1.0
    out = []
    for k in range(bs.shape[0]):
        b_s = bs[k] * eq.d
        res = lanes.solve(b_s, c_s, u0=u)
        u = res["u"]
        out.append(lanes.unscale(res, bs[k], b_s, c_orig))
    return _stack(out, ("x", "optval", "iterations", "status"))


def batched_qp_solve(
    A,
    P_qp,
    b_batch,
    c_batch,
    Ky,
    settings: Optional[SolverSettings] = None,
    strategy: str = "smw",
    mesh=None,
    batch_axis: str = "batch",
    polish: bool = True,
    device=None,
):
    """Solve a batch of QPs  min c_kᵀx + ½xᵀPx  s.t.  b_k − Ax ∈ K_y
    sharing one (A, P, K_y): scenario MPC with quadratic stage costs,
    parameter sweeps over tracking targets.

    The epigraph rotated-SOC extension of ``ConeSolver``'s QP route is built
    once (P = LtᵀLt by the host eigh; rows [A | 0; t-rows; √2·Lt]); lanes
    differ in the extended (b, c) only, and run through
    ``batched_cone_solve``.  With ``polish`` and a polyhedral K_y each
    SUCCESS or MAX_ITER lane then gets the host f64 PDAS polish, once, at
    the end of its solve, as in the JAX package.

    ``b_batch``: (K, m); ``c_batch``: (K, n) or (n,).  With ``mesh`` the
    cone solves split over ``batch_axis`` and every rank polishes every
    lane, on the host.  Returns a dict of numpy arrays: x (K, n), nu (K, m),
    optval, iterations, status and polished, each (K,).
    """
    settings = settings or SolverSettings()
    if isinstance(A, torch.Tensor):
        A = A.detach().cpu()
    A = np.asarray(A, np.float64)
    m, n = A.shape
    P64 = np.asarray(P_qp, np.float64)
    P64 = (P64 + P64.T) / 2
    if P64.shape != (n, n):
        raise ValueError(f"P must be {n}x{n}")
    b_batch = np.asarray(b_batch, np.float64)
    K = b_batch.shape[0]
    c_batch = np.asarray(c_batch, np.float64)
    c_shared = c_batch.ndim == 1

    A_ext, r = epigraph_extension(A, epigraph_factor(P64)[0])
    tail = np.concatenate([[1.0, -1.0], np.zeros(r)])
    b_ext = np.concatenate([b_batch, np.broadcast_to(tail, (K, r + 2))], axis=1)
    if c_shared:
        c_ext = np.concatenate([c_batch, [1.0]])
    else:
        c_ext = np.concatenate([c_batch, np.ones((K, 1))], axis=1)
    Ky = [c if isinstance(c, ConeConstraint) else ConeConstraint(*c) for c in Ky]
    Ky_ext = list(Ky) + [ConeConstraint(Cone.SOC, range(m, m + r + 2))]

    out = batched_cone_solve(A_ext, b_ext, c_ext, Ky_ext, settings=settings,
                             strategy=strategy, mesh=mesh, batch_axis=batch_axis,
                             device=device)
    x = out["x"][:, :n].cpu().double().numpy().copy()
    nu = out["nu"][:, :m].cpu().double().numpy().copy()
    status = out["status"].cpu().numpy().copy()
    iterations = out["iterations"].cpu().numpy()
    optval = np.einsum("kn,kn->k", x, x @ P64) * 0.5
    optval = optval + (x @ c_batch if c_shared else np.einsum("kn,kn->k", c_batch, x))
    polished = np.zeros(K, bool)
    kind = row_kinds(m, Ky) if polish else None
    if kind is not None:
        tol = float(max(settings.abs_tol, settings.rel_tol))
        for k in range(K):
            if status[k] not in (Status.SUCCESS, Status.MAX_ITER):
                continue
            ck = c_batch if c_shared else c_batch[k]
            pol = active_set_polish(P64, ck, A, b_batch[k], kind, x[k], nu[k], tol)
            if pol is not None:
                x[k] = pol["x"]
                nu[k] = pol["lam"]
                status[k] = Status.SUCCESS
                optval[k] = ck @ x[k] + 0.5 * x[k] @ P64 @ x[k]
                polished[k] = True
    return {"x": x, "nu": nu, "optval": optval, "iterations": iterations,
            "status": status, "polished": polished}
