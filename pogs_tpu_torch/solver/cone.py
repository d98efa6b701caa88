"""Cone-form solver front end.

Counterpart of ``pogs_tpu/solver/cone.py``:

    minimize    c'x
    subject to  b − A x ∈ K_y,   x ∈ K_x

K_x empty → the HSDE Douglas–Rachford solve (``solver/hsde.py``, or on a
CUDA device the cone kernel ``ops/fused_hsde.py``); K_x non-empty → the
graph-form ADMM loop with the cone objective (a linear x-step and cone
projections) in exact-tolerance mode.  Equilibration averages the scalings
within each non-separable cone.

Which loop runs the HSDE solve (``settings.use_fused``):
  * None (auto): the kernel on a CUDA device, for float32 or float64, when
    the problem is eligible (no Anderson; at most 16 contiguous SOC /
    exponential segments; no SDP) and the eager loop would not polish — so
    the automatic choice never changes an answer.  The eager loop polishes
    when ``polish`` is on, every cone is Zero / NonNeg / NonPos, m ≥ n and
    the polish size caps hold (``solver/hsde.py::polish_plan``);
  * True: the kernel (its plain version on a CPU tensor), which never
    polishes, as in the JAX package; raises on an ineligible problem;
  * False: the eager loop.

A sparse A (``sparse_policy``, as ``GraphFormSolver``'s) stays a
SparseMatrix: the HSDE solve then takes the matrix-free ``cg`` strategy,
and the graph-form cone path the CGLS projector; neither reaches the
kernel.  Not ported yet: a quadratic P (the QP routes, slice 5).
"""

from __future__ import annotations

import time
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from pogs_tpu_torch.types import (
    DEFAULT_RHO, ConeConstraint, SolverResult, SolverSettings, Status, _torch_dtype,
)
from pogs_tpu_torch.cones.sets import ConeSet
from pogs_tpu_torch.linalg.equil import equilibrate
from pogs_tpu_torch.linalg.matrix import input_dtype, matvecs
from pogs_tpu_torch.linalg.norm import norm2_est
from pogs_tpu_torch.projector.direct import DirectProjector
from pogs_tpu_torch.projector.indirect import CglsProjector
from pogs_tpu_torch.solver.admm import admm_loop, postsolve_verify
from pogs_tpu_torch.solver.graph import matrix_operator, resolve_device
from pogs_tpu_torch.solver.hsde import hsde_solve, polish_plan
from pogs_tpu_torch.ops.fused_hsde import fused_hsde_eligible, fused_hsde_solve
from pogs_tpu_torch.utils.precision import highest_precision


class ConeSolver:
    """Reusable cone-form solver for a fixed matrix A and cone structure."""

    def __init__(
        self,
        A,
        Kx: Sequence[ConeConstraint] = (),
        Ky: Sequence[ConeConstraint] = (),
        settings: Optional[SolverSettings] = None,
        strategy: Optional[str] = None,
        projector: str = "direct",
        dtype=None,
        assume_svec: bool = False,
        device=None,
        sparse_policy: str = "auto",
    ):
        if projector not in ("direct", "cgls"):
            raise ValueError(f"unknown projector {projector!r}")
        self.device = resolve_device(A, device)
        self.dtype = input_dtype(A) if dtype is None else _torch_dtype(dtype)
        Aop = matrix_operator(A, self.dtype, self.device, sparse_policy)
        self.m, self.n = Aop.shape
        self.Kx = ConeSet(list(Kx), self.n)
        self.Ky = ConeSet(list(Ky), self.m)
        # svec transform: conjugate SDP coordinates by the √2 off-diagonal
        # weights so every cone projection is a Euclidean projection.
        # assume_svec: the caller's data is already in that convention.
        self._row_scale = self.Ky.svec_scale()
        self._col_scale = self.Kx.svec_scale()
        self._needs_svec = (self.Ky.has_sdp or self.Kx.has_sdp) and not assume_svec
        if self._needs_svec:
            Aop = Aop.scale(self._tensor(self._row_scale), self._tensor(1.0 / self._col_scale))
        self.A = Aop
        base = settings or SolverSettings()
        # Cone problems run the graph loop in exact-tolerance mode.
        self.settings = base.replace(use_exact_tol=True)
        self.use_hsde = self.Kx.is_empty
        if self.A.is_sparse:
            projector = "cgls"  # a sparse A pairs with CGLS, as in the reference
        self.projector = projector
        if strategy is None:
            # The reference's choice: matrix-free CG for a sparse A; SMW
            # through the direct projector's cached inverse; the embedding's
            # normal equations by Cholesky up to dimension 2000; CG beyond.
            if self.A.is_sparse:
                strategy = "cg"
            elif projector == "direct":
                strategy = "smw"
            elif self.n + self.m + 1 <= 2000:
                strategy = "direct"
            else:
                strategy = "cg"
        self.strategy = strategy
        self._init_state = None
        self._u = None
        self.rho = float(base.rho)

    def _tensor(self, v):
        return torch.as_tensor(np.asarray(v), dtype=self.dtype, device=self.device)

    # -- one-time init: equilibrate with the cone hooks + factor ------------

    def init(self):
        if self._init_state is None:
            proj = DirectProjector("inverse") if self.projector == "direct" else CglsProjector()
            with highest_precision():
                eq = equilibrate(self.A, constrain_d=self.Ky.constrain_average,
                                 constrain_e=self.Kx.constrain_average)
                norm_A = norm2_est(eq.A)
                factor = proj.init(eq.A, s=1.0)
            self._set_init_state({"A": eq.A if eq.A.is_sparse else eq.A.dense(),
                                  "d": eq.d, "e": eq.e, "norm_A": norm_A, "factor": factor})
        return self

    def _set_init_state(self, state: dict):
        state = dict(state)
        # The cone kernel reads Aᵀ as a row-major copy; keep it with a dense A.
        A = state["A"]
        state["At"] = A.T.contiguous() if isinstance(A, torch.Tensor) else None
        self._init_state = state

    def load_init_state(self, state: dict):
        """Install an init state made elsewhere (see ``utils.interop``):
        keys ``A`` (a tensor, or a SparseMatrix for a sparse solver), ``d``,
        ``e``, ``norm_A`` and ``factor`` = {"op", "s"} ({"s"} for CGLS)."""
        A = state["A"]
        if tuple(A.shape) != (self.m, self.n):
            raise ValueError(f"init state A has shape {tuple(A.shape)}, "
                             f"expected {(self.m, self.n)}")

        def t(v):
            return v.to(device=self.device, dtype=self.dtype)

        self._set_init_state({
            "A": t(A), "d": t(state["d"]), "e": t(state["e"]),
            "norm_A": t(state["norm_A"]),
            "factor": {key: t(v) for key, v in state["factor"].items()},
        })
        return self

    def reset_warm_start(self):
        self._u = None
        return self

    def uses_kernel(self, settings: SolverSettings) -> bool:
        """Whether an HSDE solve with ``settings`` runs the cone kernel (or,
        forced on a CPU device, its plain version); see the module note."""
        if not self.use_hsde or self.strategy != "smw" or settings.use_fused is False:
            return False
        eligible = (not self.A.is_sparse and self.projector == "direct"
                    and fused_hsde_eligible(self.dtype, self.Ky, False, settings.use_anderson))
        if settings.use_fused:
            if not eligible:
                raise ValueError(
                    "use_fused=True but the cone kernel does not support this problem "
                    "(needs a dense A with the direct projector, float32/float64, no "
                    "anderson, at most 16 contiguous SOC/exponential segments, no SDP)")
            return True
        return (eligible and self.device.type == "cuda"
                and polish_plan(self.Ky, self.m, self.n, settings.polish) is None)

    # -- solve ---------------------------------------------------------------

    def solve(self, b, c, P=None, settings: Optional[SolverSettings] = None,
              warm_start: bool = False) -> SolverResult:
        if P is not None:
            raise NotImplementedError(
                "quadratic objectives (the QP routes) come with slice 5 (QP and LP)")
        settings = (settings.replace(use_exact_tol=True)
                    if settings is not None else self.settings)
        if (self.dtype == torch.float32
                and min(settings.abs_tol, settings.rel_tol) < 1e-5):
            warnings.warn(
                "tolerances below 1e-5 sit at the float32 accuracy floor "
                "(solves may report MAX_ITER at the optimum); use dtype=float64 "
                "for tighter accuracy",
                stacklevel=2,
            )
        if settings.rho != DEFAULT_RHO:
            self.rho = float(settings.rho)
        self.init()

        npdt = np.float64 if self.dtype == torch.float64 else np.float32
        b = np.asarray(b, npdt)
        c = np.asarray(c, npdt)
        if self._needs_svec:
            b = b * self._row_scale.astype(npdt)
            c = c / self._col_scale.astype(npdt)
        t0 = time.perf_counter()
        with highest_precision():
            b_t, c_t = self._tensor(b), self._tensor(c)
            if self.use_hsde:
                u0 = self._u if warm_start else None
                out = self._solve_hsde(b_t, c_t, settings, u0)
                # The HSDE warm start of the next solve.
                self._u = out["u"]
            else:
                out = self._solve_graph(b_t, c_t, settings)
        status = Status(int(out["status"]))  # the one host sync of the solve
        solve_time = time.perf_counter() - t0
        x, y, mu, nu = out["x"], out["y"], out["mu"], out["nu"]
        if self._needs_svec:
            rs, cs = self._tensor(self._row_scale), self._tensor(self._col_scale)
            x, y, mu, nu = x / cs, y / rs, mu * cs, nu * rs
        return SolverResult(
            x=x, y=y, mu=mu, nu=nu, optval=out["optval"],
            final_iter=out["final_iter"], status=status, nrm_r=out["r_pri"],
            nrm_s=out["r_dua"], gap=out["gap"], solve_time=solve_time,
        )

    def smw_factor(self, b_s, c_s) -> dict:
        """The SMW factor of the scaled data from the cached Gram inverse:
        tall, (I + AᵀA)⁻¹; wide, Woodbury through the m×m (I + AAᵀ)⁻¹."""
        st = self._init_state
        A, Kinv = st["A"], st["factor"]["op"]
        if self.m >= self.n:
            def apply_kinv(v):
                return torch.mv(Kinv, v)
        else:
            def apply_kinv(v):
                return v - torch.mv(A.T, torch.mv(Kinv, torch.mv(A, v)))
        t_x = apply_kinv(c_s - torch.mv(A.T, b_s))
        t_y = b_s + torch.mv(A, t_x)
        s_den = 1.0 + torch.dot(c_s, t_x) + torch.dot(b_s, t_y)
        return {"apply": apply_kinv, "t_x": t_x, "t_y": t_y, "s_den": s_den}

    def _solve_hsde(self, b_orig, c_orig, settings, u0):
        st = self._init_state
        A, d, e = st["A"], st["d"], st["e"]
        m, n = self.m, self.n
        b_s, c_s = b_orig * d, c_orig * e
        # The cached Gram inverse serves SMW; without it (the CGLS projector)
        # hsde_solve factors I + AᵀA itself.
        fac = (self.smw_factor(b_s, c_s)
               if self.strategy == "smw" and self.projector == "direct" else None)
        if self.uses_kernel(settings):
            out = fused_hsde_solve(A, b_s, c_s, self.Ky, st["factor"]["op"], fac["t_x"],
                                   fac["t_y"], fac["s_den"], settings.abs_tol,
                                   settings.rel_tol, settings.max_iter, u0=u0, At=st["At"])
        else:
            out = hsde_solve(
                A, b_s, c_s, self.Ky, strategy=self.strategy, abs_tol=settings.abs_tol,
                rel_tol=settings.rel_tol, max_iter=settings.max_iter, smw_factor=fac,
                use_anderson=settings.use_anderson, anderson_mem=settings.anderson_mem,
                anderson_start=settings.anderson_start, u0=u0, polish=settings.polish)
        # Unscale.  Where τ ≈ 0 the (unscaled) certificate ray comes back.
        w = out["w"]
        tau = w[n + m]
        tau_ok = tau > 1e-8
        tau_safe = torch.where(tau_ok, tau, torch.ones_like(tau))
        x_s = w[:n] / tau_safe
        y_s = w[n:n + m] / tau_safe
        s_orig = (b_s - matvecs(A)[0](x_s)) / d
        x = torch.where(tau_ok, x_s * e, w[:n] * e)
        y = torch.where(tau_ok, b_orig - s_orig, torch.zeros_like(s_orig))
        nu = torch.where(tau_ok, y_s * d, w[n:n + m] * d)
        return {"x": x, "y": y, "mu": torch.zeros_like(x), "nu": nu,
                "optval": torch.dot(c_orig, x), "final_iter": out["final_iter"],
                "status": out["status"], "r_pri": out["r_pri"], "r_dua": out["r_dua"],
                "gap": out["gap"], "u": out["u"]}

    def _solve_graph(self, b_orig, c_orig, settings):
        """The graph-form cone path (K_x non-empty) in exact-tolerance mode."""
        st = self._init_state
        A, d, e = st["A"], st["d"], st["e"]
        m, n = self.m, self.n
        Kx, Ky = self.Kx, self.Ky
        b_s, c_s = b_orig * d, c_orig * e
        # c to unit norm, the scale folded into optval.
        c_nrm = torch.linalg.vector_norm(c_s)
        c_scale = torch.where(c_nrm > 0, 1.0 / torch.clamp(c_nrm, min=1e-30),
                              torch.ones_like(c_nrm))
        c_n = c_s * c_scale

        def prox_fn(x_in, y_in, rho):
            return Kx.project(x_in - c_n / rho), b_s - Ky.project(b_s - y_in)

        def eval_fn(x12, y12):
            return torch.dot(c_n, x12) / c_scale

        if self.projector == "direct":
            projector = DirectProjector("inverse")
        else:
            projector = CglsProjector(settings.cgls_max_iter)

        def project_fn(px, py, tol, x_warm):
            return projector.project(A, st["factor"], px, py, tol, x_warm)

        z0 = torch.zeros(m + n, dtype=self.dtype, device=self.device)
        out = admm_loop(A, st["norm_A"], d, e, prox_fn, eval_fn, project_fn,
                        settings, z0, z0, self.rho)
        status = postsolve_verify(A, d, e, out["x12"], out["y12"], out["status"],
                                  settings.abs_tol, settings.rel_tol)
        return {"x": out["x12"] * e, "y": out["y12"] / d, "mu": out["mu_scaled"] / e,
                "nu": out["nu_scaled"] * d, "optval": out["optval"],
                "final_iter": out["final_iter"], "status": status,
                "r_pri": out["nrm_r"], "r_dua": out["nrm_s"], "gap": out["gap"]}
