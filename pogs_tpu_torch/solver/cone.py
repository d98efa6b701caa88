"""Cone-form solver front end.

Counterpart of ``pogs_tpu/solver/cone.py``:

    minimize    c'x (+ ½ x'Px)
    subject to  b − A x ∈ K_y,   x ∈ K_x

K_x empty → the HSDE Douglas–Rachford solve (``solver/hsde.py``, or on a
CUDA device the cone kernel ``ops/fused_hsde.py``); K_x non-empty → the
graph-form ADMM loop with the cone objective (a linear x-step and cone
projections) in exact-tolerance mode.  Equilibration averages the scalings
within each non-separable cone.

A quadratic objective (P dense (n, n) or a length-n diagonal; K_x empty)
takes one of the JAX package's QP routes:
  * ``qp_via="socp"`` (default): with ``polish`` on and polyhedral K_y the
    host IPM (``solver/qp_ipm.py``) first, returned only when its KKT
    residuals certify the point; otherwise the epigraph reformulation
    ½x'Px ≤ t as a rotated SOC of r + 2 rows from P = LtᵀLt, solved by a
    sub-``ConeSolver`` through the conic HSDE path (on CUDA the cone
    kernel: one SOC segment), in segments of ``K_QP_SEGMENT_ITERS``
    warm-started iterations with the PDAS polish (``solver/qp_polish.py``)
    tried after each;
  * ``qp_via="admm"``: the graph-form cone loop with the quadratic x-prox
    through a one-time host eigh of the scaled P, then the PDAS polish.

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
kernel.

A sharded A runs the eager loops; the kernel takes none, and the result
comes back whole on every rank.  On the row plan
(``parallel/mesh.py::shard_matrix``, the SMW strategy through the reduced
Gram; ``parallel/sparse.py::shard_sparse``, the ``cg`` strategy) K_y is
split as the rows are, on the column plan (``shard_matrix_cols``) K_x as
the columns are (``cones/sets.py::ShardedConeSet``); the other cone set is
whole.  A QP on a sharded dense A takes its route as on one device: the
host parts (the IPM, the eigh of P, the epigraph extension, the PDAS
polish) work on A gathered once per solver, as the JAX package's host
parts read its whole A; the epigraph sub-solver runs on the extension
sharded as the caller's A is (``parallel/mesh.py::shard_like``), and the
``admm`` route on the sharded equilibrated A.  A QP on a sharded sparse A
is refused, as in the JAX package.
"""

from __future__ import annotations

import time
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from pogs_tpu_torch.types import (
    DEFAULT_RHO, Cone, ConeConstraint, SolverResult, SolverSettings, Status, _torch_dtype,
)
from pogs_tpu_torch.cones.sets import ConeSet, shard_cones
from pogs_tpu_torch.linalg.equil import equilibrate
from pogs_tpu_torch.linalg.matrix import (
    _torch_coo, input_dtype, is_sharded, is_sparse_input, local_shape, matvecs, part,
    side_sums, whole,
)
from pogs_tpu_torch.linalg.norm import norm2_est
from pogs_tpu_torch.projector.direct import DirectProjector
from pogs_tpu_torch.projector.indirect import CglsProjector
from pogs_tpu_torch.solver.admm import admm_loop, postsolve_verify
from pogs_tpu_torch.solver.graph import matrix_operator, resolve_device
from pogs_tpu_torch.solver.hsde import hsde_solve, polish_plan
from pogs_tpu_torch.solver.qp_ipm import ipm_solve
from pogs_tpu_torch.solver.qp_polish import active_set_polish, kkt_residuals, row_kinds
from pogs_tpu_torch.ops.fused_hsde import fused_hsde_eligible, fused_hsde_solve
from pogs_tpu_torch.utils.precision import highest_precision

# The staged QP solve (``_solve_qp_as_socp``): HSDE segment length between
# PDAS-polish attempts, and the largest n whose dense-P KKT the host polish
# factors mid-solve (a diagonal P polishes at any n).
K_QP_SEGMENT_ITERS = 500
K_QP_STAGED_N_MAX = 4000


def _cone_key(cones):
    return tuple((int(c.cone), c.indices) for c in cones)


def _host(v) -> np.ndarray:
    """A tensor or array as a float64 numpy array on the host."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().double().numpy()
    return np.asarray(v, np.float64)


def host_matrix(A):
    """A on the host in float64: a scipy CSR matrix for sparse input (scipy
    or a sparse torch tensor), else a dense numpy array."""
    if is_sparse_input(A):
        import scipy.sparse as sp

        if not isinstance(A, torch.Tensor):
            return sp.csr_matrix(A, dtype=np.float64)
        C = _torch_coo(A, torch.float64, "cpu")
        ij = C.indices().numpy()
        return sp.csr_matrix((C.values().numpy(), (ij[0], ij[1])), shape=tuple(C.shape))
    return _host(A)


def epigraph_factor(P):
    """The epigraph SOC's factor of a PSD P, and a key of it for the QP
    sub-solver's cache.  Eigenvalues above max(1e-12, 1e-10·max(λmax, 1))
    are kept.  A dense P gives (Lt, key), Lt (r, n) with P = LtᵀLt from the
    host eigh of its symmetric part; a length-n diagonal P gives
    ((keep_idx, sqrt(P[keep_idx])), key), one row per kept entry."""
    P = np.asarray(P, np.float64)
    if P.ndim == 1:
        keep_idx = np.flatnonzero(P > max(1e-12, 1e-10 * max(float(P.max(initial=0.0)), 1.0)))
        sqw = np.sqrt(P[keep_idx])
        return (keep_idx, sqw), (b"diag", sqw.tobytes(), keep_idx.tobytes())
    w, V = np.linalg.eigh((P + P.T) / 2)
    keep = w > max(1e-12, 1e-10 * max(float(w.max(initial=0.0)), 1.0))
    Lt = np.sqrt(w[keep])[:, None] * V[:, keep].T
    return Lt, Lt.tobytes()


def epigraph_extension(A, factor, sparse=False):
    """The epigraph QP's matrix over the variables (x, t): the rows of A
    with a zero t column, the rotated SOC's two t-rows (s0 = 1 + t,
    s1 = −1 + t) and −√2·Lt, from the factor ``epigraph_factor`` returns
    (dense or diagonal).  A scipy CSR matrix when ``sparse`` (A then scipy
    sparse), else a dense f64 array.  Returns (A_ext, r), r the factor's
    rows."""
    m, n = A.shape
    diag = isinstance(factor, tuple)
    r = factor[0].size if diag else factor.shape[0]
    if sparse:
        import scipy.sparse as sp

        t_rows = sp.csr_matrix((np.array([-1.0, -1.0]), (np.array([0, 1]), np.array([n, n]))),
                               shape=(2, n + 1))
        if diag:
            keep_idx, sqw = factor
            Lt = sp.csr_matrix((-np.sqrt(2.0) * sqw, (np.arange(r), keep_idx)), shape=(r, n))
        else:
            Lt = sp.csr_matrix(-np.sqrt(2.0) * factor)
        A_ext = sp.vstack([
            sp.hstack([A, sp.csr_matrix((m, 1))]),
            t_rows,
            sp.hstack([Lt, sp.csr_matrix((r, 1))]),
        ]).tocsr()
        return A_ext, r
    A_ext = np.zeros((m + r + 2, n + 1))
    A_ext[:m, :n] = A.toarray() if hasattr(A, "toarray") else A
    A_ext[m, n] = -1.0
    A_ext[m + 1, n] = -1.0
    if diag:
        keep_idx, sqw = factor
        A_ext[m + 2 + np.arange(r), keep_idx] = -np.sqrt(2.0) * sqw
    else:
        A_ext[m + 2:, :n] = -np.sqrt(2.0) * factor
    return A_ext, r


def smw_factor_from(A, Kinv, b_s, c_s) -> dict:
    """The SMW factor of scaled data (b_s, c_s) for a dense equilibrated A
    from the Gram inverse the direct projector caches: tall, Kinv =
    (I + AᵀA)⁻¹; wide, Woodbury through the m×m Kinv = (I + AAᵀ)⁻¹.  The
    cone kernel takes Kinv, t_x, t_y and s_den; the eager loop ``apply``,
    which maps this rank's part of an x-side vector to its part of the
    result.  On a sharded A the products carry their collectives and t is
    this rank's parts: Kinv's side is gathered where the plan splits it (a
    tall A on columns, a wide one on rows), and a wide A on the column plan
    applies Woodbury with no gather but A x's all-reduce."""
    m, n = A.shape
    amv, armv = matvecs(A)
    if m >= n:
        def apply_kinv(v):
            return part(A, "n", torch.mv(Kinv, whole(A, "n", v)))
    else:
        def apply_kinv(v):
            w = part(A, "m", torch.mv(Kinv, whole(A, "m", amv(v))))
            return v - armv(w)
    t_x = apply_kinv(c_s - armv(b_s))
    t_y = b_s + amv(t_x)
    cx, = side_sums(A, "n", [("dot", c_s, t_x)])
    by, = side_sums(A, "m", [("dot", b_s, t_y)])
    s_den = 1.0 + cx + by
    return {"apply": apply_kinv, "t_x": t_x, "t_y": t_y, "s_den": s_den}


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
        qp_via: str = "socp",
        device=None,
        sparse_policy: str = "auto",
    ):
        if projector not in ("direct", "cgls"):
            raise ValueError(f"unknown projector {projector!r}")
        if qp_via not in ("admm", "socp"):
            raise ValueError(f"unknown qp_via {qp_via!r}")
        self.qp_via = qp_via
        self.device = resolve_device(A, device)
        self.dtype = input_dtype(A) if dtype is None else _torch_dtype(dtype)
        self.sparse_policy = sparse_policy
        # The caller's A, for the QP routes' host work and epigraph extension.
        self._A_raw = A
        Aop = matrix_operator(A, self.dtype, self.device, sparse_policy)
        self.sharded = is_sharded(Aop)
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
            Aop = Aop.scale(part(Aop, "m", self._tensor(self._row_scale)),
                            part(Aop, "n", self._tensor(1.0 / self._col_scale)))
        self.A = Aop
        # K_y and K_x as the loops see them: split as A's rows or columns are.
        self.Ky_loc = shard_cones(self.Ky, Aop)
        self.Kx_loc = shard_cones(self.Kx, Aop, "n")
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
        self._qp_sub = self._qp_sub_key = self._qp_eig = None
        self._A_host = None
        self.rho = float(base.rho)

    def _tensor(self, v):
        return torch.as_tensor(np.asarray(v), dtype=self.dtype, device=self.device)

    # -- one-time init: equilibrate with the cone hooks + factor ------------

    def init(self):
        if self._init_state is None:
            proj = DirectProjector("inverse") if self.projector == "direct" else CglsProjector()
            with highest_precision():
                eq = equilibrate(self.A, constrain_d=self.Ky_loc.constrain_average,
                                 constrain_e=self.Kx_loc.constrain_average)
                norm_A = norm2_est(eq.A)
                factor = proj.init(eq.A, s=1.0)
            keep = eq.A.is_sparse or self.sharded
            self._set_init_state({"A": eq.A if keep else eq.A.dense(),
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
        eligible = (not self.A.is_sparse and not self.sharded and self.projector == "direct"
                    and fused_hsde_eligible(self.dtype, self.Ky, False, settings.use_anderson))
        if settings.use_fused:
            if not eligible:
                raise ValueError(
                    "use_fused=True but the cone kernel does not support this problem "
                    "(needs a dense A, unsharded, with the direct projector, float32/float64, no "
                    "anderson, at most 16 contiguous SOC/exponential segments, no SDP)")
            return True
        return (eligible and self.device.type == "cuda"
                and polish_plan(self.Ky, self.m, self.n, settings.polish) is None)

    # -- solve ---------------------------------------------------------------

    def solve(self, b, c, P=None, settings: Optional[SolverSettings] = None,
              warm_start: bool = False) -> SolverResult:
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
        if P is not None:
            if self.sharded and self.A.is_sparse:
                raise NotImplementedError("a QP takes no sharded sparse A (nor does the "
                                          "JAX package); shard it dense")
            P = self._check_P(P)
            # The embedding with P in Q does not have the QP optimum as a
            # fixed point, so QPs go through one of the QP routes.
            if self.qp_via == "admm":
                return self._solve_qp_admm(b, c, P, settings)
            return self._solve_qp_as_socp(b, c, P, settings, warm_start=warm_start)
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
        """The SMW factor of the scaled data from the cached Gram inverse
        (``smw_factor_from``)."""
        st = self._init_state
        return smw_factor_from(st["A"], st["factor"]["op"], b_s, c_s)

    def cold_solve(self, b, c, settings: Optional[SolverSettings] = None) -> dict:
        """One cold HSDE solve of the tensors b (m,) and c (n,) on this init,
        with no host sync: the counterpart of the JAX differentiable cone
        layer's ``_pure_solve`` (``api/diff_cone.py`` is its caller).

        Returns ``x, y, nu, s, optval, status, iterations`` as tensors.  Where
        τ ≈ 0 (an infeasibility or unboundedness certificate) x, ν and s are
        zero and y = b, as there: a certificate has no gradient.  SDP rows
        come in the svec convention (``assume_svec=True``); no P.
        """
        if not self.use_hsde or self._needs_svec:
            raise ValueError("cold_solve needs K_x empty and SDP rows in svec "
                             "(assume_svec=True)")
        self.init()
        with highest_precision():
            out = self._solve_hsde(b, c, settings or self.settings, None, rays=False)
        return {"x": out["x"], "y": out["y"], "nu": out["nu"], "s": b - out["y"],
                "optval": out["optval"], "status": out["status"].to(torch.int64).reshape(()),
                "iterations": torch.as_tensor(out["final_iter"], device=b.device)}

    def _solve_hsde(self, b_orig, c_orig, settings, u0, rays: bool = True):
        st = self._init_state
        A, d, e = st["A"], st["d"], st["e"]
        m, n = local_shape(A)
        b_orig = part(A, "m", b_orig)
        b_s, c_s = b_orig * d, part(A, "n", c_orig) * e
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
                A, b_s, c_s, self.Ky_loc, strategy=self.strategy, abs_tol=settings.abs_tol,
                rel_tol=settings.rel_tol, max_iter=settings.max_iter, smw_factor=fac,
                use_anderson=settings.use_anderson, anderson_mem=settings.anderson_mem,
                anderson_start=settings.anderson_start, u0=u0, polish=settings.polish)
        # Unscale.  Where τ ≈ 0 the (unscaled) certificate ray comes back, or
        # with rays=False zeros for x, ν and s (y = b).
        w = out["w"]
        tau = w[n + m]
        tau_ok = tau > 1e-8
        tau_safe = torch.where(tau_ok, tau, torch.ones_like(tau))
        x_s = w[:n] / tau_safe
        y_s = w[n:n + m] / tau_safe
        s_orig = (b_s - matvecs(A)[0](x_s)) / d
        if rays:
            x_off, y_off, nu_off = w[:n] * e, torch.zeros_like(s_orig), w[n:n + m] * d
        else:
            x_off, y_off, nu_off = torch.zeros_like(x_s), b_orig, torch.zeros_like(y_s)
        x = whole(A, "n", torch.where(tau_ok, x_s * e, x_off))
        y = whole(A, "m", torch.where(tau_ok, b_orig - s_orig, y_off))
        nu = whole(A, "m", torch.where(tau_ok, y_s * d, nu_off))
        return {"x": x, "y": y, "mu": torch.zeros_like(x), "nu": nu,
                "optval": torch.dot(c_orig, x), "final_iter": out["final_iter"],
                "status": out["status"], "r_pri": out["r_pri"], "r_dua": out["r_dua"],
                "gap": out["gap"], "u": out["u"]}

    def _project_fn(self, settings):
        """The graph-form loop's projection onto {y = Ax} from the init's
        factor: the direct projector's cached inverse, or CGLS."""
        st = self._init_state
        if self.projector == "direct":
            projector = DirectProjector("inverse")
        else:
            projector = CglsProjector(settings.cgls_max_iter)

        def project_fn(px, py, tol, x_warm):
            return projector.project(st["A"], st["factor"], px, py, tol, x_warm)

        return project_fn

    def _solve_graph(self, b_orig, c_orig, settings):
        """The graph-form cone path (K_x non-empty) in exact-tolerance mode."""
        st = self._init_state
        A, d, e = st["A"], st["d"], st["e"]
        m, n = local_shape(A)
        Kx, Ky = self.Kx_loc, self.Ky_loc
        b_s, c_s = part(A, "m", b_orig) * d, part(A, "n", c_orig) * e
        # c to unit norm, the scale folded into optval.
        c_nrm, = side_sums(A, "n", [("norm", c_s)])
        c_scale = torch.where(c_nrm > 0, 1.0 / torch.clamp(c_nrm, min=1e-30),
                              torch.ones_like(c_nrm))
        c_n = c_s * c_scale

        def prox_fn(x_in, y_in, rho):
            return Kx.project(x_in - c_n / rho), b_s - Ky.project(b_s - y_in)

        def eval_fn(x12, y12):
            return side_sums(A, "n", [("dot", c_n, x12)])[0] / c_scale

        z0 = torch.zeros(m + n, dtype=self.dtype, device=self.device)
        out = admm_loop(A, st["norm_A"], d, e, prox_fn, eval_fn, self._project_fn(settings),
                        settings, z0, z0, self.rho)
        status = postsolve_verify(A, d, e, out["x12"], out["y12"], out["status"],
                                  settings.abs_tol, settings.rel_tol)
        return {"x": whole(A, "n", out["x12"] * e), "y": whole(A, "m", out["y12"] / d),
                "mu": whole(A, "n", out["mu_scaled"] / e),
                "nu": whole(A, "m", out["nu_scaled"] * d),
                "optval": out["optval"],
                "final_iter": out["final_iter"], "status": status,
                "r_pri": out["nrm_r"], "r_dua": out["nrm_s"], "gap": out["gap"]}

    # -- the QP routes ---------------------------------------------------------

    def _check_P(self, P) -> np.ndarray:
        """P on the host: a dense (n, n) or a nonnegative length-n diagonal."""
        P = P.toarray() if hasattr(P, "toarray") else _host(P)
        if P.ndim == 1:
            if P.shape != (self.n,):
                raise ValueError(f"diagonal P must have length {self.n}")
            if np.any(P < 0):
                raise ValueError("diagonal P must be nonnegative")
        elif P.shape != (self.n, self.n):
            raise ValueError(f"P must be {self.n}x{self.n} or a length-{self.n} diagonal")
        if not self.use_hsde:
            raise ValueError("quadratic objectives with K_x constraints are not supported")
        return P

    def _host_A(self):
        """The caller's A on the host in float64, made once per solver; a
        sharded A gathered first (one all-reduce)."""
        if self._A_host is None:
            A = self._A_raw
            self._A_host = _host(A.dense()) if self.sharded else host_matrix(A)
        return self._A_host

    def _objective(self, c, P, x):
        """c'x + ½x'Px in the solver's dtype on its device."""
        Pt, ct = self._tensor(P), self._tensor(_host(c))
        Px = Pt * x if P.ndim == 1 else torch.mv(Pt, x)
        return torch.dot(ct, x) + 0.5 * torch.dot(x, Px)

    def _solve_qp_as_socp(self, b, c, P, settings, warm_start=False):
        """min c'x + ½x'Px s.t. b−Ax ∈ K_y  ⇒  an epigraph variable t with
        ½x'Px ≤ t as a rotated second-order cone,

            (t+1, t−1, √2 Lt x) ∈ SOC,   P = LtᵀLt,

        then min c'x + t through the conic HSDE path (the host IPM first,
        when polish is on and K_y polyhedral)."""
        n, m = self.n, self.m
        npdt = np.float64 if self.dtype == torch.float64 else np.float32
        if settings.polish:
            res_ipm = self._try_qp_ipm(P, b, c, settings)
            if res_ipm is not None:
                return res_ipm
        diag_p = P.ndim == 1
        factor, lt_key = epigraph_factor(P)
        # Extended variable (x, t); extended rows: the original m, then the
        # rotated SOC's r + 2.  A sparse A keeps the extension sparse (the
        # CGLS projector).
        A_ext, r = epigraph_extension(self._host_A(), factor, sparse=self.A.is_sparse)
        A_ext = A_ext.astype(npdt)
        if self.sharded:
            # The sub-solver's DR segments run sharded as the caller asked
            # (imported here: parallel/ imports this module).
            from pogs_tpu_torch.parallel.mesh import shard_like
            A_ext = shard_like(A_ext, self._A_raw)
        b_ext = np.concatenate([_host(b), [1.0, -1.0], np.zeros(r)])
        c_ext = np.concatenate([_host(c), [1.0]])
        Ky_ext = list(self.Ky.constraints) + [ConeConstraint(Cone.SOC, range(m, m + r + 2))]
        sub_key = (A_ext.shape, lt_key, _cone_key(self.Ky.constraints))
        sub = self._qp_sub
        if sub is None or self._qp_sub_key != sub_key:
            sub = ConeSolver(A_ext, Ky=Ky_ext, settings=settings, strategy=self.strategy,
                             projector=self.projector, dtype=self.dtype, device=self.device,
                             sparse_policy=self.sparse_policy)
            self._qp_sub, self._qp_sub_key = sub, sub_key
        # The warm start carries through to the extended solver: its cone
        # structure is the same across re-solves with perturbed (b, c).
        #
        # Staged: the DR tail on the epigraph SOC is linear and may take
        # O(10⁴) iterations, while the PDAS polish certifies the optimum from
        # a few hundred; for polyhedral K_y the HSDE runs in warm-started
        # segments with a polish attempt after each (one status read per
        # segment), and exits when the active set is identified.
        b_run, c_run = b_ext.astype(npdt), c_ext.astype(npdt)
        staged = (settings.polish and settings.max_iter > K_QP_SEGMENT_ITERS
                  and (diag_p or n <= K_QP_STAGED_N_MAX)
                  and row_kinds(m, self.Ky.constraints) is not None)
        polished = None
        if not staged:
            res = sub.solve(b_run, c_run, settings=settings, warm_start=warm_start)
            total_iter = res.final_iter
        else:
            seg_settings = settings.replace(max_iter=K_QP_SEGMENT_ITERS)
            total_iter, ws = 0, warm_start
            while True:
                res = sub.solve(b_run, c_run, settings=seg_settings, warm_start=ws)
                ws = True
                total_iter += int(res.final_iter)
                if res.status != Status.MAX_ITER or total_iter >= settings.max_iter:
                    break
                out = self._polish_qp(P, b, c, res.x[:n], res.y[:m], res.nu[:m], res.status,
                                      res.nrm_r, res.nrm_s, settings)
                if out[3] == Status.SUCCESS:
                    polished = out
                    break
        if polished is None:
            polished = self._polish_qp(P, b, c, res.x[:n], res.y[:m], res.nu[:m], res.status,
                                       res.nrm_r, res.nrm_s, settings)
        x, y, nu, status, nrm_r, nrm_s = polished
        return SolverResult(
            x=x, y=y, mu=res.mu[:n], nu=nu, optval=self._objective(c, P, x),
            final_iter=total_iter, status=status, nrm_r=nrm_r, nrm_s=nrm_s, gap=res.gap,
            solve_time=res.solve_time,
        )

    def _try_qp_ipm(self, P, b, c, settings):
        """The host IPM on a polyhedral QP; None on any miss.  Only a point
        whose relative KKT residuals (``qp_polish.kkt_residuals``) meet the
        solve tolerance returns, after a short PDAS pass that snaps
        complementarity (adopted only if it scores better)."""
        kind = row_kinds(self.m, self.Ky.constraints)
        if kind is None:
            return None
        t0 = time.perf_counter()
        P64, c64, b64 = np.asarray(P, np.float64), _host(c), _host(b)
        A_h = self._host_A()
        tol = float(max(settings.abs_tol, settings.rel_tol))
        out = ipm_solve(P64, c64, A_h, b64, kind, tol=min(1e-9, tol), max_iter=50)
        if out is None:
            return None
        res = kkt_residuals(P64, c64, A_h, b64, kind, out["x"], out["lam"])
        x64, lam64 = out["x"], out["lam"]
        score = max(res.values())
        pol = active_set_polish(P64, c64, A_h, b64, kind, x64, lam64, tol, max_pdas=3)
        if pol is not None and pol["score"] < score:
            x64, lam64, res, score = pol["x"], pol["lam"], pol["res"], pol["score"]
        if score > tol:
            return None
        Px64 = P64 * x64 if P64.ndim == 1 else P64 @ x64
        t = self._tensor
        return SolverResult(
            x=t(x64), y=t(A_h @ x64), mu=t(np.zeros(self.n)), nu=t(lam64),
            optval=t(float(c64 @ x64 + 0.5 * (x64 @ Px64))),
            final_iter=int(out["iters"]), status=Status.SUCCESS, nrm_r=t(res["pri"]),
            nrm_s=t(res["stat"]), gap=t(res["comp"]), solve_time=time.perf_counter() - t0,
        )

    def _polish_qp(self, P, b, c, x, y, nu, status, nrm_r, nrm_s, settings):
        """The active-set KKT polish (``qp_polish.py``): one host f64 PDAS pass
        on the detected active rows.  It lifts a SUCCESS or MAX_ITER iterate
        to about machine precision when the active set is identified; a
        rejected polish leaves the iterate untouched."""
        if not (settings.polish and status in (Status.SUCCESS, Status.MAX_ITER)):
            return x, y, nu, status, nrm_r, nrm_s
        kind = row_kinds(self.m, self.Ky.constraints)
        if kind is None:
            return x, y, nu, status, nrm_r, nrm_s
        A_h = self._host_A()
        tol = float(max(settings.abs_tol, settings.rel_tol))
        pol = active_set_polish(np.asarray(P, np.float64), _host(c), A_h, _host(b), kind,
                                _host(x), _host(nu), tol)
        if pol is None:
            return x, y, nu, status, nrm_r, nrm_s
        t = self._tensor
        return (t(pol["x"]), t(A_h @ pol["x"]), t(pol["lam"]), Status.SUCCESS,
                t(pol["res"]["pri"]), t(pol["res"]["stat"]))

    def _solve_qp_admm(self, b, c, P, settings):
        """min cᵀx + ½xᵀPx s.t. b − Ax ∈ K_y by the graph-form cone loop.

        x-prox: (P_s + ρI)⁻¹(ρv − c_s) through a one-time host eigh of the
        equilibrated P_s = E·P·E (cached per P and scaling), so a change of ρ
        is a diagonal divide between two products; a diagonal P is its own
        eigenbasis.  y-prox: the cone projection of b_s − y.  The objective
        is divided by σ = max(λmax(P_s), ‖c_s‖), which leaves the argmin
        alone.  The PDAS polish finishes polyhedral problems."""
        if self._needs_svec:
            # SDP cones under the svec transform would conjugate P too.
            return self._solve_qp_as_socp(b, c, P, settings)
        npdt = np.float64 if self.dtype == torch.float64 else np.float32
        b, c = _host(b).astype(npdt), _host(c).astype(npdt)
        self.init()
        st = self._init_state
        A, d, e = st["A"], st["d"], st["e"]
        m, n = local_shape(A)
        e_host = _host(whole(A, "n", e))
        diag_mode = P.ndim == 1
        if diag_mode:
            lam_eig = np.maximum(P, 0.0) * e_host * e_host
            V = None
        else:
            P = (P + P.T) / 2
            eig_key = (hash(P.tobytes()), hash(e_host.tobytes()))
            if self._qp_eig is None or self._qp_eig[0] != eig_key:
                lam, V = np.linalg.eigh(P * e_host[:, None] * e_host[None, :])
                self._qp_eig = (eig_key, self._tensor(V), np.maximum(lam, 0.0))
            _, V, lam_eig = self._qp_eig
        sigma = max(float(lam_eig.max(initial=0.0)), float(np.linalg.norm(c * e_host)), 1e-12)
        t0 = time.perf_counter()
        with highest_precision():
            b_s = part(A, "m", self._tensor(b)) * d
            c_s = part(A, "n", self._tensor(c)) * e / sigma
            lam_hat = self._tensor(lam_eig / sigma)
            Ky = self.Ky_loc
            # On the column plan x is split: a diagonal P takes this rank's
            # eigenvalues; V's product takes x gathered and keeps this rank's
            # rows of V (its columns of the result).
            if diag_mode:
                lam_x = part(A, "n", lam_hat)
            else:
                V_rows = part(A, "n", V)

            def prox_fn(x_in, y_in, rho):
                if diag_mode:
                    x12 = (rho * x_in - c_s) / (lam_x + rho)
                else:
                    v = whole(A, "n", rho * x_in - c_s)
                    x12 = torch.mv(V_rows, torch.mv(V.T, v) / (lam_hat + rho))
                return x12, b_s - Ky.project(b_s - y_in)

            def eval_fn(x12, y12):
                if diag_mode:
                    cx, wlw = side_sums(A, "n", [("dot", c_s, x12), ("dot", x12, lam_x * x12)])
                else:
                    cx, = side_sums(A, "n", [("dot", c_s, x12)])
                    w = torch.mv(V.T, whole(A, "n", x12))
                    wlw = torch.dot(w, lam_hat * w)
                return cx + 0.5 * wlw

            z0 = torch.zeros(m + n, dtype=self.dtype, device=self.device)
            out = admm_loop(A, st["norm_A"], d, e, prox_fn, eval_fn, self._project_fn(settings),
                            settings, z0, z0, self.rho)
            status = postsolve_verify(A, d, e, out["x12"], out["y12"], out["status"],
                                      settings.abs_tol, settings.rel_tol)
            # Undo the objective normalization: the duals of the σ-scaled
            # objective are σ× the original's.
            x = whole(A, "n", out["x12"] * e)
            y = whole(A, "m", out["y12"] / d)
            nu = whole(A, "m", out["nu_scaled"] * d * sigma)
            mu = whole(A, "n", out["mu_scaled"] / e * sigma)
        x, y, nu, status, nrm_r, nrm_s = self._polish_qp(
            P, b, c, x, y, nu, Status(int(status)), out["nrm_r"], out["nrm_s"], settings)
        return SolverResult(
            x=x, y=y, mu=mu, nu=nu, optval=self._objective(c, P, x),
            final_iter=out["final_iter"], status=status, nrm_r=nrm_r, nrm_s=nrm_s,
            gap=out["gap"], solve_time=time.perf_counter() - t0,
        )
