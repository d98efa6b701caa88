"""Graph-form solver front end: init (equilibrate + factor) and solve.

Counterpart of ``pogs_tpu/solver/graph.py`` (the reference's PogsSeparable
and PogsImplementation): init equilibrates A, estimates ‖A‖₂ and factors
the projector once per matrix; each ``solve`` scales the objective, runs the
ADMM loop (the fused CUDA kernel where eligible, else the eager loop),
unscales the result, and keeps the final iterate and ρ as the implicit warm
start of the next solve.  A solve with the direct projector syncs with the
host once, to read its status.

A sparse A (a scipy matrix, or a torch tensor in a sparse layout) stays a
:class:`SparseMatrix` and takes the CGLS projector in the eager loop, or is
densified first (``sparse_policy``, :func:`densify_sparse`).

A sharded operator (``parallel/mesh.py::ShardedMatrix``,
``parallel/sparse.py::ShardedSparseMatrix``) passes through untouched and
runs the eager loop: the solve kernel takes no sharded operator, and
``use_fused=True`` raises on one.  Each rank keeps its part of f or g, and
the result's x, y, μ and ν come back whole on every rank.
"""

from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np
import torch

from pogs_tpu_torch.types import (
    DEFAULT_RHO,
    FunctionVector,
    SolverResult,
    SolverSettings,
    Status,
    _torch_dtype,
)
from pogs_tpu_torch.prox.vector import prox_eval, func_eval, scale_f, scale_g
from pogs_tpu_torch.linalg.equil import equilibrate
from pogs_tpu_torch.linalg.matrix import (
    DenseMatrix, as_matrix_op, input_dtype, is_sharded, is_sparse_input, local_shape,
    matvecs, part, side_total, whole,
)
from pogs_tpu_torch.linalg.norm import norm2_est
from pogs_tpu_torch.projector.direct import DirectProjector
from pogs_tpu_torch.projector.indirect import CglsProjector
from pogs_tpu_torch.solver.admm import admm_loop, postsolve_verify
from pogs_tpu_torch.ops.fused_admm import fused_admm_loop, fused_admm_supported
from pogs_tpu_torch.utils.precision import highest_precision
from pogs_tpu_torch.utils.profiling import span


# The dense size up to which sparse_policy="auto" densifies on a CUDA device.
DENSIFY_BYTES = 1 << 30
SPARSE_POLICIES = ("auto", "keep", "densify")


def densify_sparse(policy: str, shape, itemsize: int, device) -> bool:
    """Whether a sparse A of ``shape`` is solved dense: always for
    ``"densify"``, never for ``"keep"``; for ``"auto"`` on a CUDA device when
    the dense A fits ``DENSIFY_BYTES`` (one K1 launch against the eager loop
    with an inner CGLS), and never on the CPU, as the JAX package on a CPU
    backend."""
    if policy not in SPARSE_POLICIES:
        raise ValueError(f"unknown sparse_policy {policy!r}")
    if policy != "auto":
        return policy == "densify"
    m, n = shape
    return torch.device(device).type == "cuda" and m * n * itemsize <= DENSIFY_BYTES


def matrix_operator(A, dtype, device, sparse_policy: str):
    """A as the operator a solver keeps: a SparseMatrix, or a DenseMatrix
    (a sparse A densified on the device where :func:`densify_sparse` says);
    a sharded operator as it is."""
    if is_sharded(A):
        if A.dtype != dtype:
            raise ValueError(f"a sharded A holds {A.dtype}; the solve asked for {dtype}")
        return A
    sparse = is_sparse_input(A)
    if sparse and not densify_sparse(sparse_policy, A.shape, dtype.itemsize, device):
        return as_matrix_op(A, dtype, device)
    if sparse:
        return DenseMatrix(as_matrix_op(A, dtype, device).to_dense())
    A_t = A if isinstance(A, torch.Tensor) else torch.as_tensor(np.asarray(A))
    return DenseMatrix(A_t.to(device=device, dtype=dtype))


def resolve_device(A, device=None) -> torch.device:
    """``device`` if given, else the device of a tensor ``A`` or a sharded
    operator, else CUDA."""
    if device is not None:
        return torch.device(device)
    if isinstance(A, torch.Tensor) or is_sharded(A):
        return A.device
    return torch.device("cuda")


def _use_fused(dtype, device, settings: SolverSettings, direct_method: str,
               projector: str = "direct", is_sparse: bool = False,
               sharded: bool = False) -> bool:
    """Decide the fused-kernel path: a dense, unsharded A with the direct
    projector, the inverse method, no anderson / exact-tol / verbose > 1,
    f32 or f64, on CUDA."""
    if settings.use_fused is False:
        return False
    supported = (
        not is_sparse
        and not sharded
        and projector == "direct"
        and direct_method == "inverse"
        and fused_admm_supported(settings)
        and dtype in (torch.float32, torch.float64)
    )
    if settings.use_fused:
        if not supported:
            raise ValueError(
                "use_fused=True but the fused path does not support this "
                "problem (needs a dense A, unsharded, the direct/inverse projector, "
                "no anderson/exact-tol/verbose>1)"
            )
        return True
    return supported and torch.device(device).type == "cuda"


class GraphFormSolver:
    """Reusable graph-form ADMM solver for a fixed matrix A.

    ``solve(f, g)`` may be called repeatedly; equilibration and the Gram
    factorization run once, and the final iterate carries over as a warm
    start (the reference's λ-path pattern).
    """

    def __init__(
        self,
        A,
        projector: str = "direct",
        direct_method: str = "inverse",
        dtype=None,
        settings: Optional[SolverSettings] = None,
        device=None,
        sparse_policy: str = "auto",
    ):
        if projector not in ("direct", "cgls"):
            raise ValueError(f"unknown projector {projector!r}")
        if direct_method not in ("inverse", "cholesky"):
            raise ValueError(f"unknown direct method {direct_method!r}")
        self.device = resolve_device(A, device)
        self.dtype = input_dtype(A) if dtype is None else _torch_dtype(dtype)
        self.A = matrix_operator(A, self.dtype, self.device, sparse_policy)
        self.sharded = is_sharded(self.A)
        self.m, self.n = self.A.shape
        if self.A.is_sparse:
            # A sparse A pairs with the CGLS projector, as in the reference.
            projector = "cgls"
        self.projector = projector
        self.direct_method = direct_method
        self.settings = settings or SolverSettings()
        self.rho = float(self.settings.rho)
        self._init_state = None
        self._z = None
        self._zt = None

    # -- lifecycle ----------------------------------------------------------

    def init(self):
        """Equilibrate + estimate ‖A‖₂ + factor (idempotent)."""
        if self._init_state is None:
            with span("pogs.init"):
                t0 = time.perf_counter()
                with highest_precision():
                    with span("pogs.init.equilibrate"):
                        eq = equilibrate(self.A)
                    with span("pogs.init.norm_est"):
                        norm_A = norm2_est(eq.A)
                    with span("pogs.init.factor"):
                        factor = self._projector(self.settings).init(eq.A, s=1.0)
                keep = eq.A.is_sparse or self.sharded
                self._set_init_state({"A": eq.A if keep else eq.A.dense(),
                                      "d": eq.d, "e": eq.e, "norm_A": norm_A,
                                      "factor": factor})
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.init_time = time.perf_counter() - t0
        return self

    def _projector(self, settings: SolverSettings):
        if self.projector == "cgls":
            return CglsProjector(settings.cgls_max_iter)
        return DirectProjector(self.direct_method)

    def _set_init_state(self, state: dict):
        A = state["A"]
        state = dict(state)
        # The fused kernel reads Aᵀ as a row-major copy; keep it with A.
        kernel_ready = (self.projector == "direct" and self.direct_method == "inverse"
                        and isinstance(A, torch.Tensor))
        state["At"] = A.T.contiguous() if kernel_ready else None
        self._init_state = state

    def load_init_state(self, state: dict):
        """Install an init state made elsewhere (see ``utils.interop``):
        keys ``A`` (a tensor, or a SparseMatrix for a sparse solver), ``d``,
        ``e``, ``norm_A`` and ``factor`` = {"op", "s"} ({"s"} for CGLS)."""
        A = state["A"]
        if tuple(A.shape) != (self.m, self.n):
            raise ValueError(f"init state A has shape {tuple(A.shape)}, "
                             f"expected {(self.m, self.n)}")
        self._set_init_state({
            "A": A.to(device=self.device, dtype=self.dtype),
            "d": state["d"].to(device=self.device, dtype=self.dtype),
            "e": state["e"].to(device=self.device, dtype=self.dtype),
            "norm_A": state["norm_A"].to(device=self.device, dtype=self.dtype),
            "factor": {key: v.to(device=self.device, dtype=self.dtype)
                       for key, v in state["factor"].items()},
        })
        self.init_time = 0.0
        return self

    def reset_warm_start(self):
        self._z = None
        self._zt = None
        return self

    def save_state(self, path):
        """Checkpoint the warm-start state (z, zt, rho) to ``path`` (.npz)."""
        from pogs_tpu_torch.utils.checkpoint import save_state
        save_state(self, path)
        return self

    def load_state(self, path, strict: bool = True):
        """Restore a checkpoint created by :meth:`save_state`."""
        from pogs_tpu_torch.utils.checkpoint import load_state
        return load_state(self, path, strict=strict)

    # -- solving -------------------------------------------------------------

    def solve(
        self,
        f: FunctionVector,
        g: FunctionVector,
        settings: Optional[SolverSettings] = None,
        x_init=None,
        nu_init=None,
        rho: Optional[float] = None,
    ) -> SolverResult:
        with span("pogs.call"):
            if f.n != self.m:
                raise ValueError(f"f has length {f.n}, expected m={self.m}")
            if g.n != self.n:
                raise ValueError(f"g has length {g.n}, expected n={self.n}")
            settings = settings or self.settings
            if (self.dtype == torch.float32
                    and min(settings.abs_tol, settings.rel_tol) < 1e-5):
                warnings.warn(
                    "tolerances below 1e-5 sit at the float32 accuracy floor; "
                    "use dtype=float64 for tighter accuracy",
                    stacklevel=2,
                )
            if rho is None and settings.rho != DEFAULT_RHO:
                rho = float(settings.rho)
            self.init()

            rho0 = float(rho if rho is not None else self.rho)
            fused = _use_fused(self.dtype, self.device, settings, self.direct_method,
                               self.projector, self.A.is_sparse, self.sharded)

            if settings.verbose > 0:
                print(
                    "---------------------------------------------------------\n"
                    " pogs_tpu_torch — graph-form ADMM\n"
                    f"   A: {self.m} x {self.n} "
                    f"({'sparse' if self.A.is_sparse else 'dense'}, {self.dtype}, {self.device}), "
                    f"projector: {self.projector}"
                    f"{' [fused kernel]' if fused else ''}\n"
                    f"   abs_tol {settings.abs_tol:g}, rel_tol {settings.rel_tol:g}, "
                    f"rho {rho0:g}, max_iter {settings.max_iter}\n"
                    "---------------------------------------------------------"
                )

            t0 = time.perf_counter()
            with highest_precision():
                out = self._solve_scaled(f, g, settings, rho0, x_init, nu_init, fused)
            status_val = int(out["status"])  # the one host sync of the solve
            solve_time = time.perf_counter() - t0

            # Persist warm-start state (pogs.cpp:573) and the adapted rho.
            self._z = out["z"]
            self._zt = out["zt"]
            self.rho = float(out["rho"])

            if settings.verbose > 0:
                init_ms = getattr(self, "init_time", 0.0) * 1e3
                print(
                    f" status: {Status(status_val).name}, "
                    f"iterations: {int(out['final_iter'])}, "
                    f"init: {init_ms:.2f} ms, "
                    f"solve time: {solve_time * 1e3:.2f} ms\n"
                    f" optval: {float(out['optval']):.6e}, "
                    f"nrm_r: {float(out['nrm_r']):.2e}, "
                    f"nrm_s: {float(out['nrm_s']):.2e}, "
                    f"gap: {float(out['gap']):.2e}"
                )

            return SolverResult(
                x=out["x"], y=out["y"], mu=out["mu"], nu=out["nu"],
                optval=out["optval"], final_iter=out["final_iter"],
                status=Status(status_val), nrm_r=out["nrm_r"], nrm_s=out["nrm_s"],
                gap=out["gap"], rho=out["rho"], solve_time=solve_time,
            )

    def _solve_scaled(self, f, g, settings, rho0, x_init, nu_init, fused):
        # The host work before the loop: on the kernel path to the wrapper's
        # return, which on a CUDA tensor is the launch; on the eager path to
        # admm_loop's start.
        with span("pogs.prepare"):
            st = self._init_state
            A, d, e = st["A"], st["d"], st["e"]
            factor, norm_A = st["factor"], st["norm_A"]
            dev, dt = self.device, self.dtype
            m, n = local_shape(A)

            def params(fv, side):
                a, b, c, dd, ee = (part(A, side, torch.as_tensor(p).to(device=dev, dtype=dt))
                                   for p in fv.params)
                # Convexity clamps (prox_lib.h:62-69).
                return (a, b, torch.clamp(c, min=0), dd, torch.clamp(ee, min=0))

            f_s = scale_f(local_function(A, "m", f).replace_params(*params(f, "m")), d)
            g_s = scale_g(local_function(A, "n", g).replace_params(*params(g, "n")), e)

            if self._z is not None:
                z0, zt0 = self._z, self._zt
            else:
                z0 = torch.zeros(m + n, dtype=dt, device=dev)
                zt0 = torch.zeros(m + n, dtype=dt, device=dev)
            # Warm start from (x0, nu0) (pogs.cpp:143-156).
            amv, armv = matvecs(A)
            if x_init is not None:
                xs = part(A, "n", torch.as_tensor(x_init).to(device=dev, dtype=dt)) / e
                z0 = torch.cat([xs, amv(xs)])
            if nu_init is not None:
                nus = part(A, "m", torch.as_tensor(nu_init).to(device=dev, dtype=dt)) / d
                zt0 = torch.cat([armv(nus), -nus]) / rho0

            if fused:
                out = fused_admm_loop(
                    A, factor["op"], norm_A, f.h, tuple(f_s.params),
                    g.h, tuple(g_s.params), settings, z0, zt0, rho0, At=st["At"],
                )
            else:
                projector = self._projector(settings)

                def prox_fn(x_in, y_in, rho):
                    return prox_eval(g_s, x_in, rho), prox_eval(f_s, y_in, rho)

                def eval_fn(x12, y12):
                    return (side_total(A, "m", func_eval(f_s, y12))
                            + side_total(A, "n", func_eval(g_s, x12)))

                def project_fn(px, py, tol, x_warm):
                    return projector.project(A, factor, px, py, tol, x_warm)

        if not fused:
            out = admm_loop(A, norm_A, d, e, prox_fn, eval_fn, project_fn,
                            settings, z0, zt0, rho0)

        if settings.use_exact_tol:
            out["status"] = postsolve_verify(
                A, d, e, out["x12"], out["y12"], out["status"],
                settings.abs_tol, settings.rel_tol,
            )

        # Unscale to the original space (pogs.cpp:509-518), whole on every rank.
        out["x"] = whole(A, "n", out.pop("x12") * e)
        out["y"] = whole(A, "m", out.pop("y12") / d)
        out["mu"] = whole(A, "n", out.pop("mu_scaled") / e)
        out["nu"] = whole(A, "m", out.pop("nu_scaled") * d)
        return out


def local_function(A, side: str, fv: FunctionVector) -> FunctionVector:
    """This rank's part of f (``side="m"``) or g (``"n"``) where a sharded A
    splits that side, else ``fv``; its parameters are sliced by the caller."""
    if getattr(A, "sharded_side", None) != side:
        return fv
    new = fv.replace_params()
    new.h = fv.h[A.lo:A.hi]
    new.n = A.hi - A.lo
    return new


def admm_solve(
    A,
    f: FunctionVector,
    g: FunctionVector,
    settings: Optional[SolverSettings] = None,
    device=None,
    sparse_policy: str = "auto",
    **kw,
) -> SolverResult:
    """One-shot functional front end: solve min f(y) + g(x) s.t. y = Ax."""
    solver = GraphFormSolver(A, settings=settings, device=device,
                             sparse_policy=sparse_policy)
    return solver.solve(f, g, **kw)
