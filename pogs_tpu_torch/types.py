"""Core types: function library enums, struct-of-arrays function vectors,
solver settings and results.

Counterpart of ``pogs_tpu/types.py``.  ``Function``, ``Cone`` and ``Status``
carry the same integer values as the JAX package (the C ABI exposes them).
``FunctionVector`` keeps the ``h`` codes as a host numpy int32 array and the
parameters a..e as tensors; c and e are clamped at 0 (the function would be
non-convex otherwise).  ``ConeConstraint`` is one cone over a tuple of
coordinate indices.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from pogs_tpu_torch.utils.profiling import span


class Function(enum.IntEnum):
    """Scalar function library h(x). Values match the reference C enum."""

    ABS = 0        # f(x) = |x|
    EXP = 1        # f(x) = e^x
    HUBER = 2      # f(x) = huber(x)
    IDENTITY = 3   # f(x) = x
    INDBOX01 = 4   # f(x) = I(0 <= x <= 1)
    INDEQ0 = 5     # f(x) = I(x = 0)
    INDGE0 = 6     # f(x) = I(x >= 0)
    INDLE0 = 7     # f(x) = I(x <= 0)
    LOGISTIC = 8   # f(x) = log(1 + e^x)
    MAXNEG0 = 9    # f(x) = max(0, -x)
    MAXPOS0 = 10   # f(x) = max(0, x)
    NEGENTR = 11   # f(x) = x log(x)
    NEGLOG = 12    # f(x) = -log(x)
    RECIPR = 13    # f(x) = 1/x
    SQUARE = 14    # f(x) = (1/2) x^2
    ZERO = 15      # f(x) = 0


# Aliases in the reference's k-prefixed spelling.
kAbs = Function.ABS
kExp = Function.EXP
kHuber = Function.HUBER
kIdentity = Function.IDENTITY
kIndBox01 = Function.INDBOX01
kIndEq0 = Function.INDEQ0
kIndGe0 = Function.INDGE0
kIndLe0 = Function.INDLE0
kLogistic = Function.LOGISTIC
kMaxNeg0 = Function.MAXNEG0
kMaxPos0 = Function.MAXPOS0
kNegEntr = Function.NEGENTR
kNegLog = Function.NEGLOG
kRecipr = Function.RECIPR
kSquare = Function.SQUARE
kZero = Function.ZERO


class Cone(enum.IntEnum):
    """Cone types. Values match the reference C enum."""

    ZERO = 0
    NON_NEG = 1
    NON_POS = 2
    SOC = 3
    SDP = 4
    EXP_PRIMAL = 5
    EXP_DUAL = 6


class Status(enum.IntEnum):
    """Solver exit status. Values match PogsStatus."""

    SUCCESS = 0
    INFEASIBLE = 1
    UNBOUNDED = 2
    MAX_ITER = 3
    NAN_FOUND = 4
    ERROR = 5


@dataclasses.dataclass
class FunctionObj:
    """A single term c*h(a*x - b) + d*x + (e/2) x^2; c and e clamped at 0."""

    h: Function = Function.ZERO
    a: float = 1.0
    b: float = 0.0
    c: float = 1.0
    d: float = 0.0
    e: float = 0.0

    def __post_init__(self):
        self.c = max(self.c, 0.0)
        self.e = max(self.e, 0.0)


def _torch_dtype(dtype) -> torch.dtype:
    """Map a numpy / string / torch dtype spec to a torch float dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


class FunctionVector:
    """Struct-of-arrays vector of FunctionObj terms.

    ``h`` is a host numpy int32 array; a..e are 1-D tensors of length n
    (scalars broadcast).  Tensors passed in keep their device; everything
    else becomes a CPU tensor of ``dtype`` (float64 by default) and is moved
    to the solver's device at solve time.
    """

    __slots__ = ("h", "a", "b", "c", "d", "e", "n")

    def __init__(
        self,
        h: Union[Function, int, Sequence[int], np.ndarray],
        n: Optional[int] = None,
        a: Any = 1.0,
        b: Any = 0.0,
        c: Any = 1.0,
        d: Any = 0.0,
        e: Any = 0.0,
        dtype: Any = None,
    ):
        with span("pogs.functions"):
            h_arr = np.asarray(h, dtype=np.int32)
            if h_arr.ndim == 0:
                if n is None:
                    raise ValueError("scalar h requires explicit n")
                h_arr = np.full((n,), int(h_arr), dtype=np.int32)
            if n is not None and h_arr.shape[0] != n:
                raise ValueError(f"h has length {h_arr.shape[0]}, expected {n}")
            self.h = h_arr
            self.n = h_arr.shape[0]
            tdt = torch.float64 if dtype is None else _torch_dtype(dtype)

            def _vec(v):
                if isinstance(v, torch.Tensor):
                    if v.ndim == 0:
                        raise ValueError("scalar tensor params not supported; pass float")
                    if v.shape[0] != self.n:
                        raise ValueError(
                            f"parameter length {v.shape[0]} != objective length {self.n}"
                        )
                    return v
                arr = np.asarray(v, dtype=np.float64)
                if arr.ndim == 0:
                    arr = np.full((self.n,), arr)
                elif arr.shape[0] != self.n:
                    raise ValueError(
                        f"parameter length {arr.shape[0]} != objective length {self.n}"
                    )
                return torch.as_tensor(arr, dtype=tdt)

            self.a = _vec(a)
            self.b = _vec(b)
            self.c = torch.clamp(_vec(c), min=0)
            self.d = _vec(d)
            self.e = torch.clamp(_vec(e), min=0)

    @property
    def params(self):
        """The parameter tuple (a, b, c, d, e)."""
        return (self.a, self.b, self.c, self.d, self.e)

    @property
    def dtype(self):
        return self.a.dtype

    @staticmethod
    def from_objs(objs: Sequence[FunctionObj], dtype: Any = None) -> "FunctionVector":
        h = np.array([int(o.h) for o in objs], dtype=np.int32)
        return FunctionVector(
            h,
            a=np.array([o.a for o in objs]),
            b=np.array([o.b for o in objs]),
            c=np.array([o.c for o in objs]),
            d=np.array([o.d for o in objs]),
            e=np.array([o.e for o in objs]),
            dtype=dtype,
        )

    def replace_params(self, a=None, b=None, c=None, d=None, e=None) -> "FunctionVector":
        new = FunctionVector.__new__(FunctionVector)
        new.h = self.h
        new.n = self.n
        new.a = self.a if a is None else a
        new.b = self.b if b is None else b
        new.c = self.c if c is None else c
        new.d = self.d if d is None else d
        new.e = self.e if e is None else e
        return new


@dataclasses.dataclass(frozen=True)
class ConeConstraint:
    """One cone constraint over a set of coordinate indices (the reference's
    prox_lib_cone.h:31-42): ``cone`` plus the indices, as a tuple of ints,
    of the entries of x (or y) that belong to it."""

    cone: Cone
    indices: tuple

    def __init__(self, cone: Cone, indices):
        object.__setattr__(self, "cone", Cone(cone))
        object.__setattr__(self, "indices", tuple(int(i) for i in indices))

    def __len__(self):
        return len(self.indices)


# Solver defaults — the reference's pogs.h.
DEFAULT_ABS_TOL = 1e-4
DEFAULT_REL_TOL = 1e-3
DEFAULT_RHO = 1.0
DEFAULT_MAX_ITER = 2500
DEFAULT_VERBOSE = 0


@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """Solver knobs; the same fields and defaults as the JAX package.

    ``use_fused`` switches the hand-written CUDA solve kernels
    (``ops/fused_admm.py`` for the graph form, ``ops/fused_hsde.py`` for the
    cone form): None = auto (on for eligible problems on a CUDA device),
    True = force (raises on an ineligible problem), False = always the eager
    loop.  ``polish`` turns on the interior-point tail polish of the eager
    cone loop (``solver/hsde.py``).  ``cgls_max_iter`` belongs to the
    indirect projector, which this package does not have yet, and is kept
    for a like-for-like settings surface.
    """

    abs_tol: float = DEFAULT_ABS_TOL
    rel_tol: float = DEFAULT_REL_TOL
    rho: float = DEFAULT_RHO
    max_iter: int = DEFAULT_MAX_ITER
    verbose: int = DEFAULT_VERBOSE
    adaptive_rho: bool = True
    gap_stop: bool = False
    use_exact_tol: bool = False
    use_anderson: bool = False
    anderson_mem: int = 5
    anderson_start: int = 10
    cgls_max_iter: int = 500
    use_fused: Optional[bool] = None
    polish: bool = True

    def replace(self, **kw) -> "SolverSettings":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class SolverResult:
    """Outputs of one solve: x, y, mu, lambda, optval, final_iter, status."""

    x: torch.Tensor
    y: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor  # the reference calls this lambda
    optval: torch.Tensor
    final_iter: torch.Tensor
    status: Status
    nrm_r: Optional[torch.Tensor] = None
    nrm_s: Optional[torch.Tensor] = None
    gap: Optional[torch.Tensor] = None
    rho: Optional[torch.Tensor] = None
    solve_time: Optional[float] = None

    @property
    def lam(self):
        return self.nu

    def as_dict(self):
        d = {
            "x": self.x.detach().cpu().numpy(),
            "y": self.y.detach().cpu().numpy(),
            "mu": self.mu.detach().cpu().numpy(),
            "l": self.nu.detach().cpu().numpy(),
            "optval": float(self.optval),
            "iterations": int(self.final_iter),
            "status": int(self.status),
        }
        if self.solve_time is not None:
            d["solve_time"] = self.solve_time
        return d
