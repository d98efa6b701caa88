"""ctypes binding of the native host runtime (libpogs_tpu_native).

Counterpart of ``pogs_tpu/native/__init__.py``.  The native library
(``src/native/``, C ABI in ``src/include/pogs_tpu_native.h``) is a
dependency-free C++ implementation of the same graph-form ADMM algorithm,
with a cone-form solver and specialised host solvers for the classic GLM
shapes (coordinate descent, closed-form ridge, dual CD, prox-Newton,
IRLS, active-set NNLS).  It serves callers on the host: small problems,
where a host solve costs less than the device's set-up, and an
independent numerics oracle for the device path.

The library is built from the checkout's sources at first use, by the host
C++ compiler with CMakeLists.txt's flags (``-std=c++20 -O3 -fPIC -shared``,
plus ``-fopenmp`` and ``-mavx2 -mfma`` where the compiler accepts them),
into ``build/pogs_tpu_torch/``, named by a hash of the sources, the header,
the compiler and the flags; a failed build raises.  Inputs may be numpy
arrays, tensors (copied to the host as float64), scipy sparse matrices or
sparse tensors; results are numpy arrays, as in the JAX package.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from pogs_tpu_torch.linalg.matrix import is_sparse_input
from pogs_tpu_torch.types import (
    ConeConstraint,
    Function,
    FunctionVector,
    SolverSettings,
    Status,
)

_REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _REPO_ROOT / "src" / "native" / "capi.cpp"
HEADER = _REPO_ROOT / "src" / "include" / "pogs_tpu_native.h"
BUILD_DIR = _REPO_ROOT / "build" / "pogs_tpu_torch"
BASE_FLAGS = ["-std=c++20", "-O3", "-fPIC", "-shared"]
# Flag groups CMakeLists.txt adds where the compiler takes them.
OPTIONAL_FLAGS = (["-fopenmp"], ["-mavx2", "-mfma"])

_lib: Optional[ct.CDLL] = None
_flags: Optional[list] = None


class PogsNativeSettings(ct.Structure):
    _fields_ = [
        ("abs_tol", ct.c_double),
        ("rel_tol", ct.c_double),
        ("rho", ct.c_double),
        ("max_iter", ct.c_int32),
        ("verbose", ct.c_int32),
        ("adaptive_rho", ct.c_int32),
        ("gap_stop", ct.c_int32),
        ("warm_start", ct.c_int32),
        ("cgls_max_iter", ct.c_int32),
        ("polish", ct.c_int32),
    ]


class PogsNativeInfo(ct.Structure):
    _fields_ = [
        ("optval", ct.c_double),
        ("final_iter", ct.c_int32),
        ("status", ct.c_int32),
        ("nrm_r", ct.c_double),
        ("nrm_s", ct.c_double),
        ("gap", ct.c_double),
        ("rho_final", ct.c_double),
    ]


_D = ct.POINTER(ct.c_double)
_I32 = ct.POINTER(ct.c_int32)
_I64 = ct.POINTER(ct.c_int64)


class PogsNativeCone(ct.Structure):
    _fields_ = [
        ("cone", ct.c_int32),
        ("indices", _I64),
        ("num_indices", ct.c_size_t),
    ]


def _bind(lib: ct.CDLL) -> ct.CDLL:
    lib.pogs_native_settings_default.argtypes = [ct.POINTER(PogsNativeSettings)]
    lib.pogs_native_settings_default.restype = None
    lib.pogs_native_version.argtypes = []
    lib.pogs_native_version.restype = ct.c_int32

    lib.pogs_native_dense_new.argtypes = [ct.c_int32, ct.c_size_t, ct.c_size_t, _D]
    lib.pogs_native_dense_new.restype = ct.c_void_p
    lib.pogs_native_dense_free.argtypes = [ct.c_void_p]
    lib.pogs_native_dense_free.restype = None
    lib.pogs_native_dense_solve.argtypes = (
        [ct.c_void_p, ct.POINTER(PogsNativeSettings)]
        + [_I32] + [_D] * 5 + [_I32] + [_D] * 5
        + [_D] * 4 + [ct.POINTER(PogsNativeInfo)]
    )
    lib.pogs_native_dense_solve.restype = ct.c_int32

    lib.pogs_native_sparse_new.argtypes = [
        ct.c_size_t, ct.c_size_t, ct.c_size_t, _I64, _I64, _D,
    ]
    lib.pogs_native_sparse_new.restype = ct.c_void_p
    lib.pogs_native_sparse_free.argtypes = [ct.c_void_p]
    lib.pogs_native_sparse_free.restype = None
    lib.pogs_native_sparse_solve.argtypes = lib.pogs_native_dense_solve.argtypes
    lib.pogs_native_sparse_solve.restype = ct.c_int32

    cones = [ct.POINTER(PogsNativeCone), ct.c_size_t]
    lib.pogs_native_cone_new.argtypes = [ct.c_int32, ct.c_size_t, ct.c_size_t, _D] + cones * 2
    lib.pogs_native_cone_new.restype = ct.c_void_p
    lib.pogs_native_cone_sparse_new.argtypes = [
        ct.c_size_t, ct.c_size_t, ct.c_size_t, _I64, _I64, _D,
    ] + cones * 2
    lib.pogs_native_cone_sparse_new.restype = ct.c_void_p
    lib.pogs_native_cone_qp_new.argtypes = [
        ct.c_int32, ct.c_size_t, ct.c_size_t, _D, _D,
    ] + cones
    lib.pogs_native_cone_qp_new.restype = ct.c_void_p
    lib.pogs_native_cone_qp_sparse_new.argtypes = [
        ct.c_size_t, ct.c_size_t, ct.c_size_t, _I64, _I64, _D, _D,
    ] + cones
    lib.pogs_native_cone_qp_sparse_new.restype = ct.c_void_p
    lib.pogs_native_cone_free.argtypes = [ct.c_void_p]
    lib.pogs_native_cone_free.restype = None
    lib.pogs_native_cone_solve.argtypes = [
        ct.c_void_p, ct.POINTER(PogsNativeSettings), _D, _D,
        _D, _D, _D, _D, ct.POINTER(PogsNativeInfo),
    ]
    lib.pogs_native_cone_solve.restype = ct.c_int32

    lib.pogs_native_lasso_cd.argtypes = [
        ct.c_size_t, ct.c_size_t, _D, _D, _D, _D,
        ct.POINTER(PogsNativeSettings),
        _D, _D, _D, _D, ct.POINTER(PogsNativeInfo),
    ]
    lib.pogs_native_lasso_cd.restype = ct.c_int32
    lib.pogs_native_ridge_direct.argtypes = [
        ct.c_size_t, ct.c_size_t, _D, _D, _D, _D, ct.POINTER(PogsNativeInfo),
    ]
    lib.pogs_native_ridge_direct.restype = ct.c_int32
    lib.pogs_native_svm_dual_cd.argtypes = [
        ct.c_size_t, ct.c_size_t, _D, _D, ct.c_double,
        ct.POINTER(PogsNativeSettings), _D, ct.POINTER(PogsNativeInfo),
    ]
    lib.pogs_native_svm_dual_cd.restype = ct.c_int32
    lib.pogs_native_logistic_pn.argtypes = [
        ct.c_size_t, ct.c_size_t, _D, _D, _D,
        ct.POINTER(PogsNativeSettings), _D, ct.POINTER(PogsNativeInfo),
    ]
    lib.pogs_native_logistic_pn.restype = ct.c_int32
    lib.pogs_native_huber_irls.argtypes = [
        ct.c_size_t, ct.c_size_t, _D, _D, ct.c_double, _D,
        ct.POINTER(PogsNativeSettings), _D, ct.POINTER(PogsNativeInfo),
    ]
    lib.pogs_native_huber_irls.restype = ct.c_int32
    lib.pogs_native_nnls.argtypes = [
        ct.c_size_t, ct.c_size_t, _D, _D,
        ct.POINTER(PogsNativeSettings), _D, ct.POINTER(PogsNativeInfo),
    ]
    lib.pogs_native_nnls.restype = ct.c_int32
    return lib


# -- build ---------------------------------------------------------------------

def compiler() -> str:
    """The host C++ compiler."""
    path = shutil.which("c++") or shutil.which("g++")
    if path is None:
        raise RuntimeError("no C++ compiler (c++ or g++) for the native library")
    return path


def _accepts(cxx: str, flags) -> bool:
    """Whether ``cxx`` compiles and links a shared library with ``flags``."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [cxx, *BASE_FLAGS, *flags, "-x", "c++", "-", "-o", os.path.join(tmp, "probe.so")],
            input="int pogs_probe() { return 0; }\n", capture_output=True, text=True)
    return proc.returncode == 0


def flags() -> list:
    """The compile flags: CMakeLists.txt's base flags, and each optional
    group the compiler accepts (probed once per process)."""
    global _flags
    if _flags is None:
        cxx = compiler()
        _flags = BASE_FLAGS + [f for group in OPTIONAL_FLAGS if _accepts(cxx, group) for f in group]
    return list(_flags)


def library_path() -> Path:
    """Where the library built from this checkout's sources lives: named by
    a hash of the sources, the header, the compiler (its path and version)
    and the flags."""
    h = hashlib.sha256()
    for src in [SOURCE, HEADER, *sorted(SOURCE.parent.glob("*.hpp"))]:
        h.update(src.name.encode() + src.read_bytes())
    cxx = compiler()
    h.update(cxx.encode())
    h.update(subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout.encode())
    h.update(" ".join(flags()).encode())
    return BUILD_DIR / f"libpogs_tpu_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``src/native/capi.cpp`` into ``build/pogs_tpu_torch/`` unless
    the library of these sources and flags is there already; returns its
    path.  The compiler writes a temporary file that is renamed into place,
    so concurrent builders never load a partial library.  Raises
    RuntimeError when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [compiler(), *flags(), "-I", str(HEADER.parent), "-o", tmp, str(SOURCE)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native library build failed:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ct.CDLL:
    """The bound library, built first if needed."""
    global _lib
    if _lib is None:
        _lib = _bind(ct.CDLL(str(build())))
    return _lib


def is_available() -> bool:
    """Whether the native library builds and loads here (a C++ compiler
    that takes the sources); builds it on the first call."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def version() -> int:
    return int(load().pogs_native_version())


# -- host data -----------------------------------------------------------------

def _dense(A) -> np.ndarray:
    """A dense A (ndarray or tensor) as a row-major float64 host array."""
    if isinstance(A, torch.Tensor):
        A = A.detach().cpu().numpy()
    A = np.ascontiguousarray(np.asarray(A, dtype=np.float64))
    if A.ndim != 2:
        raise ValueError("A must be 2-D")
    return A


def _vector(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(v, dtype=np.float64).ravel())


def _csr(A):
    """A scipy sparse matrix or a sparse tensor as a scipy CSR matrix."""
    import scipy.sparse as sp

    if isinstance(A, torch.Tensor):
        C = A.detach().to_sparse_coo().coalesce().cpu()
        i, j = C.indices().numpy()
        return sp.csr_matrix((C.values().double().numpy(), (i, j)), shape=tuple(C.shape))
    return sp.csr_matrix(A)


def _csr_arrays(A):
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int64)
    data = np.ascontiguousarray(A.data, dtype=np.float64)
    return indptr, indices, data


def _host_fv(fv: FunctionVector):
    """A FunctionVector's codes and parameters (a..e) as host float64 arrays."""
    return SimpleNamespace(h=np.ascontiguousarray(fv.h, dtype=np.int32),
                           **{k: _vector(p) for k, p in zip("abcde", fv.params)})


def _settings_struct(settings: SolverSettings, warm_start: bool) -> PogsNativeSettings:
    st = PogsNativeSettings()
    load().pogs_native_settings_default(ct.byref(st))
    st.abs_tol = settings.abs_tol
    st.rel_tol = settings.rel_tol
    st.rho = settings.rho
    st.max_iter = settings.max_iter
    st.verbose = settings.verbose
    st.adaptive_rho = int(settings.adaptive_rho)
    st.gap_stop = int(settings.gap_stop)
    st.warm_start = int(warm_start)
    st.cgls_max_iter = settings.cgls_max_iter
    st.polish = int(settings.polish)
    return st


def _fv_arrays(fv: FunctionVector, n: int):
    hv = _host_fv(fv)
    if hv.h.shape[0] != n:
        raise ValueError(f"objective length {hv.h.shape[0]} != {n}")
    params = [hv.a, hv.b, hv.c, hv.d, hv.e]
    ptrs = [hv.h.ctypes.data_as(_I32)] + [p.ctypes.data_as(_D) for p in params]
    return ptrs, (hv.h, params)  # keep refs alive


def _result(x, y, mu, nu, info, status, **extra) -> dict:
    return {"x": x, "y": y, "mu": mu, "l": nu,
            "optval": float(info.optval), "iterations": int(info.final_iter),
            "status": Status(int(status)), "nrm_r": float(info.nrm_r),
            "nrm_s": float(info.nrm_s), **extra}


# -- graph-form solvers ----------------------------------------------------------

class _NativeSolverBase:
    """Shared solve plumbing for the dense/sparse handles."""

    _handle = None
    m = 0
    n = 0

    def solve(self, f: FunctionVector, g: FunctionVector,
              settings: Optional[SolverSettings] = None,
              warm_start: bool = False) -> dict:
        if self._handle is None:
            raise RuntimeError("solver already freed")
        st = _settings_struct(settings or SolverSettings(), warm_start)
        f_ptrs, f_keep = _fv_arrays(f, self.m)
        g_ptrs, g_keep = _fv_arrays(g, self.n)
        x, y, mu, nu = np.empty(self.n), np.empty(self.m), np.empty(self.n), np.empty(self.m)
        info = PogsNativeInfo()
        status = self._solve_fn(
            self._handle, ct.byref(st), *f_ptrs, *g_ptrs,
            x.ctypes.data_as(_D), y.ctypes.data_as(_D),
            mu.ctypes.data_as(_D), nu.ctypes.data_as(_D), ct.byref(info),
        )
        del f_keep, g_keep
        return _result(x, y, mu, nu, info, status, rho=float(info.rho_final))

    def free(self):
        if self._handle is not None:
            self._free_fn(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.free()
        except Exception:
            pass


class NativeDenseSolver(_NativeSolverBase):
    """Handle-based dense solver (factorization + warm start persist)."""

    def __init__(self, A):
        lib = load()
        A = _dense(A)
        self.m, self.n = A.shape
        self._solve_fn = lib.pogs_native_dense_solve
        self._free_fn = lib.pogs_native_dense_free
        self._handle = lib.pogs_native_dense_new(0, self.m, self.n, A.ctypes.data_as(_D))
        if not self._handle:
            raise RuntimeError("pogs_native_dense_new failed")


class NativeSparseSolver(_NativeSolverBase):
    """Handle-based CSR solver (CGLS projector)."""

    def __init__(self, A):
        lib = load()
        A = _csr(A)
        self.m, self.n = A.shape
        indptr, indices, data = _csr_arrays(A)
        self._solve_fn = lib.pogs_native_sparse_solve
        self._free_fn = lib.pogs_native_sparse_free
        self._handle = lib.pogs_native_sparse_new(
            self.m, self.n, data.shape[0],
            indptr.ctypes.data_as(_I64), indices.ctypes.data_as(_I64),
            data.ctypes.data_as(_D),
        )
        if not self._handle:
            raise RuntimeError("pogs_native_sparse_new failed")


# -- cone form -------------------------------------------------------------------

class NativeConeSolver:
    """Handle-based cone solver: min c'x (+ ½x'Px) s.t. b − Ax ∈ K_y, x ∈ K_x.

    Graph-form cone ADMM in exact-tolerance mode.  SDP blocks must be
    svec-packed (column-major lower triangle, √2-scaled off-diagonals — the
    CVXPY/SCS conic-data convention; the contract of
    ConeSolver(assume_svec=True)).  ``P`` (dense n×n) selects the QP variant
    (the reference's PogsConeQD/PogsConeDirectQD, pogs_c.h:167-243); K_x
    must then be empty, as in the reference (pogs.cpp:1941-1944).
    """

    def __init__(self, A, Kx=(), Ky=(), P=None):
        lib = load()
        sparse_in = is_sparse_input(A)
        A = _csr(A) if sparse_in else _dense(A)
        self.m, self.n = A.shape
        self._lib = lib

        def pack(cones):
            cones = [c if isinstance(c, ConeConstraint) else ConeConstraint(*c) for c in cones]
            idx_arrays = [np.asarray(c.indices, dtype=np.int64) for c in cones]
            arr = (PogsNativeCone * max(len(cones), 1))()
            for i, (c, idx) in enumerate(zip(cones, idx_arrays)):
                arr[i].cone = int(c.cone)
                arr[i].indices = idx.ctypes.data_as(_I64)
                arr[i].num_indices = idx.shape[0]
            return arr, len(cones), idx_arrays

        kx_arr, n_kx, self._kx_keep = pack(Kx)
        ky_arr, n_ky, self._ky_keep = pack(Ky)
        if P is not None:
            if len(Kx) > 0:
                raise ValueError(
                    "quadratic objectives with K_x constraints are not "
                    "supported (composition would not be an exact prox; the "
                    "reference rejects this too, pogs.cpp:1941-1944)"
                )
            P = _dense(P)
            if P.shape != (self.n, self.n):
                raise ValueError(f"P must be {self.n}x{self.n}")
        if sparse_in:
            indptr, indices, data = _csr_arrays(A)
            csr = (self.m, self.n, data.shape[0], indptr.ctypes.data_as(_I64),
                   indices.ctypes.data_as(_I64), data.ctypes.data_as(_D))
            if P is not None:
                self._handle = lib.pogs_native_cone_qp_sparse_new(
                    *csr, P.ctypes.data_as(_D), ky_arr, n_ky)
            else:
                self._handle = lib.pogs_native_cone_sparse_new(*csr, kx_arr, n_kx, ky_arr, n_ky)
        elif P is not None:
            self._handle = lib.pogs_native_cone_qp_new(
                0, self.m, self.n, A.ctypes.data_as(_D), P.ctypes.data_as(_D), ky_arr, n_ky)
        else:
            self._handle = lib.pogs_native_cone_new(
                0, self.m, self.n, A.ctypes.data_as(_D), kx_arr, n_kx, ky_arr, n_ky)
        if not self._handle:
            raise RuntimeError("pogs_native_cone_new failed (invalid cone specification)")

    def solve(self, b, c, settings: Optional[SolverSettings] = None,
              warm_start: bool = False) -> dict:
        if self._handle is None:
            raise RuntimeError("solver already freed")
        st = _settings_struct(settings or SolverSettings(), warm_start)
        b, c = _vector(b), _vector(c)
        if b.shape[0] != self.m or c.shape[0] != self.n:
            raise ValueError("b/c length mismatch")
        x, y, mu, nu = np.empty(self.n), np.empty(self.m), np.empty(self.n), np.empty(self.m)
        info = PogsNativeInfo()
        status = self._lib.pogs_native_cone_solve(
            self._handle, ct.byref(st), b.ctypes.data_as(_D), c.ctypes.data_as(_D),
            x.ctypes.data_as(_D), y.ctypes.data_as(_D),
            mu.ctypes.data_as(_D), nu.ctypes.data_as(_D), ct.byref(info),
        )
        return _result(x, y, mu, nu, info, status)

    def free(self):
        if self._handle is not None:
            self._lib.pogs_native_cone_free(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.free()
        except Exception:
            pass


def solve_cone_native(A, b, c, Kx=(), Ky=(), P=None,
                      settings: Optional[SolverSettings] = None, **kw) -> dict:
    """One-shot native cone solve (P selects the QP variant)."""
    if settings is None:
        settings = SolverSettings(**kw)
    solver = NativeConeSolver(A, Kx=Kx, Ky=Ky, P=P)
    try:
        return solver.solve(b, c, settings)
    finally:
        solver.free()


# -- specialised host solvers ----------------------------------------------------

def _all_eq(v, want):
    return np.all(np.asarray(v) == want)


def _lasso_shape(f, g):
    """Detect min ½‖y−b‖² + Σ l1|x| + ½Σ l2 x²  (lasso / elastic net) on the
    host parameters of f and g.  Returns (b, l1, l2) or None: the shape the
    coordinate-descent path solves directly."""
    if not (np.all(f.h == int(Function.SQUARE)) and np.all(g.h == int(Function.ABS))):
        return None
    for v, want in ((f.a, 1.0), (f.c, 1.0), (f.d, 0.0), (f.e, 0.0),
                    (g.a, 1.0), (g.b, 0.0), (g.d, 0.0)):
        if not _all_eq(v, want):
            return None
    if np.any(g.c < 0) or np.any(g.e < 0):
        return None
    return (f.b, g.c, g.e)


def _l1_or_none(g):
    """λ‖x‖₁ coefficients when g is ABS (or zeros when g is ZERO)."""
    if (np.all(g.h == int(Function.ABS))
            and all(_all_eq(v, w) for v, w in ((g.a, 1.0), (g.b, 0.0), (g.d, 0.0), (g.e, 0.0)))):
        return g.c if np.all(g.c >= 0) else None
    if np.all(g.h == int(Function.ZERO)):
        return np.zeros(1)
    return None


def _glm_shape(f, g):
    """Classify ridge / hinge-SVM / l1-logistic / NNLS / huber shapes for the
    GLM fast paths (src/native/glm.hpp).  Returns (kind, payload) or None."""
    fh, gh = f.h, g.h
    # ridge: ½‖y−b‖² + ½Σ(c+e) x²
    if (np.all(fh == int(Function.SQUARE)) and np.all(gh == int(Function.SQUARE))
            and all(_all_eq(v, w) for v, w in
                    ((f.a, 1.0), (f.c, 1.0), (f.d, 0.0), (f.e, 0.0),
                     (g.a, 1.0), (g.b, 0.0), (g.d, 0.0)))):
        l2 = g.c + g.e
        if np.all(l2 >= 0):
            return ("ridge", (f.b, l2))
    # labels for the margin losses arrive as a = -y with y in {-1, +1}
    y = -f.a
    labels_ok = np.all(np.abs(y) == 1.0)
    # svm: Σ max(0, 1−y a'x) + (λ/2)‖x‖²
    if (np.all(fh == int(Function.MAXPOS0)) and labels_ok
            and np.all(gh == int(Function.SQUARE))
            and all(_all_eq(v, w) for v, w in
                    ((f.b, -1.0), (f.c, 1.0), (f.d, 0.0), (f.e, 0.0),
                     (g.a, 1.0), (g.b, 0.0), (g.d, 0.0), (g.e, 0.0)))):
        if np.all(g.c == g.c[0]) and g.c[0] > 0:
            return ("svm", (y, float(g.c[0])))
    # logistic: Σ log(1+exp(−y a'x)) + Σ l1|x|  (l1 may be 0 via ZERO g)
    if (np.all(fh == int(Function.LOGISTIC)) and labels_ok
            and all(_all_eq(v, w) for v, w in ((f.b, 0.0), (f.c, 1.0), (f.d, 0.0), (f.e, 0.0)))):
        l1 = _l1_or_none(g)
        if l1 is not None:
            return ("logistic", (y, l1))
    # nnls: ½‖y−b‖² with x ≥ 0 (g = INDGE0); the active set needs the dense
    # normal equations, so cap n.
    if (np.all(fh == int(Function.SQUARE)) and np.all(gh == int(Function.INDGE0))
            and gh.shape[0] <= 2000
            and all(_all_eq(v, w) for v, w in
                    ((f.a, 1.0), (f.c, 1.0), (f.d, 0.0), (f.e, 0.0),
                     (g.a, 1.0), (g.b, 0.0), (g.d, 0.0), (g.e, 0.0)))):
        return ("nnls", (f.b,))
    # huber: Σ huber_δ(a'x − b) + Σ l1|x|, encoded a=1/δ, b=b/δ, c=δ²
    # (api/graph.py::solve_huber)
    if np.all(fh == int(Function.HUBER)) and _all_eq(f.d, 0.0) and _all_eq(f.e, 0.0):
        a0 = float(f.a[0])
        if (a0 > 0 and np.all(f.a == a0)
                and np.allclose(f.c * a0 * a0, 1.0, rtol=1e-12, atol=0)):
            l1 = _l1_or_none(g)
            if l1 is not None:
                return ("huber", (f.b / a0, 1.0 / a0, l1))
    return None


def _glm_result(x, y_out, nu, A, optval, iters, status_code, kkt, algorithm):
    # Graph-form dual convention: nu = grad f(y) (or a subgradient),
    # mu = -A'nu (in the subdifferential of g at the optimum).
    return {
        "x": x, "y": y_out, "mu": -(A.T @ nu), "l": nu,
        "optval": float(optval), "iterations": int(iters),
        "status": Status(int(status_code)),
        "nrm_r": 0.0, "nrm_s": float(kkt), "rho": 0.0, "algorithm": algorithm,
    }


def _per_coord(v, n) -> np.ndarray:
    return np.ascontiguousarray(np.broadcast_to(np.asarray(v, np.float64), (n,)))


def _start(x0, n) -> np.ndarray:
    return np.zeros(n) if x0 is None else _vector(x0).copy()


def lasso_cd(A, b, l1, l2=None, settings: Optional[SolverSettings] = None,
             x0=None) -> dict:
    """Coordinate descent for elastic-net least squares (src/native/cd.hpp).
    ``l1``/``l2`` broadcast to length n; ``x0`` warm-starts the sweeps."""
    lib = load()
    A = _dense(A)
    m, n = A.shape
    b = _vector(b)
    l1 = _per_coord(l1, n)
    l2 = _per_coord(0.0 if l2 is None else l2, n)
    st = _settings_struct(settings or SolverSettings(), x0 is not None)
    x = _start(x0, n)
    y, mu, nu = np.empty(m), np.empty(n), np.empty(m)
    info = PogsNativeInfo()
    status = lib.pogs_native_lasso_cd(
        m, n, A.ctypes.data_as(_D), b.ctypes.data_as(_D),
        l1.ctypes.data_as(_D), l2.ctypes.data_as(_D), ct.byref(st),
        x.ctypes.data_as(_D), y.ctypes.data_as(_D),
        mu.ctypes.data_as(_D), nu.ctypes.data_as(_D), ct.byref(info),
    )
    return _result(x, y, mu, nu, info, status, rho=0.0, algorithm="cd")


def lasso_path_cd(A, b, lambdas, l2=0.0, settings: Optional[SolverSettings] = None):
    """Warm-started λ-path through :func:`lasso_cd`: each grid point starts
    from the previous solution (the reference's LassoPath pattern,
    examples/cpp/lasso_path.cpp).  Returns x (K, n), optval (K,), sweeps
    (K,) and the lambdas."""
    lambdas = _vector(lambdas)
    xs, opts, sweeps = [], [], []
    x0 = None
    for lam in lambdas:
        out = lasso_cd(A, b, lam, l2, settings=settings, x0=x0)
        x0 = out["x"]
        xs.append(out["x"])
        opts.append(out["optval"])
        sweeps.append(out["iterations"])
    return {"x": np.stack(xs), "optval": np.asarray(opts),
            "sweeps": np.asarray(sweeps, np.int64), "lambdas": lambdas}


def ridge_direct(A, b, l2) -> dict:
    """Closed-form ridge: one Gram + Cholesky solve (the m×m dual form for
    a wide A) — src/native/glm.hpp."""
    lib = load()
    A = _dense(A)
    m, n = A.shape
    b = _vector(b)
    l2 = _per_coord(l2, n)
    x = np.empty(n)
    info = PogsNativeInfo()
    status = lib.pogs_native_ridge_direct(
        m, n, A.ctypes.data_as(_D), b.ctypes.data_as(_D),
        l2.ctypes.data_as(_D), x.ctypes.data_as(_D), ct.byref(info))
    y_out = A @ x
    return _glm_result(x, y_out, y_out - b, A, info.optval, info.final_iter, status,
                       info.nrm_s, "ridge_direct")


def svm_cd(A, y, lam, settings: Optional[SolverSettings] = None) -> dict:
    """Hinge-loss SVM by liblinear-style dual coordinate descent
    (src/native/glm.hpp)."""
    lib = load()
    A = _dense(A)
    m, n = A.shape
    y = _vector(y)
    st = _settings_struct(settings or SolverSettings(), False)
    x = np.empty(n)
    info = PogsNativeInfo()
    status = lib.pogs_native_svm_dual_cd(
        m, n, A.ctypes.data_as(_D), y.ctypes.data_as(_D), float(lam),
        ct.byref(st), x.ctypes.data_as(_D), ct.byref(info))
    z = A @ x
    # hinge subgradient wrt z: -y on violated margins, 0 on satisfied
    nu = np.where(y * z < 1.0, -y, 0.0)
    return _glm_result(x, z, nu, A, info.optval, info.final_iter, status, info.nrm_s,
                       "svm_dual_cd")


def logistic_pn(A, y, l1, settings: Optional[SolverSettings] = None, x0=None) -> dict:
    """L1 logistic regression by glmnet-style prox-Newton
    (src/native/glm.hpp): IRLS quadratic model, inner weighted lasso by
    coordinate descent, damped on the true loss."""
    lib = load()
    A = _dense(A)
    m, n = A.shape
    y = _vector(y)
    l1 = _per_coord(l1, n)
    st = _settings_struct(settings or SolverSettings(), x0 is not None)
    x = _start(x0, n)
    info = PogsNativeInfo()
    status = lib.pogs_native_logistic_pn(
        m, n, A.ctypes.data_as(_D), y.ctypes.data_as(_D),
        l1.ctypes.data_as(_D), ct.byref(st), x.ctypes.data_as(_D), ct.byref(info))
    z = A @ x
    nu = -y / (1.0 + np.exp(y * z))  # gradient of the logistic loss
    return _glm_result(x, z, nu, A, info.optval, info.final_iter, status, info.nrm_s,
                       "logistic_pn")


def nnls(A, b, settings: Optional[SolverSettings] = None) -> dict:
    """Nonnegative least squares by an active set on the normal equations
    (src/native/glm.hpp).  A rejected active set returns status ERROR (the
    caller, :func:`solve_graph_native`, then runs the ADMM runtime)."""
    lib = load()
    A = _dense(A)
    m, n = A.shape
    b = _vector(b)
    st = _settings_struct(settings or SolverSettings(), False)
    x = np.zeros(n)
    info = PogsNativeInfo()
    status = lib.pogs_native_nnls(
        m, n, A.ctypes.data_as(_D), b.ctypes.data_as(_D), ct.byref(st),
        x.ctypes.data_as(_D), ct.byref(info))
    y_out = A @ x
    return _glm_result(x, y_out, y_out - b, A, info.optval, info.final_iter, status,
                       info.nrm_s, "nnls_pdas")


def huber_irls(A, b, delta, l1, settings: Optional[SolverSettings] = None, x0=None) -> dict:
    """Huber regression (+ optional l1) by IRLS / majorize-minimize
    (src/native/glm.hpp): each step a reweighted lasso by coordinate
    descent; monotone decrease, no line search."""
    lib = load()
    A = _dense(A)
    m, n = A.shape
    b = _vector(b)
    l1 = _per_coord(l1, n)
    st = _settings_struct(settings or SolverSettings(), x0 is not None)
    x = _start(x0, n)
    info = PogsNativeInfo()
    status = lib.pogs_native_huber_irls(
        m, n, A.ctypes.data_as(_D), b.ctypes.data_as(_D), float(delta),
        l1.ctypes.data_as(_D), ct.byref(st), x.ctypes.data_as(_D), ct.byref(info))
    z = A @ x
    nu = np.clip(z - b, -float(delta), float(delta))  # huber' at residual
    return _glm_result(x, z, nu, A, info.optval, info.final_iter, status, info.nrm_s,
                       "huber_irls")


def solve_graph_native(A, f: FunctionVector, g: FunctionVector,
                       settings: Optional[SolverSettings] = None, **kw) -> dict:
    """One-shot native solve of min f(y) + g(x) s.t. y = Ax.

    A dense A uses the direct projector, a sparse one (scipy, or a sparse
    tensor) CGLS.  Classic GLM shapes of a dense A take the specialised
    paths: lasso / elastic net → coordinate descent (:func:`lasso_cd`),
    ridge → direct Cholesky, hinge SVM → dual CD, l1-logistic →
    prox-Newton, huber → IRLS, NNLS (at abs_tol ≤ 1e-7) → active set.
    Takes the same keyword tolerances as the Python API.
    """
    if settings is None:
        settings = SolverSettings(**kw)
    if is_sparse_input(A):
        solver = NativeSparseSolver(A)
    else:
        A = _dense(A)
        fh, gh = _host_fv(f), _host_fv(g)
        shape = _lasso_shape(fh, gh)
        if shape is not None:
            b, l1, l2 = shape
            return lasso_cd(A, b, l1, l2, settings=settings)
        glm = _glm_shape(fh, gh)
        if glm is not None:
            kind, payload = glm
            if kind == "ridge":
                out = ridge_direct(A, *payload)
                # Singular normal equations (l2 = 0 with rank-deficient A'A):
                # the ADMM runtime below.
                if out["status"] != Status.ERROR:
                    return out
            elif kind == "svm":
                return svm_cd(A, *payload, settings=settings)
            elif kind == "huber":
                return huber_irls(A, *payload, settings=settings)
            elif kind == "nnls":
                # The exact active set costs several dense factorizations;
                # the ADMM loop is faster at benchmark tolerances.  The active
                # set runs only where the caller asks for accuracy ADMM cannot
                # reach; a rejection goes on to ADMM either way.
                if settings.abs_tol <= 1e-7:
                    out = nnls(A, *payload, settings=settings)
                    if out["status"] != Status.ERROR:
                        return out
            else:
                return logistic_pn(A, *payload, settings=settings)
        solver = NativeDenseSolver(A)
    try:
        return solver.solve(f, g, settings)
    finally:
        solver.free()
