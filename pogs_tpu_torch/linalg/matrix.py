"""Dense and sparse matrix operators with the contract the solvers consume.

Counterpart of ``pogs_tpu/linalg/matrix.py``:

    mv(x)      — A @ x            rmv(y)    — Aᵀ @ y
    sq_mv(v)   — (A∘A) @ v        sq_rmv(v) — (A∘A)ᵀ @ v     (equilibration)
    scale(d,e) — diag(d)·A·diag(e) as a new operator
    frob2()    — ‖A‖_F²           dense()   — the dense tensor (dense only)

The sparse operator keeps A as a CSR tensor and a second CSR tensor of Aᵀ,
built once: the dual CSR + CSC layout of the reference's sparse matrix, so
that A·x and Aᵀ·y both stream by row (on a CUDA device each product is one
cuSPARSE SpMV).  The values of Aᵀ are those of A taken through a stored
permutation, so a new operator with other values (``scale``,
``scalar_mul``) shares the index arrays and never sorts again.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch


class DenseMatrix:
    def __init__(self, A: torch.Tensor):
        self.A = A

    @property
    def shape(self):
        return tuple(self.A.shape)

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def device(self):
        return self.A.device

    @property
    def is_sparse(self):
        return False

    def mv(self, x):
        return torch.mv(self.A, x)

    def rmv(self, y):
        return torch.mv(self.A.T, y)

    def sq_mv(self, v):
        return torch.mv(self.A * self.A, v)

    def sq_rmv(self, v):
        return torch.mv((self.A * self.A).T, v)

    def scale(self, d, e) -> "DenseMatrix":
        return DenseMatrix(self.A * d[:, None] * e[None, :])

    def scalar_mul(self, s) -> "DenseMatrix":
        return DenseMatrix(self.A * s)

    def frob2(self):
        return torch.sum(self.A * self.A)

    def dense(self):
        return self.A


@contextlib.contextmanager
def _quiet():
    """Where the port builds its sparse tensors: torch's notices that sparse
    CSR is in beta and that the invariant checks are off (the structure is
    made here, sorted and coalesced) are silenced."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")
        warnings.filterwarnings("ignore", message="Sparse invariant checks are implicitly disabled")
        yield


def _csr(crow, col, values, shape):
    with _quiet():
        return torch.sparse_csr_tensor(crow, col, values, size=shape, check_invariants=False)


class _Structure:
    """The index arrays of a sparse A, shared by every operator made from it:
    the CSR of A, the CSR of Aᵀ, each nonzero's row (for ``scale``) and the
    permutation that takes A's values in CSR order to Aᵀ's."""

    def __init__(self, rows: torch.Tensor, cols: torch.Tensor, shape):
        m, n = shape
        nnz = rows.numel()
        dev = rows.device
        # cuSPARSE takes 32-bit indices; 64-bit only where they do not fit.
        idx = torch.int32 if max(nnz, m, n) < 2**31 else torch.int64

        def crow_of(keys, size):
            crow = torch.zeros(size + 1, dtype=torch.int64, device=dev)
            crow[1:] = torch.cumsum(torch.bincount(keys, minlength=size), 0)
            return crow.to(idx)

        # rows/cols are in row-major order; a stable sort by column keeps the
        # rows ascending within each column, which is the CSR order of Aᵀ.
        self.perm = torch.argsort(cols, stable=True)
        self.rows = rows
        self.cols = cols
        self.shape = (m, n)
        self.crow = crow_of(rows, m)
        self.col = cols.to(idx)
        self.crow_t = crow_of(cols, n)
        self.col_t = rows[self.perm].to(idx)


class SparseMatrix:
    """Sparse operator on CSR tensors of A and of Aᵀ (see the module note).

    Made by :func:`as_matrix_op`, or by :meth:`from_coo` from row-major
    sorted, duplicate-free coordinates."""

    def __init__(self, structure: _Structure, values: torch.Tensor):
        self._s = structure
        self.values = values
        m, n = structure.shape
        self.M = _csr(structure.crow, structure.col, values, (m, n))
        self.MT = _csr(structure.crow_t, structure.col_t, values[structure.perm], (n, m))
        self._sq = None

    @classmethod
    def from_coo(cls, rows, cols, values, shape) -> "SparseMatrix":
        """From coordinates in row-major order with no duplicates (as a
        coalesced COO tensor holds them); the values set dtype and device."""
        dev = values.device
        return cls(_Structure(rows.to(device=dev, dtype=torch.int64),
                              cols.to(device=dev, dtype=torch.int64), shape), values)

    @property
    def shape(self):
        return self._s.shape

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def is_sparse(self):
        return True

    def mv(self, x):
        return torch.mv(self.M, x)

    def rmv(self, y):
        return torch.mv(self.MT, y)

    def _squared(self):
        # The squared values, made once per operator (equilibration applies
        # them 100 times).
        if self._sq is None:
            self._sq = SparseMatrix(self._s, self.values * self.values)
        return self._sq

    def sq_mv(self, v):
        return self._squared().mv(v)

    def sq_rmv(self, v):
        return self._squared().rmv(v)

    def scale(self, d, e) -> "SparseMatrix":
        return SparseMatrix(self._s, self.values * d[self._s.rows] * e[self._s.cols])

    def scalar_mul(self, s) -> "SparseMatrix":
        return SparseMatrix(self._s, self.values * s)

    def frob2(self):
        return torch.sum(self.values * self.values)

    def to(self, device=None, dtype=None) -> "SparseMatrix":
        """The operator with its values (and indices) on ``device`` in ``dtype``."""
        values = self.values.to(device=device, dtype=dtype)
        if values.device == self.device:
            return SparseMatrix(self._s, values)
        return SparseMatrix.from_coo(self._s.rows, self._s.cols, values, self.shape)

    def to_dense(self) -> torch.Tensor:
        """A as a dense tensor, for the callers that densify on purpose (the
        ``densify`` policy, the polish's Cholesky burst)."""
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        out[self._s.rows, self._s.cols] = self.values
        return out

    def dense(self):
        raise TypeError("SparseMatrix cannot be materialized for the direct "
                        "projector; use projector='cgls'")


def input_dtype(A):
    """The solve dtype of an input: float64 for float64 input, else float32."""
    src = A.dtype if hasattr(A, "dtype") else np.asarray(A).dtype
    return torch.float64 if src in (torch.float64, np.float64) else torch.float32


def is_sparse_input(A) -> bool:
    """A scipy sparse matrix, or a torch tensor in a sparse layout."""
    if isinstance(A, torch.Tensor):
        return A.layout != torch.strided
    return hasattr(A, "tocoo") or (hasattr(A, "todense") and not isinstance(A, np.ndarray))


def _torch_coo(A, dtype, device) -> torch.Tensor:
    """A scipy matrix or a sparse tensor as a coalesced COO tensor."""
    with _quiet():
        if isinstance(A, torch.Tensor):
            T = A if A.layout == torch.sparse_coo else A.to_sparse_coo()
        else:
            C = A.tocoo()
            ij = np.vstack([np.asarray(C.row, np.int64), np.asarray(C.col, np.int64)])
            T = torch.sparse_coo_tensor(torch.from_numpy(ij), torch.from_numpy(np.asarray(C.data)),
                                        size=C.shape, check_invariants=False)
        return T.to(device=device, dtype=dtype).coalesce()


def as_matrix_op(A, dtype=None, device=None):
    """A dense tensor or ndarray, a scipy sparse matrix, or a sparse torch
    tensor (COO or CSR) as a DenseMatrix or SparseMatrix on ``device``
    (default: a tensor's own device, else the CPU) in ``dtype`` (default:
    float64 input in float64, anything else in float32).  Duplicate
    coordinates are summed."""
    if isinstance(A, (DenseMatrix, SparseMatrix)) or is_sharded(A):
        return A
    if device is None:
        device = A.device if isinstance(A, torch.Tensor) else torch.device("cpu")
    if dtype is None:
        dtype = input_dtype(A)
    if is_sparse_input(A):
        T = _torch_coo(A, dtype, device)
        ij = T.indices()
        return SparseMatrix.from_coo(ij[0], ij[1], T.values(), tuple(T.shape))
    A_t = A if isinstance(A, torch.Tensor) else torch.as_tensor(np.asarray(A))
    return DenseMatrix(A_t.to(device=device, dtype=dtype))


def split_bounds(total: int, parts: int, index: int):
    """[lo, hi) of block ``index`` of ``total`` split into ``parts``
    contiguous blocks, the first ``total % parts`` one longer (how a sharded
    operator splits its side)."""
    base, extra = divmod(total, parts)
    lo = index * base + min(index, extra)
    return lo, lo + base + (1 if index < extra else 0)


def is_sharded(A) -> bool:
    """A sharded operator (``parallel/mesh.py``, ``parallel/sparse.py``)."""
    return getattr(A, "sharded_side", None) is not None


def local_shape(A):
    """The lengths (m, n) of the y- and x-side vectors this rank holds: A's
    shape, or a sharded operator's ``local_shape``."""
    return tuple(getattr(A, "local_shape", A.shape))


def whole(A, side: str, v):
    """A vector of ``side`` ("m" or "n") whole: gathered where A splits that
    side, else ``v`` itself."""
    return A.gather(v) if getattr(A, "sharded_side", None) == side else v


def part(A, side: str, v):
    """This rank's part of a whole vector of ``side``."""
    return A.local(v) if getattr(A, "sharded_side", None) == side else v


def side_total(A, side: str, t):
    """A scalar partial sum over ``side`` summed across the shards that split
    it (one ``reduce``); ``t`` itself elsewhere."""
    if getattr(A, "sharded_side", None) == side:
        return A.reduce(t.reshape(1))[0]
    return t


def side_sums(A, side: str, terms):
    """The sums of one side's vectors: each term ``("norm", v)``,
    ``("sum2", v)``, ``("dot", u, v)`` or ``("sum", v)``.

    Where A splits ``side`` the local partial sums (a norm's as its sum of
    squares) go through ONE ``A.reduce`` and the norms take their square
    root after it; elsewhere each term is the single-device call itself, so
    an unsharded solve computes what it always did.  Returns a list."""
    sharded = getattr(A, "sharded_side", None) == side
    vals = []
    for kind, *ts in terms:
        if kind == "norm":
            vals.append(torch.sum(ts[0] * ts[0]) if sharded else torch.linalg.vector_norm(ts[0]))
        elif kind == "sum2":
            vals.append(torch.sum(ts[0] * ts[0]))
        elif kind == "dot":
            vals.append(torch.dot(ts[0], ts[1]))
        elif kind == "sum":
            vals.append(torch.sum(ts[0]))
        else:
            raise ValueError(f"unknown sum {kind!r}")
    if not sharded or not vals:
        return vals
    red = A.reduce(torch.stack(vals))
    return [torch.sqrt(red[i]) if t[0] == "norm" else red[i] for i, t in enumerate(terms)]


def matvecs(A):
    """(A·, Aᵀ·) as closures for a dense tensor or a matrix operator."""
    if hasattr(A, "rmv"):
        return A.mv, A.rmv
    return (lambda x: torch.mv(A, x)), (lambda y: torch.mv(A.T, y))
