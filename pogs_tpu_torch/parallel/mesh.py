"""Process meshes, sharded dense matrices and the collectives of a sharded
solve, on ``torch.distributed``.

Counterpart of ``pogs_tpu/parallel/mesh.py``.  There the mesh only places
the arrays and GSPMD inserts the collectives into the unchanged solver.
PyTorch has no such pass, so here the operator carries them: a
:class:`ShardedMatrix` holds one rank's block of A and makes every product
and every reduction that crosses its shards explicit.

Row plan (``shard_matrix``, tall A): each rank holds a block of rows and the
matching y-side vectors (y, ỹ, d, f's parameters); the x side is whole on
every rank.

  * ``A @ x``   → local product, no communication
  * ``Aᵀ @ y``  → local product + one ``all_reduce`` of length n
  * Gram AᵀA   → ``all_reduce`` of the local AᵢᵀAᵢ, once at init

Column plan (``shard_matrix_cols``, wide A): each rank holds a block of
columns and the matching x-side vectors; the costs invert (``A @ x`` is one
``all_reduce`` of length m, ``Aᵀ @ y`` is local, the m×m Gram is reduced).
``auto_shard`` picks rows when m ≥ n, so the reduced vector is always the
short side.  A mismatched plan (a tall A on columns) gives the same solve:
its Gram gathers A once.

The solvers sum partial sums on the sharded side through one hook,
:meth:`ShardedMatrix.reduce`, which takes a stacked vector of them: one
``all_reduce`` for all the norms and dots of one point of the loop.

Only ``all_reduce`` and ``broadcast`` are used: they are the collectives the
``gloo`` backend takes on CUDA tensors, so two ranks may share one GPU.  A
group that rejects a tensor raises; nothing is copied to the host in its
place.  :data:`stats` counts every collective, by kind and bytes.
"""

from __future__ import annotations

import datetime
import logging
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from pogs_tpu_torch.linalg.matrix import DenseMatrix, split_bounds

# The default timeout of a process group: a rank that diverges raises in
# the others instead of hanging them.
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)

# Collectives made by this module, by kind: "vector" (products, gathers,
# the Gram), "small" (the stacked partial sums of ``reduce``) and
# "broadcast", each with its bytes.
stats: Dict[str, int] = {}


def reset_stats():
    stats.clear()
    stats.update({"vector": 0, "vector_bytes": 0, "small": 0, "small_bytes": 0,
                  "broadcast": 0, "broadcast_bytes": 0})


reset_stats()


def all_reduce(t: torch.Tensor, group, kind: str = "vector") -> torch.Tensor:
    """Sum ``t`` in place across ``group``; counted in :data:`stats` under
    ``kind``.  Returns ``t``."""
    stats[kind] += 1
    stats[kind + "_bytes"] += t.numel() * t.element_size()
    dist.all_reduce(t, group=group)
    return t


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Broadcast ``t`` in place from global rank ``src``; counted."""
    stats["broadcast"] += 1
    stats["broadcast_bytes"] += t.numel() * t.element_size()
    dist.broadcast(t, src=src, group=group)
    return t


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None,
                     store=None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> int:
    """Initialize the default process group (idempotent); returns the world
    size.  With no address, store or ``WORLD_SIZE`` in the environment it is
    a no-op for one process.  ``init_method`` is a URL (``env://`` as set by
    torchrun, ``tcp://host:port``, ``file://path``) or ``store`` a
    ``torch.distributed`` store; ``backend`` defaults to NCCL where CUDA is
    available, else gloo.

    Re-initialization is tolerated, but a genuine failure (an unreachable
    address, mismatched world sizes, a timeout) RAISES after logging: a
    solve that silently ran on one process, where the caller asked for a
    group, would place its shards wrongly.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    if init_method is None and store is None and world_size is None \
            and "WORLD_SIZE" not in os.environ:
        return 1
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    try:
        kw = {"store": store} if store is not None else {
            "init_method": init_method or "env://"}
        dist.init_process_group(backend, world_size=-1 if world_size is None else world_size,
                                rank=-1 if rank is None else rank, timeout=timeout, **kw)
    except (RuntimeError, ValueError) as exc:
        if "already" in str(exc).lower():
            pass  # idempotent re-init
        else:
            logging.getLogger(__name__).error(
                "torch.distributed.init_process_group failed (init_method=%s, "
                "world_size=%s, rank=%s, backend=%s): %s",
                init_method, world_size, rank, backend, exc)
            raise
    return dist.get_world_size() if dist.is_initialized() else 1


class Mesh:
    """A grid of the group's ranks with named axes, one process group per
    axis line (the ranks that differ only in that axis' coordinate).

    Ranks are laid out row-major: on a ``(2, 2)`` ``('batch', 'rows')`` mesh
    rank 3 sits at batch 1, rows 1.  ``shape`` maps each axis to its size,
    as a JAX mesh's does; ``device`` is where this rank's tensors live.
    """

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 device: torch.device, timeout: datetime.timedelta = DEFAULT_TIMEOUT):
        world = dist.get_world_size()
        if int(np.prod(shape)) != world:
            raise ValueError(f"a mesh of shape {shape} needs {int(np.prod(shape))} "
                             f"ranks, the group has {world}")
        if len(shape) != len(axis_names):
            raise ValueError("one axis name per mesh dimension")
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = tuple(axis_names)
        self.device = device
        self.rank = dist.get_rank()
        grid = np.arange(world).reshape(shape)
        self.coords = dict(zip(axis_names, (int(i) for i in np.unravel_index(self.rank, shape))))
        self._groups = {}
        # Every rank creates every group, in the same order (new_group's
        # contract); each keeps the one on its own line of each axis.
        for ax, name in enumerate(axis_names):
            lines = np.moveaxis(grid, ax, -1).reshape(-1, shape[ax])
            for line in lines:
                group = dist.new_group([int(r) for r in line], timeout=timeout)
                if self.rank in line:
                    self._groups[name] = group

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.coords[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def check_axis(self, axis: str):
        if axis not in self.shape:
            raise ValueError(f"mesh axes are {self.axis_names}, not {axis!r}")


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        return torch.device("cuda")  # raises at first use, as every entry point
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def make_mesh(shape: Union[int, Tuple[int, ...], None] = None,
              axis_names: Sequence[str] = ("rows",), device=None,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """A mesh over the initialized group: 1-D ``('rows',)`` over every rank
    by default, or e.g. ``make_mesh((2, 2), ('batch', 'rows'))``.  ``device``
    defaults to CUDA device (rank mod the visible count); pass ``"cpu"`` for
    a CPU group.  Each axis' groups time out after ``timeout``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(init_distributed)")
    if shape is None:
        shape = (dist.get_world_size(),)
    elif isinstance(shape, int):
        shape = (shape,)
    dev = _default_device() if device is None else torch.device(device)
    return Mesh(tuple(int(s) for s in shape), tuple(axis_names), dev, timeout)


def _solve_dtype(A, dtype):
    if dtype is not None:
        return dtype
    src = A.dtype if hasattr(A, "dtype") else np.asarray(A).dtype
    return torch.float64 if src in (torch.float64, np.float64) else torch.float32


def _whole(A, dtype, device) -> torch.Tensor:
    A_t = A if isinstance(A, torch.Tensor) else torch.as_tensor(np.asarray(A))
    return A_t.to(device=device, dtype=dtype)


class ShardedMatrix:
    """One rank's block of A sharded over a mesh axis by rows
    (``plan="rows"``) or columns (``plan="cols"``); the block is a
    single-device operator, a ``DenseMatrix`` or (rows only,
    ``parallel/sparse.py``) a ``SparseMatrix``.

    Keeps the block's contract (``mv``, ``rmv``, ``sq_mv``, ``sq_rmv``,
    ``scale``, ``scalar_mul``, ``frob2``, ``dense``) with the collectives of
    the module note.  ``shape`` is the whole A's; ``local_shape`` the
    lengths of the x- and y-side vectors this rank holds.  ``sharded_side``
    is ``"m"`` (rows) or ``"n"`` (columns): the side whose vectors are
    split.  ``reduce`` sums a stacked vector of partial sums on that side;
    ``gather`` makes a split vector whole and ``local`` takes this rank's
    part of a whole one.
    """

    def __init__(self, block, plan: str, shape, mesh: Mesh, axis: str):
        if plan not in ("rows", "cols"):
            raise ValueError(f"unknown plan {plan!r}")
        self.block = block
        self.plan = plan
        self.shape = tuple(shape)
        self.mesh = mesh
        self.axis = axis
        self.group = mesh.group(axis)
        self.lo, self.hi = split_bounds(self._split_total, mesh.size(axis), mesh.index(axis))

    # -- layout -------------------------------------------------------------

    @property
    def _split_total(self) -> int:
        return self.shape[0] if self.plan == "rows" else self.shape[1]

    @property
    def sharded_side(self) -> str:
        return "m" if self.plan == "rows" else "n"

    @property
    def is_sparse(self) -> bool:
        return self.block.is_sparse

    @property
    def local_shape(self):
        return tuple(self.block.shape)

    @property
    def dtype(self):
        return self.block.dtype

    @property
    def device(self):
        return self.block.device

    def _like(self, block) -> "ShardedMatrix":
        return type(self)(block, self.plan, self.shape, self.mesh, self.axis)

    def reduce(self, partials: torch.Tensor) -> torch.Tensor:
        """The sum across the axis of a stacked vector of partial sums."""
        return all_reduce(partials.clone(), self.group, "small")

    def gather(self, v: torch.Tensor) -> torch.Tensor:
        """A vector of the sharded side, whole on every rank (one all_reduce
        of a zero-padded buffer)."""
        buf = torch.zeros((self._split_total,) + tuple(v.shape[1:]), dtype=v.dtype,
                          device=v.device)
        buf[self.lo:self.hi] = v
        return all_reduce(buf, self.group)

    def local(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole vector of the sharded side."""
        return v[self.lo:self.hi]

    # -- products -----------------------------------------------------------
    # The row plan reduces what lands on the x side (Aᵀ·), the column plan
    # what lands on the y side (A·).

    def _x_side(self, out):
        return all_reduce(out, self.group) if self.plan == "rows" else out

    def _y_side(self, out):
        return out if self.plan == "rows" else all_reduce(out, self.group)

    def mv(self, x):
        return self._y_side(self.block.mv(x))

    def rmv(self, y):
        return self._x_side(self.block.rmv(y))

    def rmv_and(self, y, partials):
        """(Aᵀ y, the sum of ``partials``) on the row plan: one all_reduce
        carries both, the stacked partial sums of the y side riding with the
        product's."""
        n = self.shape[1]
        buf = all_reduce(torch.cat([self.block.rmv(y), partials]), self.group)
        return buf[:n], buf[n:]

    def sq_mv(self, v):
        return self._y_side(self.block.sq_mv(v))

    def sq_rmv(self, v):
        return self._x_side(self.block.sq_rmv(v))

    def scale(self, d, e) -> "ShardedMatrix":
        """diag(d)·A·diag(e), with d and e this rank's parts."""
        return self._like(self.block.scale(d, e))

    def scalar_mul(self, s) -> "ShardedMatrix":
        return self._like(self.block.scalar_mul(s))

    def frob2(self):
        return self.reduce(self.block.frob2()[None])[0]

    def dense(self) -> torch.Tensor:
        """The whole A on every rank (one all_reduce of m·n elements); a
        sparse block raises, as ``SparseMatrix.dense`` does."""
        B = self.block.dense()
        buf = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        if self.plan == "rows":
            buf[self.lo:self.hi] = B
        else:
            buf[:, self.lo:self.hi] = B
        return all_reduce(buf, self.group)

    def gram(self, side: str) -> torch.Tensor:
        """AᵀA (``side="n"``) or AAᵀ (``side="m"``), whole on every rank: the
        reduced local Gram where the plan splits the contracted dimension,
        else from A gathered once (a mismatched plan)."""
        if side == "n" and self.plan == "rows":
            B = self.block.dense()
            return all_reduce(B.T @ B, self.group)
        if side == "m" and self.plan == "cols":
            B = self.block.dense()
            return all_reduce(B @ B.T, self.group)
        A = self.dense()
        return A.T @ A if side == "n" else A @ A.T

    def gather_op(self):
        """The whole A as a single-device ``DenseMatrix`` (the polish)."""
        return DenseMatrix(self.dense())


def shard_matrix(A, mesh: Mesh, axis: str = "rows", dtype=None) -> ShardedMatrix:
    """This rank's block of rows of A (a whole array or tensor, the same on
    every rank) on ``mesh.device``: the row plan."""
    mesh.check_axis(axis)
    dt = _solve_dtype(A, dtype)
    m = A.shape[0]
    lo, hi = split_bounds(m, mesh.size(axis), mesh.index(axis))
    block = _whole(A[lo:hi], dt, mesh.device).contiguous()
    return ShardedMatrix(DenseMatrix(block), "rows", A.shape, mesh, axis)


def shard_matrix_cols(A, mesh: Mesh, axis: str = "rows", dtype=None) -> ShardedMatrix:
    """This rank's block of columns of A: the column plan (wide A); x-side
    vectors split with the columns, y-side vectors are whole."""
    mesh.check_axis(axis)
    dt = _solve_dtype(A, dtype)
    n = A.shape[1]
    lo, hi = split_bounds(n, mesh.size(axis), mesh.index(axis))
    block = _whole(A[:, lo:hi], dt, mesh.device).contiguous()
    return ShardedMatrix(DenseMatrix(block), "cols", A.shape, mesh, axis)


def auto_shard(A, mesh: Mesh, axis: str = "rows", dtype=None) -> ShardedMatrix:
    """Rows when A is tall (m ≥ n), columns when wide: the vector reduced in
    the hot product pair is then the short side."""
    m, n = A.shape
    fn = shard_matrix if m >= n else shard_matrix_cols
    return fn(A, mesh, axis, dtype)


def shard_like(A, like: ShardedMatrix, dtype=None) -> ShardedMatrix:
    """A dense matrix (the same on every rank) sharded as ``like`` is: its
    plan, mesh and axis, and its dtype unless ``dtype`` is given (a QP's
    epigraph extension takes its caller's layout)."""
    shard = shard_matrix if like.plan == "rows" else shard_matrix_cols
    return shard(A, like.mesh, like.axis, like.dtype if dtype is None else dtype)


def replicate(x, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """x whole on every rank of the mesh, on ``mesh.device``: rank ``src``'s
    copy is broadcast, so every rank holds the same bits."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    t = t.to(mesh.device).contiguous().clone()
    return broadcast(t, src)


@dataclass(frozen=True)
class Sharding:
    """Where one tensor dimension splits over a mesh axis (``spec`` as a
    JAX PartitionSpec reads: ``("rows", None)`` splits dimension 0)."""

    mesh: Mesh
    axis: str
    dim: int

    @property
    def spec(self):
        return tuple(self.axis if d == self.dim else None for d in range(self.dim + 1))

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole tensor."""
        lo, hi = split_bounds(t.shape[self.dim], self.mesh.size(self.axis),
                              self.mesh.index(self.axis))
        return t.narrow(self.dim, lo, hi - lo)


def row_sharding(mesh: Mesh, axis: str = "rows") -> Sharding:
    return Sharding(mesh, axis, 0)


def col_sharding(mesh: Mesh, axis: str = "rows") -> Sharding:
    return Sharding(mesh, axis, 1)


def pad_rows_to(A, b, multiple: int):
    """Zero-pad rows of (A, b) to a multiple (so row shards are equal).

    Zero rows are inert for graph-form objectives built with f_i = ZERO on
    the padding (a zero row contributes y_i = 0 and f_i(0) = 0).
    Returns (A_pad, b_pad, m_orig).
    """
    m = A.shape[0]
    m_pad = (-m) % multiple
    if m_pad == 0:
        return A, b, m
    A_pad = np.zeros((m + m_pad, A.shape[1]), dtype=np.asarray(A).dtype)
    A_pad[:m] = np.asarray(A)
    b_pad = np.zeros((m + m_pad,), dtype=np.asarray(b).dtype)
    b_pad[:m] = np.asarray(b)
    return A_pad, b_pad, m
