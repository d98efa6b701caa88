"""Checkpoint / resume of a GraphFormSolver's warm-start state.

Counterpart of ``pogs_tpu/utils/checkpoint.py``, with the same ``.npz``
layout: the ADMM iterate ``z`` and ``zt`` (each [x; y], length m + n), the
adapted ``rho``, a ``fingerprint`` of the problem matrix and its ``shape``.
A resume against another matrix is rejected instead of silently
warm-starting from the wrong point.

The dense fingerprint is the JAX package's: sha256 of ``str(shape)`` and of
the float32 bytes of the original (unequilibrated) A.  So a checkpoint of a
dense problem written by either package loads in the other.  The sparse
fingerprint hashes the port's CSR arrays (values as float32, row pointers
and column indices as int64), where the JAX package hashes its BCOO
buffers: a sparse checkpoint loads only in the package that wrote it.

A solver on a sharded A (``parallel/mesh.py``) writes what a single-device
solver of the whole A writes: z and zt gathered whole, the fingerprint of
A gathered (every rank computes the same one), and only rank 0 of A's axis
writes the file; the other ranks wait for it.  Loaded onto a sharded
solver, each rank takes its part.  So a checkpoint crosses between one
device and a mesh, in either direction and in either package.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Union

import numpy as np
import torch

from pogs_tpu_torch.linalg.matrix import is_sharded, local_shape, part, whole


def _host(t: torch.Tensor, dtype) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy().astype(dtype))


def _fingerprint(A) -> str:
    """sha256 of a solver's matrix operator (a DenseMatrix or SparseMatrix,
    or a sharded one gathered first), its first 16 hex digits."""
    if is_sharded(A):
        A = A.gather_op()
    h = hashlib.sha256()
    h.update(str(tuple(A.shape)).encode())
    if A.is_sparse:
        h.update(_host(A.values, np.float32).tobytes())
        h.update(_host(A.M.crow_indices(), np.int64).tobytes())
        h.update(_host(A.M.col_indices(), np.int64).tobytes())
    else:
        h.update(_host(A.dense(), np.float32).tobytes())
    return h.hexdigest()[:16]


def _whole_z(A, z):
    """A packed [x; y] of this rank's parts, whole."""
    n_loc = local_shape(A)[1]
    return torch.cat([whole(A, "n", z[:n_loc]), whole(A, "m", z[n_loc:])])


def _part_z(A, z):
    """This rank's parts of a whole packed [x; y]."""
    n = A.shape[1]
    return torch.cat([part(A, "n", z[:n]), part(A, "m", z[n:])])


def save_state(solver, path: Union[str, Path]) -> None:
    """Write a GraphFormSolver's warm-start state to ``path`` (.npz); on a
    sharded A every rank takes part and rank 0 of its axis writes."""
    if solver._z is None:
        raise ValueError("solver has no state to checkpoint (no solve yet)")
    A = solver.A
    z, zt = solver._z, solver._zt
    sharded = is_sharded(A)
    if sharded:
        z, zt = _whole_z(A, z), _whole_z(A, zt)
    fingerprint = _fingerprint(A)
    if not sharded or A.mesh.index(A.axis) == 0:
        np.savez(
            Path(path),
            z=z.detach().cpu().numpy(),
            zt=zt.detach().cpu().numpy(),
            rho=np.asarray(solver.rho),
            fingerprint=np.asarray(fingerprint),
            shape=np.asarray([solver.m, solver.n]),
        )
    if sharded:
        # No rank returns before the file is written (rank 0 joins this
        # all-reduce after writing).
        from pogs_tpu_torch.parallel.mesh import all_reduce
        all_reduce(torch.zeros(1, dtype=A.dtype, device=A.device), A.group, "small")


def load_state(solver, path: Union[str, Path], strict: bool = True):
    """Restore warm-start state saved by :func:`save_state` (by this
    package, or by the JAX package for a dense A) onto the solver's device
    and dtype; a sharded solver takes its parts.

    With ``strict`` (default) the checkpoint must match the solver's matrix
    fingerprint; set False to warm-start a *similar* problem (same shape).
    """
    data = np.load(Path(path), allow_pickle=False)
    m, n = (int(v) for v in data["shape"])
    if (m, n) != (solver.m, solver.n):
        raise ValueError(
            f"checkpoint shape {(m, n)} != solver shape {(solver.m, solver.n)}"
        )
    if strict and str(data["fingerprint"]) != _fingerprint(solver.A):
        raise ValueError(
            "checkpoint was created for a different matrix "
            "(pass strict=False to warm-start anyway)"
        )
    z = torch.as_tensor(data["z"]).to(device=solver.device, dtype=solver.dtype)
    zt = torch.as_tensor(data["zt"]).to(device=solver.device, dtype=solver.dtype)
    if is_sharded(solver.A):
        z, zt = _part_z(solver.A, z), _part_z(solver.A, zt)
    solver._z, solver._zt = z, zt
    solver.rho = float(data["rho"])
    return solver
