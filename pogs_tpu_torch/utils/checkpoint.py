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
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Union

import numpy as np
import torch


def _host(t: torch.Tensor, dtype) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy().astype(dtype))


def _fingerprint(A) -> str:
    """sha256 of a solver's matrix operator (a DenseMatrix or SparseMatrix),
    its first 16 hex digits."""
    h = hashlib.sha256()
    h.update(str(tuple(A.shape)).encode())
    if A.is_sparse:
        h.update(_host(A.values, np.float32).tobytes())
        h.update(_host(A.M.crow_indices(), np.int64).tobytes())
        h.update(_host(A.M.col_indices(), np.int64).tobytes())
    else:
        h.update(_host(A.dense(), np.float32).tobytes())
    return h.hexdigest()[:16]


def save_state(solver, path: Union[str, Path]) -> None:
    """Write a GraphFormSolver's warm-start state to ``path`` (.npz)."""
    if solver._z is None:
        raise ValueError("solver has no state to checkpoint (no solve yet)")
    np.savez(
        Path(path),
        z=solver._z.detach().cpu().numpy(),
        zt=solver._zt.detach().cpu().numpy(),
        rho=np.asarray(solver.rho),
        fingerprint=np.asarray(_fingerprint(solver.A)),
        shape=np.asarray([solver.m, solver.n]),
    )


def load_state(solver, path: Union[str, Path], strict: bool = True):
    """Restore warm-start state saved by :func:`save_state` (by this
    package, or by the JAX package for a dense A) onto the solver's device
    and dtype.

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
    solver._z = torch.as_tensor(data["z"]).to(device=solver.device, dtype=solver.dtype)
    solver._zt = torch.as_tensor(data["zt"]).to(device=solver.device, dtype=solver.dtype)
    solver.rho = float(data["rho"])
    return solver
