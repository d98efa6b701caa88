"""State carried across from the JAX package.

The tests export the JAX package's init state (the equilibrated A, the
scalings d and e, ‖A‖₂ and the projector factor) as numpy arrays, and
:func:`init_state_from_numpy` turns them into this package's init state, so
that both packages iterate from bit-identical scaled data.  The graph-form
and the cone-form init states have the same keys (for the cone form, A is
equilibrated with the cone hooks and ``factor["op"]`` is the Gram inverse
the SMW solve uses), and both solvers take them through
``load_init_state``.  A sparse A comes as its coordinates (the JAX
package's BCOO ``data`` and ``indices``, with its ``shape``) and becomes a
SparseMatrix: the CSR pair, the squared values made on first use.  This
module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from pogs_tpu_torch.linalg.matrix import SparseMatrix, _quiet


def init_state_from_numpy(d: dict, device=None) -> dict:
    """Keys ``A``, ``d``, ``e``, ``norm_A`` and ``factor`` (a dict with
    ``op`` and ``s``, or only ``s`` for the CGLS projector), as numpy arrays,
    to tensors of A's dtype on ``device`` (CUDA by default, as every entry
    point).  ``A`` is an array, or for a sparse A a dict with ``data``,
    ``indices`` (nnz × 2 row and column indices) and ``shape``."""
    from pogs_tpu_torch.solver.graph import resolve_device  # graph imports utils

    sparse = isinstance(d["A"], dict)
    A = np.array(d["A"]["data"] if sparse else d["A"])
    dt = torch.from_numpy(A).dtype
    device = resolve_device(A, device)

    def t(v):
        return torch.as_tensor(np.array(v), dtype=dt, device=device)

    if sparse:
        ij = torch.as_tensor(np.array(d["A"]["indices"]), dtype=torch.int64, device=device)
        # Coalesced: the coordinates in row-major order, duplicates summed.
        with _quiet():
            coo = torch.sparse_coo_tensor(ij.T, t(A), size=tuple(d["A"]["shape"]),
                                          check_invariants=False).coalesce()
        rows, cols = coo.indices()
        A_out = SparseMatrix.from_coo(rows, cols, coo.values(), tuple(coo.shape))
    else:
        A_out = t(A)
    factor = {key: t(v) for key, v in d["factor"].items()}
    factor["s"] = t(d["factor"].get("s", 1.0)).reshape(())
    return {
        "A": A_out,
        "d": t(d["d"]),
        "e": t(d["e"]),
        "norm_A": t(d["norm_A"]).reshape(()),
        "factor": factor,
    }
