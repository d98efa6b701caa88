"""State carried across from the JAX package.

The tests export the JAX package's init state (the equilibrated A, the
scalings d and e, ‖A‖₂ and the projector factor) as numpy arrays, and
:func:`init_state_from_numpy` turns them into this package's init state, so
that both packages iterate from bit-identical scaled data.  The graph-form
and the cone-form init states have the same keys (for the cone form, A is
equilibrated with the cone hooks and ``factor["op"]`` is the Gram inverse
the SMW solve uses), and both solvers take them through
``load_init_state``.  This module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def init_state_from_numpy(d: dict, device=None) -> dict:
    """Keys ``A``, ``d``, ``e``, ``norm_A`` and ``factor`` (a dict with
    ``op`` and optionally ``s``), as numpy arrays, to tensors of A's dtype
    on ``device`` (CUDA by default, as every entry point)."""
    from pogs_tpu_torch.solver.graph import resolve_device  # graph imports utils

    A = np.array(d["A"])
    dt = torch.from_numpy(A).dtype
    device = resolve_device(A, device)

    def t(v):
        return torch.as_tensor(np.array(v), dtype=dt, device=device)

    factor = d["factor"]
    return {
        "A": t(A),
        "d": t(d["d"]),
        "e": t(d["e"]),
        "norm_A": t(d["norm_A"]).reshape(()),
        "factor": {"op": t(factor["op"]), "s": t(factor.get("s", 1.0)).reshape(())},
    }
