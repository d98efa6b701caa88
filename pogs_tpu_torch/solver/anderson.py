"""Anderson acceleration (type-II, Walker & Ni 2011) for fixed-point loops.

Counterpart of ``pogs_tpu/solver/anderson.py``.  The state is fixed-shape:
circular buffers of residual differences ΔF and map-output differences ΔG.
Each step solves the regularised mem×mem normal equations of the
least-squares problem min ‖f − ΔFᵀθ‖ for the mixing weights by Cholesky, as
the JAX package does (so the two agree to roundoff), with no host sync:
weights that are non-finite, larger than ``max_weight``, or from a failed
factorisation are rejected and the plain iterate is kept.  Callers reset
the state when the underlying map changes (a ρ rescale).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AndersonState(NamedTuple):
    dF: torch.Tensor      # (mem, dim) residual differences
    dG: torch.Tensor      # (mem, dim) map-output differences
    prev_f: torch.Tensor  # (dim,) last residual
    prev_g: torch.Tensor  # (dim,) last map output
    k: torch.Tensor       # iterations since (re)start, int32 scalar


def anderson_init(dim: int, mem: int, dtype, device=None) -> AndersonState:
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return AndersonState(dF=z(mem, dim), dG=z(mem, dim), prev_f=z(dim),
                         prev_g=z(dim),
                         k=torch.zeros((), dtype=torch.int32, device=device))


def anderson_reset(st: AndersonState) -> AndersonState:
    """The state with its history dropped (k = 0)."""
    return st._replace(k=torch.zeros_like(st.k))


def anderson_step(st: AndersonState, s_prev, s_new, reg: float = 1e-10,
                  max_weight: float = 20.0, split=None):
    """One step for the map output ``s_new = G(s_prev)``.

    Returns ``(s_acc, new_state)``.  ``s_acc`` equals ``s_new`` until at
    least one difference pair is stored; the caller decides when to use it.

    ``split = (mask, reduce)`` serves a state of which each rank holds a
    part (a sharded solve): the entries under ``mask`` are this rank's part
    of the split side, the others whole on every rank; the Gram and the
    right-hand side sum the split entries through one ``reduce``.
    """
    mem, _ = st.dF.shape
    dt, dev = s_new.dtype, s_new.device
    f = s_new - s_prev
    g = s_new

    # Store the differences in slot (k - 1) mod mem once a previous pair exists.
    cols = torch.arange(mem, device=dev)
    write = ((cols == (st.k - 1) % mem) & (st.k >= 1))[:, None]
    dF = torch.where(write, (f - st.prev_f)[None, :], st.dF)
    dG = torch.where(write, (g - st.prev_g)[None, :], st.dG)

    # The min(k, mem) most recent slots are valid; the rest of the system is
    # the identity, so the solve stays well-posed.
    m_k = torch.clamp(st.k, max=mem)
    valid = cols < m_k
    vf = valid.to(dt)
    dF_m = dF * vf[:, None]
    eye = torch.eye(mem, dtype=dt, device=dev)
    if split is None:
        gram = dF_m @ dF_m.T
        rhs = dF_m @ f
    else:
        mask, reduce = split
        dF_s, dF_w = dF_m[:, mask], dF_m[:, ~mask]
        part = reduce(torch.cat([(dF_s @ dF_s.T).reshape(-1), dF_s @ f[mask]]))
        gram = dF_w @ dF_w.T + part[:mem * mem].reshape(mem, mem)
        rhs = dF_w @ f[~mask] + part[mem * mem:]
    gram = gram + reg * eye
    gram = torch.where(valid[:, None] & valid[None, :], gram, eye)
    rhs = rhs * vf
    L, info = torch.linalg.cholesky_ex(gram)
    theta = torch.cholesky_solve(rhs[:, None], L)[:, 0] * vf

    ok = (torch.all(torch.isfinite(theta)) & (torch.max(torch.abs(theta)) <= max_weight)
          & (m_k > 0) & (info == 0))
    s_acc = torch.where(ok, g - theta @ (dG * vf[:, None]), g)
    return s_acc, AndersonState(dF=dF, dG=dG, prev_f=f, prev_g=g, k=st.k + 1)
