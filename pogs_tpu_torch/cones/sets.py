"""Cone sets: a fixed collection of cone constraints projected in a few
batched passes.

Counterpart of ``pogs_tpu/cones/sets.py``.  The constraint indices are static
numpy, so the separable cones (Zero, NonNeg, NonPos) become boolean masks —
one elementwise pass — and SOC / SDP / exponential constraints are grouped
by (type, size) into (K, L) index matrices, each projected as one batch
gathered and scattered with static indices.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from pogs_tpu_torch.types import Cone, ConeConstraint
from pogs_tpu_torch.cones.projections import (
    project_soc,
    project_sdp_packed,
    project_exp_primal,
    project_exp_dual,
)

_SEPARABLE = (Cone.ZERO, Cone.NON_NEG, Cone.NON_POS)


def is_separable(cone: Cone) -> bool:
    """Zero, NonNeg and NonPos act coordinate by coordinate."""
    return cone in _SEPARABLE


def dual_cone(cone: Cone) -> Cone:
    """Every supported cone is self-dual except the exponential pair."""
    if cone == Cone.EXP_PRIMAL:
        return Cone.EXP_DUAL
    if cone == Cone.EXP_DUAL:
        return Cone.EXP_PRIMAL
    return cone


def _sdp_order(L: int) -> int:
    return int((-1 + np.sqrt(1 + 8 * L)) / 2)


def validate_cones(constraints: Sequence[ConeConstraint], dim: int) -> None:
    """No index may repeat or leave [0, dim); SDP sizes are n(n+1)/2,
    exponential cones have 3 indices, an SOC at least 1."""
    seen = set()
    for con in constraints:
        for i in con.indices:
            if i in seen:
                raise ValueError(f"cone index {i} appears in multiple cones")
            if i < 0 or i >= dim:
                raise ValueError(f"cone index {i} out of range [0, {dim})")
            seen.add(i)
        if con.cone == Cone.SDP:
            L = len(con.indices)
            nmat = _sdp_order(L)
            if nmat * (nmat + 1) // 2 != L:
                raise ValueError(f"SDP cone size {L} is not n(n+1)/2")
        if con.cone in (Cone.EXP_PRIMAL, Cone.EXP_DUAL) and len(con.indices) != 3:
            raise ValueError("exponential cones have exactly 3 indices")
        if con.cone == Cone.SOC and len(con.indices) < 1:
            raise ValueError("SOC cone needs at least 1 index")


class ConeSet:
    """A fixed set of cone constraints over a dim-vector.

    ``project(v)`` projects v onto the product cone (identity on the
    coordinates in no cone, which are free).  Masks and index matrices are
    host numpy; they move to v's device on first use there.
    """

    def __init__(self, constraints: Sequence[ConeConstraint], dim: int,
                 validate: bool = True):
        constraints = [c if isinstance(c, ConeConstraint) else ConeConstraint(c.cone, c.indices)
                       for c in constraints]
        if validate:
            validate_cones(constraints, dim)
        self.constraints = list(constraints)
        self.dim = dim

        self._masks = {}
        for cone in _SEPARABLE:
            idx = [i for c in constraints if c.cone == cone for i in c.indices]
            if idx:
                mask = np.zeros(dim, bool)
                mask[np.asarray(idx)] = True
                self._masks[cone] = mask

        self._groups: List = []
        for cone in (Cone.SOC, Cone.SDP, Cone.EXP_PRIMAL, Cone.EXP_DUAL):
            by_size = {}
            for c in constraints:
                if c.cone == cone:
                    by_size.setdefault(len(c.indices), []).append(list(c.indices))
            for _, rows in sorted(by_size.items()):
                self._groups.append((cone, np.asarray(rows, np.int64)))
        self._on = {}

    def _device_tables(self, device):
        """(masks, groups) as tensors on ``device``, made once per device."""
        key = str(device)
        if key not in self._on:
            masks = {k: torch.as_tensor(v, device=device) for k, v in self._masks.items()}
            groups = [(cone, torch.as_tensor(idx, device=device)) for cone, idx in self._groups]
            self._on[key] = (masks, groups)
        return self._on[key]

    def __len__(self):
        return len(self.constraints)

    @property
    def is_separable_only(self) -> bool:
        """True when every constraint is Zero, NonNeg or NonPos."""
        return not self._groups

    def separable_masks(self):
        """(zero, nonneg, nonpos) boolean numpy masks over the dim-vector."""
        empty = np.zeros(self.dim, bool)
        return (self._masks.get(Cone.ZERO, empty),
                self._masks.get(Cone.NON_NEG, empty),
                self._masks.get(Cone.NON_POS, empty))

    @property
    def is_empty(self):
        return not self.constraints

    @property
    def has_sdp(self) -> bool:
        return any(c.cone == Cone.SDP for c in self.constraints)

    def project(self, v):
        """Π_K(v), one batched projection per (type, size) group."""
        masks, groups = self._device_tables(v.device)
        out = v
        if Cone.ZERO in masks:
            out = torch.where(masks[Cone.ZERO], torch.zeros_like(out), out)
        if Cone.NON_NEG in masks:
            out = torch.where(masks[Cone.NON_NEG], torch.clamp(out, min=0.0), out)
        if Cone.NON_POS in masks:
            out = torch.where(masks[Cone.NON_POS], torch.clamp(out, max=0.0), out)
        if groups:
            out = out.clone()
        for cone, idx in groups:
            vals = out[idx]
            if cone == Cone.SOC:
                proj = project_soc(vals)
            elif cone == Cone.SDP:
                # svec coordinates: the ConeSolver conjugates SDP rows into
                # the √2-weighted basis, where the clamp is Euclidean.
                proj = project_sdp_packed(vals, _sdp_order(idx.shape[1]), scaled=True)
            elif cone == Cone.EXP_PRIMAL:
                proj = project_exp_primal(vals)
            else:
                proj = project_exp_dual(vals)
            out[idx] = proj
        return out

    def dual(self) -> "ConeSet":
        """The dual cone set; Zero cones dualize to free and are dropped."""
        duals = [ConeConstraint(dual_cone(c.cone), c.indices)
                 for c in self.constraints if c.cone != Cone.ZERO]
        return ConeSet(duals, self.dim, validate=False)

    def constrain_average(self, w):
        """Average w within each non-separable cone — the equilibration hook
        that keeps the scaling uniform inside a cone that does not act
        coordinate by coordinate."""
        _, groups = self._device_tables(w.device)
        if groups:
            w = w.clone()
        for _, idx in groups:
            w[idx] = torch.mean(w[idx], dim=1, keepdim=True).expand(idx.shape)
        return w

    def distance(self, v):
        """‖v − Π_K(v)‖."""
        return torch.linalg.vector_norm(v - self.project(v))

    def svec_scale(self) -> np.ndarray:
        """Per-coordinate svec weights: √2 on the off-diagonal entries of SDP
        cones, 1 elsewhere."""
        scale = np.ones(self.dim)
        for con in self.constraints:
            if con.cone != Cone.SDP:
                continue
            nmat = _sdp_order(len(con.indices))
            k = 0
            for col in range(nmat):
                for row in range(col, nmat):
                    if row != col:
                        scale[con.indices[k]] = np.sqrt(2.0)
                    k += 1
        return scale
