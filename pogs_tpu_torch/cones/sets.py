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
from pogs_tpu_torch.linalg.matrix import split_bounds

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


class ShardedConeSet:
    """A :class:`ConeSet` over a vector split across ranks, as a sharded
    operator splits its vectors (``parallel/mesh.py``): K_y with the rows of
    the row plan, K_x with the columns of the column plan.  This rank holds
    the entries [A.lo, A.hi).

    Separable cones and the cones that lie inside this rank's block project
    locally.  A cone that spans blocks is known to every rank (the
    structure is whole everywhere), so every rank takes part in one stacked
    ``reduce`` per projection: each SOC segment's head and tail sum of
    squares, and the entries of each exponential or PSD segment, which are
    then projected whole; each rank keeps its own entries.  The global
    structure (masks, sizes, the polish's plan) is ``whole``'s.
    """

    def __init__(self, whole: ConeSet, A):
        self.whole = whole
        self.A = A
        lo, hi = A.lo, A.hi
        self.dim = hi - lo
        R = A.mesh.size(A.axis)
        bounds = np.asarray([split_bounds(whole.dim, R, k)[0] for k in range(R + 1)])
        local, soc, gathered = [], [], []
        for c in whole.constraints:
            idx = np.asarray(c.indices, np.int64)
            mine = (idx >= lo) & (idx < hi)
            if is_separable(c.cone):
                if mine.any():
                    local.append(ConeConstraint(c.cone, idx[mine] - lo))
            elif len(np.unique(np.searchsorted(bounds, idx, side="right"))) == 1:
                if mine.all():
                    local.append(ConeConstraint(c.cone, idx - lo))
            elif c.cone == Cone.SOC:
                soc.append(idx)
            else:
                gathered.append(c)
        self.local = ConeSet(local, self.dim, validate=False)
        self._soc = soc
        self._gathered = gathered
        # The gathered cones over a buffer of their entries, in order.
        g_idx = [i for c in gathered for i in c.indices]
        self._g_idx = np.asarray(g_idx, np.int64)
        pos, k = [], 0
        for c in gathered:
            pos.append(ConeConstraint(c.cone, range(k, k + len(c.indices))))
            k += len(c.indices)
        self._g_set = ConeSet(pos, k, validate=False) if gathered else None
        self._tables = {}

    @property
    def spans_shards(self) -> bool:
        """Whether a projection makes a collective."""
        return bool(self._soc or self._gathered)

    def _device(self, device):
        """Per SOC segment: the local positions of its head and tail entries
        (``seg`` the segment of each tail entry); the gathered entries held
        here, by local position and buffer position."""
        key = str(device)
        if key not in self._tables:
            lo, hi = self.A.lo, self.A.hi
            heads_loc, heads_seg, tail_loc, tail_seg = [], [], [], []
            for j, idx in enumerate(self._soc):
                if lo <= idx[0] < hi:
                    heads_loc.append(idx[0] - lo)
                    heads_seg.append(j)
                for i in idx[1:]:
                    if lo <= i < hi:
                        tail_loc.append(i - lo)
                        tail_seg.append(j)
            g_mine = (self._g_idx >= lo) & (self._g_idx < hi)

            def t(v):
                return torch.as_tensor(np.asarray(v, np.int64), device=device)

            self._tables[key] = (t(heads_loc), t(heads_seg), t(tail_loc), t(tail_seg),
                                 t(self._g_idx[g_mine] - lo), t(np.flatnonzero(g_mine)))
        return self._tables[key]

    def project(self, v):
        out = self.local.project(v)
        if not self.spans_shards:
            return out
        h_loc, h_seg, t_loc, t_seg, g_loc, g_pos = self._device(v.device)
        J = len(self._soc)
        G = len(self._g_idx)
        buf = torch.zeros(2 * J + G, dtype=v.dtype, device=v.device)
        buf[h_seg] = v[h_loc]
        buf[J:2 * J] = buf[J:2 * J].index_add(0, t_seg, v[t_loc] * v[t_loc])
        buf[2 * J + g_pos] = v[g_loc]
        buf = self.A.reduce(buf)
        out = out.clone()
        if J:
            # project_soc's closed form on (head, ‖tail‖) of each segment.
            p, nrm = buf[:J], torch.sqrt(buf[J:2 * J])
            tiny = torch.finfo(v.dtype).tiny
            scale = 0.5 * (1.0 + p / torch.clamp(nrm, min=tiny))
            general = nrm >= torch.abs(p)
            polar = nrm <= -p
            head = torch.where(polar, torch.zeros_like(p),
                               torch.where(general, scale * nrm, p))
            tail_scale = torch.where(polar, torch.zeros_like(p),
                                     torch.where(general, scale, torch.ones_like(p)))
            out[h_loc] = head[h_seg]
            out[t_loc] = v[t_loc] * tail_scale[t_seg]
        if G:
            proj = self._g_set.project(buf[2 * J:])
            out[g_loc] = proj[g_pos]
        return out

    def dual(self) -> "ShardedConeSet":
        return ShardedConeSet(self.whole.dual(), self.A)

    def constrain_average(self, w):
        """Average w within each non-separable cone; a cone that spans
        blocks sums its entries through one ``reduce``."""
        w = self.local.constrain_average(w)
        spans = self._soc + [np.asarray(c.indices, np.int64) for c in self._gathered]
        if not spans:
            return w
        lo, hi = self.A.lo, self.A.hi
        loc, seg = [], []
        for j, idx in enumerate(spans):
            for i in idx:
                if lo <= i < hi:
                    loc.append(i - lo)
                    seg.append(j)
        loc = torch.as_tensor(np.asarray(loc, np.int64), device=w.device)
        seg = torch.as_tensor(np.asarray(seg, np.int64), device=w.device)
        sums = torch.zeros(len(spans), dtype=w.dtype, device=w.device).index_add(0, seg, w[loc])
        sums = self.A.reduce(sums)
        sizes = torch.as_tensor([float(len(s)) for s in spans], dtype=w.dtype, device=w.device)
        w = w.clone()
        w[loc] = (sums / sizes)[seg]
        return w


def shard_cones(cones, A, side: str = "m"):
    """``cones`` over one side of A (``"m"``: K_y, ``"n"``: K_x): a
    :class:`ShardedConeSet` where a sharded A splits that side, else
    ``cones`` itself."""
    if getattr(A, "sharded_side", None) != side or isinstance(cones, ShardedConeSet):
        return cones
    return ShardedConeSet(cones, A)
