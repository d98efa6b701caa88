"""Active-set KKT polish for box/polyhedral QPs.

A copy of ``pogs_tpu/solver/qp_polish.py`` (numpy and scipy only; its one
package import is this package's ``types.Cone``), kept here so that the
port imports nothing of the JAX package.

After the conic (epigraph-SOC HSDE) solve returns a moderate-accuracy
iterate for

    min ½xᵀPx + cᵀx   s.t.   b − Ax ∈ K_y,

with K_y a product of Zero/NonNeg/NonPos segments, detect the active rows
and solve the equality-constrained KKT system on them directly:

    [ P      A_actᵀ ] [x]   [ −c    ]
    [ A_act    0    ] [λ] = [ b_act ]

using static regularization ±δ plus iterative refinement against the
unregularized system (the OSQP "solution polishing" scheme).  The polished
point is accepted only if its worst KKT residual improves on the ADMM
iterate's AND meets tolerance; otherwise the original iterate is returned
untouched, so polish can never make a result worse.

The reference has no QP polish at all — its QP path stops at ADMM accuracy
and merely warns about the HSDE/QP mismatch (reference src/cpu/pogs.cpp:
1935-1944, python/pogs_cvxpy.py:160-173).  On ill-conditioned QPs
(cond(P) ~ 1e18, e.g. the Maros–Mészáros CVXQP family) ADMM alone stalls
at ~1e-4 relative accuracy; one direct KKT solve on the identified active
set recovers ~1e-10.

Everything here is host-side float64 numpy: polish is a one-shot direct
solve outside the solve loop, and must not depend on the solver dtype.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pogs_tpu_torch.types import Cone

# Static KKT regularization and refinement count (OSQP uses delta=1e-6 with
# ~3 refinement steps; the smaller delta is fine at f64 with refinement).
_DELTA = 1e-9
_REFINE_STEPS = 4
# Largest dense KKT system we will factor (n + #active rows).
_MAX_KKT_DIM = 6000


def row_kinds(m: int, cones) -> Optional[np.ndarray]:
    """Classify each of the m rows: 0 = equality (Zero cone), +1 = NonNeg
    slack (b−Ax ≥ 0, dual λ ≥ 0), −1 = NonPos slack (dual λ ≤ 0).

    Returns None when any row belongs to a non-polyhedral cone (SOC/SDP/
    EXP) — active-set polish only applies to linear cones."""
    kind = np.full(m, 2, np.int8)  # 2 = unassigned
    for cc in cones:
        if cc.cone == Cone.ZERO:
            k = 0
        elif cc.cone == Cone.NON_NEG:
            k = 1
        elif cc.cone == Cone.NON_POS:
            k = -1
        else:
            return None
        kind[np.asarray(cc.indices, np.intp)] = k
    if np.any(kind == 2):  # rows outside every cone: treated as free (no
        return None        # constraint) by the solver; polish stays out.
    return kind


def _pmv(P, x):
    """P @ x for dense (n, n) or diagonal 1-D P."""
    return P * x if P.ndim == 1 else P @ x


def kkt_residuals(P, c, A, b, kind, x, lam):
    """Relative inf-norm KKT residuals of (x, λ) for the row classes above.

    stationarity  Px + c + Aᵀλ = 0
    primal        eq: b−Ax = 0;  NonNeg: b−Ax ≥ 0;  NonPos: b−Ax ≤ 0
    dual sign     NonNeg: λ ≥ 0;  NonPos: λ ≤ 0
    complementarity  λᵢ·(b−Ax)ᵢ = 0 on inequality rows

    ``P`` may be the dense (n, n) Hessian or its 1-D diagonal; ``A`` may
    be dense or scipy sparse.
    """
    s = b - A @ x
    Px = _pmv(P, x)
    Atl = A.T @ lam if lam.size else np.zeros_like(x)
    r_stat = np.max(np.abs(Px + c + Atl)) / (
        1.0 + max(np.max(np.abs(Px), initial=0.0),
                  np.max(np.abs(c), initial=0.0),
                  np.max(np.abs(Atl), initial=0.0)))
    viol = np.where(kind == 0, np.abs(s), np.maximum(-kind * s, 0.0))
    r_pri = np.max(viol, initial=0.0) / (1.0 + np.max(np.abs(b), initial=0.0))
    sign_viol = np.where(kind == 0, 0.0, np.maximum(-kind * lam, 0.0))
    r_sign = np.max(sign_viol, initial=0.0) / (
        1.0 + np.max(np.abs(lam), initial=0.0))
    comp = np.where(kind == 0, 0.0, np.abs(lam * s))
    r_comp = np.max(comp, initial=0.0) / (
        1.0 + np.max(np.abs(lam), initial=0.0)
        * np.max(np.abs(s), initial=0.0))
    return {"stat": float(r_stat), "pri": float(r_pri),
            "sign": float(r_sign), "comp": float(r_comp)}


def _solve_kkt_reduced(P, A_act, c, b_act):
    """KKT solve with bound-row elimination.

    Active rows with a single nonzero (box/bound constraints — the bulk
    of the active set on Maros–Mészáros-class QPs) FIX their variable, so
    the dense KKT factorization only needs the free variables plus the
    general rows: on CVXQP1_M this shrinks the LU from dim ~3000 to
    ~1300, cutting each PDAS iteration ~10x.  Falls back to the full
    solve when there are no bound rows.  Returns (x, lam_act) with
    lam_act in the original active-row order, or None.

    ``P`` may be dense (n, n) or a 1-D diagonal; ``A_act`` may be dense
    or scipy sparse.  With a diagonal P the free block solves
    elementwise and the general rows reduce to a k_gen x k_gen Schur
    complement, so no O(n^2) object is ever formed — the path that
    makes the polish usable at n ~ 10^5.
    """
    diag_p = P.ndim == 1
    n = P.shape[0]
    k = A_act.shape[0]
    is_sp = hasattr(A_act, "tocsr")
    if is_sp:
        A_csr = A_act.tocsr()
        nnz = np.diff(A_csr.indptr)
    else:
        nnz = np.count_nonzero(A_act, axis=1)
    bound_rows = np.flatnonzero(nnz == 1)
    if bound_rows.size == 0 and not diag_p:
        A_d = A_csr.toarray() if is_sp else np.asarray(A_act, np.float64)
        return _solve_kkt(P, A_d, c, b_act)
    # First bound row per variable fixes it; duplicates (both bounds of
    # one variable detected active) stay general so inconsistency shows
    # up as a residual and gets rejected rather than silently dropped.
    seen = set()
    general = list(np.flatnonzero(nnz != 1))
    x_fix = np.zeros(n)
    fixed_mask = np.zeros(n, bool)
    keeper_of = {}
    coef_of = {}
    for i in bound_rows:
        if is_sp:
            ptr = A_csr.indptr[i]
            j = int(A_csr.indices[ptr])
            a_ij = float(A_csr.data[ptr])
        else:
            j = int(np.flatnonzero(A_act[i])[0])
            a_ij = float(A_act[i, j])
        if j in seen:
            general.append(i)
            continue
        seen.add(j)
        keeper_of[j] = i
        coef_of[j] = a_ij
        fixed_mask[j] = True
        x_fix[j] = b_act[i] / a_ij
    general = np.asarray(sorted(general), np.intp)
    free = np.flatnonzero(~fixed_mask)
    if general.size * n > 50_000_000:  # dense general block would not fit
        return None
    A_gen = A_act[general]
    if hasattr(A_gen, "toarray"):
        A_gen = A_gen.toarray()
    A_gen = np.asarray(A_gen, np.float64)
    A_gf = A_gen[:, free]
    # A general row whose support is entirely fixed variables (or a
    # duplicate bound) contributes a zero row to the reduced system —
    # keeping it would poison the factorization with a 0·x = rhs
    # constraint.  Drop it with λ = 0; if its residual actually matters,
    # the caller's acceptance test sees the primal violation and rejects.
    keep = np.abs(A_gf).sum(axis=1) > 0
    general = general[keep]
    A_gen = A_gen[keep]
    A_gf = A_gf[keep]
    fixed_idx = np.flatnonzero(fixed_mask)
    if diag_p:
        p_f = P[free]
        rhs_top = -c[free]  # no off-diagonal coupling to the fixed block
        rhs_bot = b_act[general] - A_gen[:, fixed_idx] @ x_fix[fixed_idx]
        sol = _solve_kkt_diag(p_f, A_gf, -rhs_top, rhs_bot)
    else:
        P_ff = P[np.ix_(free, free)]
        rhs_top = -(c[free] + P[np.ix_(free, fixed_idx)]
                    @ x_fix[fixed_idx])
        rhs_bot = b_act[general] - A_gen[:, fixed_idx] @ x_fix[fixed_idx]
        sol = _solve_kkt(P_ff, A_gf, -rhs_top, rhs_bot)
    if sol is None:
        return None
    x_f, lam_gen = sol
    x = x_fix.copy()
    x[free] = x_f
    # Bound duals from stationarity: r = Px + c + A_genᵀλ_gen must be
    # cancelled by a·λ_bound on each fixed coordinate.
    r = _pmv(P, x) + c + A_gen.T @ lam_gen
    lam_act = np.zeros(k)
    lam_act[general] = lam_gen
    for j, i in keeper_of.items():
        lam_act[i] = -r[j] / coef_of[j]
    return x, lam_act


def _solve_kkt_diag(p_f, A_gf, c, b_gen):
    """KKT solve for a DIAGONAL free-block Hessian:

        [ diag(p_f)  A_gfᵀ ] [x_f]   [ −c    ]
        [ A_gf        0    ] [ λ ] = [ b_gen ]

    Eliminate x_f = (−c − A_gfᵀλ)/p_f and solve the k_gen×k_gen Schur
    complement (A_gf diag(1/p_f) A_gfᵀ) λ = −(b_gen + A_gf(c/p_f)).
    Zero diagonal entries are δ-regularized; two refinement passes
    against the exact system keep the regularization out of the answer
    (a genuinely singular direction shows up as a residual and the
    caller's acceptance test rejects it)."""
    import scipy.linalg as sla

    k = A_gf.shape[0]
    p_reg = np.maximum(p_f, _DELTA)
    if k == 0:
        x_f = -c / p_reg
        if not np.all(np.isfinite(x_f)):
            return None
        return x_f, np.zeros(0)
    Ainv = A_gf / p_reg[None, :]
    M = Ainv @ A_gf.T
    M[np.diag_indices_from(M)] += _DELTA * (1.0 + np.diag(M))
    try:
        cf = sla.cho_factor(M)
    except Exception:
        try:
            lu = sla.lu_factor(M)
            cf = None
        except Exception:
            return None

    def schur_solve(rc, rb):
        # Solve the block system with rhs (−rc, rb).
        t = rb + Ainv @ rc
        lam = (sla.cho_solve(cf, -t) if cf is not None
               else sla.lu_solve(lu, -t))
        x_f = (-rc - A_gf.T @ lam) / p_reg
        return x_f, lam

    x_f, lam = schur_solve(c, b_gen)
    for _ in range(2):  # refinement vs the UNregularized diagonal
        res_top = p_f * x_f + A_gf.T @ lam + c
        res_bot = A_gf @ x_f - b_gen
        dx, dlam = schur_solve(res_top, -res_bot)
        x_f = x_f + dx
        lam = lam + dlam
    if not (np.all(np.isfinite(x_f)) and np.all(np.isfinite(lam))):
        return None
    return x_f, lam


def _solve_kkt(P, A_act, c, b_act):
    """Solve the regularized KKT system with iterative refinement.

    Regularize as [[P+δI, Aᵀ], [A, −δI]] (quasi-definite ⇒ always
    factorizable) and refine against the unregularized matrix."""
    n = P.shape[0]
    k = A_act.shape[0]
    dim = n + k
    K = np.zeros((dim, dim))
    K[:n, :n] = P
    K[:n, n:] = A_act.T
    K[n:, :n] = A_act
    K_reg = K.copy()
    K_reg[:n, :n] += _DELTA * np.eye(n)
    K_reg[n:, n:] -= _DELTA * np.eye(k)
    rhs = np.concatenate([-c, b_act])
    try:
        import scipy.linalg as sla

        lu = sla.lu_factor(K_reg)
        z = sla.lu_solve(lu, rhs)
        for _ in range(_REFINE_STEPS):
            z = z + sla.lu_solve(lu, rhs - K @ z)
    except Exception:
        return None
    if not np.all(np.isfinite(z)):
        return None
    return z[:n], z[n:]


_MAX_PDAS_ITER = 40


def _repair_duals(P, c, A, kind, x, act):
    """Sign-constrained least-squares dual on the active rows:
    min ‖Px + c + A_actᵀλ‖ with λ ≥ 0 (NonNeg rows) / λ ≤ 0 (NonPos),
    λ free on equalities, λ = 0 off the active set.

    Deletion-loop scheme (same as the native qp_polish.hpp): solve the
    UNCONSTRAINED least squares over the working set via regularized
    normal equations, drop wrong-signed inequality multipliers, repeat.
    Exact solves each pass — unlike a generic bounded-LS solver, the
    stationarity residual is never traded away for sign feasibility
    (scipy's lsq_linear at ~1e3 bounded variables stalls around 1e-3
    stationarity, which the acceptance test then correctly rejects)."""
    import scipy.linalg as sla

    g = _pmv(P, x) + c
    W = np.flatnonzero(act)
    if W.size == 0 or W.size * A.shape[1] > 50_000_000:
        return None  # dense working-set block would not fit
    A_W = A[W]
    if hasattr(A_W, "toarray"):
        A_W = A_W.toarray()
    A_W = np.asarray(A_W, np.float64)
    kk = kind[W]
    keep = np.ones(W.size, bool)
    lam_W = np.zeros(W.size)
    for _ in range(30):
        Ak = A_W[keep]
        M = Ak @ Ak.T
        M[np.diag_indices_from(M)] += 1e-10 * (1.0 + np.diag(M))
        try:
            cf = sla.cho_factor(M)
            sol = sla.cho_solve(cf, -(Ak @ g))
        except Exception:
            return None
        lam_W[:] = 0.0
        lam_W[keep] = sol
        bad = keep & (kk != 0) & (kk * lam_W < 0.0)
        if not bad.any():
            break
        keep &= ~bad
        if not keep.any():
            return None
    lam_W[(kk != 0) & (kk * lam_W < 0.0)] = 0.0  # clip residual violations
    lam = np.zeros(len(kind))
    lam[W] = lam_W
    return lam


def active_set_polish(P, c, A, b, kind, x, lam, tol,
                      max_pdas: int = _MAX_PDAS_ITER):
    """Primal-dual active-set (PDAS) polish seeded at the ADMM iterate.

    A single active-set guess from a stalled ADMM point is unreliable (the
    duals may be far from converged), so instead of one KKT solve we run
    the semismooth-Newton fixed point (Hintermüller–Ito–Kunisch):

        repeat:  solve the equality KKT system on the current guess W;
                 W ← equalities ∪ { i : kindᵢ·(λᵢ − sᵢ) > 0 }

    which for strictly convex QPs converges superlinearly, usually in a
    handful of iterations.  `kind·(λ−s) > 0` marks a row active when its
    dual pushes the right way or its slack is violated — the standard
    PDAS complementarity test written for our ±1/0 row classes.

    Acceptance is best-iterate: the polished point is returned only when
    its worst KKT residual beats the seed's AND stationarity/primal
    residuals meet `tol`; `None` otherwise (caller keeps the ADMM result).

    Returns dict(x, lam, res, n_active, score) or None.
    """
    P = np.asarray(P, np.float64)
    c = np.asarray(c, np.float64)
    b = np.asarray(b, np.float64)
    x = np.asarray(x, np.float64)
    lam = np.asarray(lam, np.float64)
    m, n = A.shape
    if not (np.all(np.isfinite(x)) and np.all(np.isfinite(lam))):
        return None
    base = kkt_residuals(P, c, A, b, kind, x, lam)
    base_score = max(base.values())
    s = b - A @ x
    s_scale = 1.0 + np.max(np.abs(b), initial=0.0)

    best = None
    seen = set()
    act = (kind == 0) | (kind * (lam - s) > 0)
    for _ in range(max_pdas):
        key = act.tobytes()
        if key in seen:  # cycle — PDAS can oscillate on degenerate sets
            break
        seen.add(key)
        k = int(np.count_nonzero(act))
        if P.ndim == 2 and n + k > _MAX_KKT_DIM:
            # Dense-P KKT would not fit; the diagonal path guards its own
            # (much smaller) reduced system instead.
            return best
        A_act = A[np.flatnonzero(act)]
        if not hasattr(A_act, "tocsr"):  # sparse stays sparse end to end
            A_act = np.asarray(A_act, np.float64)
        sol = _solve_kkt_reduced(P, A_act, c, b[act])
        if sol is None:
            break
        x_p, lam_act = sol
        lam_p = np.zeros(m)
        lam_p[act] = lam_act
        res = kkt_residuals(P, c, A, b, kind, x_p, lam_p)
        lam_cand, res_cand = lam_p, res
        if (res["sign"] > tol and res["stat"] <= tol and res["pri"] <= tol
                and res["comp"] <= tol):
            # Degenerate active sets have non-unique duals: the KKT LU
            # returns an arbitrary one, which can violate the sign
            # constraints even at the exact primal optimum (and PDAS then
            # oscillates between equally-optimal sets).  Repair for the
            # ACCEPTANCE CANDIDATE only — the sign-constrained
            # least-squares dual over the point's TIGHT rows.  Use the
            # slack-identified set, NOT the PDAS working set: the working
            # set may exclude tight rows (dropped for a wrong-signed LU
            # multiplier) that the sign-feasible dual needs.  The raw LU
            # duals keep driving the PDAS update (repaired duals would
            # change the trajectory, which empirically cycles early).
            s_here = b - A @ x_p
            act_r = (kind == 0) | ((kind != 0)
                                   & (np.abs(s_here) <= 1e-8 * s_scale))
            lam_r = _repair_duals(P, c, A, kind, x_p, act_r)
            if lam_r is not None:
                res_r = kkt_residuals(P, c, A, b, kind, x_p, lam_r)
                if max(res_r.values()) < max(res.values()):
                    lam_cand, res_cand = lam_r, res_r
        score = max(res_cand.values())
        # ALL four residuals must meet tolerance: a point with small
        # stationarity+feasibility but bad dual sign/complementarity
        # solves the KKT system of the WRONG active set (it is feasible
        # and stationary for an over-constrained subproblem, not the QP)
        # — accepting it would mislabel a suboptimal point as SUCCESS.
        if score < base_score and score <= tol:
            if best is None or score < best["score"]:
                best = {"x": x_p, "lam": lam_cand, "res": res_cand,
                        "n_active": k, "score": score}
        s_p = b - A @ x_p
        new_act = (kind == 0) | (kind * (lam_p - s_p) > 0)
        if np.array_equal(new_act, act):
            break
        act = new_act
    if best is not None:
        # Dual-sign cleanup: degenerate active sets can leave a few
        # wrong-signed inequality multipliers on the accepted iterate.
        # Zeroing them is valid whenever stationarity survives (they were
        # not load-bearing); keep whichever version scores better.
        lam_b = best["lam"]
        bad = (kind != 0) & (kind * lam_b < 0)
        if bad.any():
            lam2 = np.where(bad, 0.0, lam_b)
            res2 = kkt_residuals(P, c, A, b, kind, best["x"], lam2)
            if max(res2.values()) <= min(best["score"], tol):
                best = {"x": best["x"], "lam": lam2, "res": res2,
                        "n_active": best["n_active"],
                        "score": max(res2.values())}
    return best
