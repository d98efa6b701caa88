"""Packaged quadratic-program API (OSQP-style signature).

Counterpart of ``pogs_tpu/api/qp.py``, with the same presolve, lowering,
closed forms and result contract; ``device=`` (default ``"cuda"``) and the
other ConeSolver options pass through as keyword arguments.

    solve_qp(P, q, G, h, A, b, lb, ub)   solves

        minimize    (1/2) x'Px + q'x
        subject to  G x <= h,   A x = b,   lb <= x <= ub

by lowering to the cone form ``b_bar - A_bar x in {0}^n_eq x R+^n_in``
and routing through :class:`~pogs_tpu_torch.solver.cone.ConeSolver`'s QP path
(epigraph rotated-SOC HSDE + PDAS active-set polish — the pipeline the
Maros–Mészáros-class suite certifies, ``benchmarks/maros_meszaros.py``).

The reference exposes QPs only through its cone interface and its own
QP-via-HSDE path is broken by its own admission
(src/cpu/pogs.cpp:1510-1514); this entry point is the user-facing QP
surface it never had.  Duals are split back into the user's blocks with
the convention  Px + q + G'z + A'y + z_ub - z_lb = 0,  z, z_lb, z_ub >= 0.
"""

from __future__ import annotations

import numpy as np

from pogs_tpu_torch.types import Cone, ConeConstraint, SolverSettings, Status
from pogs_tpu_torch.api.cone import solve_cone
from pogs_tpu_torch.solver.cone import ConeSolver

__all__ = ["solve_qp", "solve_lp", "solve_qps"]


def _is_sparse(M) -> bool:
    return M is not None and hasattr(M, "tocoo")


def _nrows(M) -> int:
    return 0 if M is None else int(M.shape[0])


# ---------------------------------------------------------------------------
# Presolve: cheap exact reductions applied before the cone lowering.
# The reference has no presolve at all; real QPS files (Maros–Mészáros)
# are full of FX-bound fixed variables and substitution-emptied rows, so
# solving them raw creates degenerate opposing-inequality pairs.  All
# reductions here are EXACT (no tolerance-based dropping of near-zeros):
#   1. lb > ub anywhere            -> INFEASIBLE immediately.
#   2. fixed variables (lb == ub)  -> substituted out of P, q, G, A.
#   3. structurally zero rows left by the substitution -> dropped after
#      a feasibility check (0'x <= h_i with h_i < 0 -> INFEASIBLE).
# The reduction STRUCTURE (fixed set, kept rows) depends only on the
# finite-bound pattern and the matrices, which the warm re-solve
# contract already freezes; fixed VALUES are solve-time data and may
# change between warm calls.  The structure is stored on the returned
# solver handle and re-applied (and checked) on warm re-solves.
# ---------------------------------------------------------------------------


def _presolve_structure(G, A, lb, ub, n):
    """Compute the reduction structure.  Returns None when nothing
    reduces, else dict(fixed, free, keep_g, keep_a)."""
    lb_a = np.full(n, -np.inf) if lb is None else np.asarray(lb, np.float64)
    ub_a = np.full(n, np.inf) if ub is None else np.asarray(ub, np.float64)
    bad = lb_a > ub_a
    if np.any(bad):
        return {"infeasible_bounds": np.flatnonzero(bad)}
    fixed = np.flatnonzero(np.isfinite(lb_a) & (lb_a == ub_a))
    if fixed.size == 0:
        return None
    free = np.setdiff1d(np.arange(n), fixed, assume_unique=False)

    def keep_rows(M):
        if M is None:
            return None
        Mf = M[:, free] if not _is_sparse(M) else M.tocsc()[:, free].tocsr()
        if _is_sparse(Mf):
            nz = np.asarray(abs(Mf).sum(axis=1)).ravel()
        else:
            nz = np.abs(np.asarray(Mf, np.float64)).sum(axis=1)
        return nz > 0.0

    return {"fixed": fixed, "free": free,
            "keep_g": keep_rows(G), "keep_a": keep_rows(A)}


def _reduce_qp(P, q, G, h, A, b, lb, ub, st):
    """Apply a `_presolve_structure` reduction.  Returns the reduced
    pieces plus the objective constant and the fixed values, or a
    string reason when the substitution itself proves infeasibility."""
    fixed, free = st["fixed"], st["free"]
    v = np.asarray(ub, np.float64)[fixed]  # == lb[fixed]
    if P is None:  # LP: no quadratic coupling to substitute
        Pd = None
        P_r = None
        q_r = np.asarray(q, np.float64)[free]
        const = float(np.asarray(q, np.float64)[fixed] @ v)
    elif np.ndim(P) == 1:  # diagonal Hessian: no coupling either
        p = np.asarray(P, np.float64)
        Pd = ("diag", p)
        P_r = p[free]
        q_r = np.asarray(q, np.float64)[free]
        const = float(0.5 * p[fixed] @ (v * v)
                      + np.asarray(q, np.float64)[fixed] @ v)
    else:
        Pd = np.asarray(P.todense() if _is_sparse(P) else P, np.float64)
        Pd = (Pd + Pd.T) / 2
        P_r = Pd[np.ix_(free, free)]
        q_r = np.asarray(q, np.float64)[free] + Pd[np.ix_(free, fixed)] @ v
        const = float(0.5 * v @ Pd[np.ix_(fixed, fixed)] @ v
                      + np.asarray(q, np.float64)[fixed] @ v)

    def split(M, rhs, keep, is_ineq):
        if M is None:
            return None, None, None
        Mc = M.tocsc() if _is_sparse(M) else np.asarray(M, np.float64)
        shift = (Mc[:, fixed] @ v if _is_sparse(M)
                 else Mc[:, fixed] @ v)
        rhs_r = np.asarray(rhs, np.float64).ravel() - np.asarray(shift).ravel()
        # Feasibility of the rows the reduction empties: 0'x {<=,=} rhs_r.
        empty = ~keep
        if np.any(empty):
            viol = (rhs_r[empty] < 0.0) if is_ineq \
                else (rhs_r[empty] != 0.0)
            if np.any(viol):
                return "row", None, None
        M_r = (Mc[:, free].tocsr()[keep] if _is_sparse(M)
               else Mc[np.ix_(keep, free)])
        return None, M_r, rhs_r[keep]

    bad, G_r, h_r = split(G, h, st["keep_g"], True)
    if bad:
        return "a zeroed inequality row has negative right-hand side"
    bad, A_r, b_r = split(A, b, st["keep_a"], False)
    if bad:
        return "a zeroed equality row has nonzero right-hand side"
    lb_r = None if lb is None else np.asarray(lb, np.float64)[free]
    ub_r = None if ub is None else np.asarray(ub, np.float64)[free]
    return {"P": P_r, "q": q_r, "G": G_r, "h": h_r, "A": A_r, "b": b_r,
            "lb": lb_r, "ub": ub_r, "v": v, "const": const, "Pd": Pd}


def _infeasible_result(n, reason):
    nan = np.full(n, np.nan)
    return {
        "x": nan, "y": np.zeros(0), "l": np.zeros(0), "z": np.zeros(0),
        "s": np.zeros(0), "optval": float("nan"), "iterations": 0,
        "num_iters": 0, "status": int(Status.INFEASIBLE),
        "status_name": "INFEASIBLE", "solve_time": 0.0,
        "abs_tol": 0.0, "rel_tol": 0.0,
        "y_eq": np.zeros(0), "z_ineq": np.zeros(0),
        "z_lb": np.zeros(n), "z_ub": np.zeros(n),
        "presolve": reason,
    }


def solve_qp(
    P,
    q,
    G=None,
    h=None,
    A=None,
    b=None,
    lb=None,
    ub=None,
    solver=None,
    warm_start: bool = False,
    presolve: bool = True,
    **kw,
):
    """Solve a convex QP; returns the result-dict contract of
    :func:`~pogs_tpu_torch.api.cone.solve_cone` with QP extras:

    - ``x`` — primal solution, ``optval`` — (1/2)x'Px + q'x
    - ``y_eq`` — equality multipliers (free sign), ``z_ineq`` — Gx<=h
      multipliers (>= 0), ``z_lb``/``z_ub`` — bound multipliers (>= 0)
    - everything else (status, iterations, residual diagnostics) as in
      ``solve_cone``.

    ``P`` must be symmetric PSD; ``P=None`` solves the LP (use
    :func:`solve_lp`).  A **1-D** ``P`` (or a scipy-sparse matrix that
    is diagonal) is a separable quadratic ``(1/2) sum_j P_j x_j^2`` and
    takes a factorization-free path — no O(n^3) eigendecomposition, one
    sparse epigraph row per positive entry — so it scales to n ~ 10^5.
    ``G``/``A`` may be dense or scipy
    sparse (sparse inputs keep the solver's auto-densify policy).
    Tolerances/limits pass through as keyword arguments
    (``abs_tol``/``rel_tol``/``max_iter``/``dtype``/``qp_via``/``device``/
    ``sparse_policy``/...).
    Pass ``solver=`` a previous call's ``result["solver"]`` together
    with ``warm_start=True`` for the re-solve pattern: ``q``, ``h``,
    ``b``, ``lb``, ``ub`` values may change between such calls (they are
    solve-time arguments), but ``P``, ``G``, ``A`` and the pattern of
    finite bounds must stay fixed (they are baked into the factorized
    operator).

    ``presolve=True`` (default) applies exact reductions before the
    lowering: inconsistent bounds (``lb > ub``) certify INFEASIBLE
    immediately; fixed variables (``lb == ub``, the QPS ``FX`` bound)
    are substituted out of ``P``/``q``/``G``/``A``; rows the
    substitution empties are feasibility-checked and dropped.  The
    result is expanded back to full size (primal, objective constant,
    duals — fixed-variable multipliers recovered from stationarity) and
    carries a ``result["presolve"]`` summary.  Warm re-solves may change
    the fixed *values* but not the fixed index set.
    """
    q = np.asarray(q, np.float64).ravel()
    n = q.shape[0]
    if (G is None) != (h is None):
        raise ValueError("G and h must be given together")
    if (A is None) != (b is None):
        raise ValueError("A and b must be given together")
    if _is_sparse(P):
        # A sparse Hessian that is actually diagonal (common in real QPS
        # files: separable quadratics) takes the factorization-free
        # diagonal path; anything else densifies (the epigraph factor
        # needs an eigendecomposition).
        import scipy.sparse as sp

        d = P.diagonal()
        P = (d if (P - sp.diags(d)).nnz == 0
             else np.asarray(P.todense(), np.float64))
    elif P is not None:
        P = np.asarray(P, np.float64)

    if presolve:
        if solver is not None:
            st = getattr(solver, "_qp_presolve", None)
            if st is not None:
                st_now = _presolve_structure(G, A, lb, ub, n)
                if (st_now is None or "infeasible_bounds" in st_now
                        or not np.array_equal(st_now["fixed"], st["fixed"])):
                    raise ValueError(
                        "warm re-solve changed the fixed-variable pattern "
                        "(the lb == ub index set); rebuild the solver")
                return _presolved_solve(P, q, G, h, A, b, lb, ub, st,
                                        solver, warm_start, kw)
        else:
            st = _presolve_structure(G, A, lb, ub, n)
            if st is not None:
                if "infeasible_bounds" in st:
                    return _infeasible_result(
                        n, "bounds are inconsistent (lb > ub) at indices "
                           f"{st['infeasible_bounds'][:8].tolist()}")
                return _presolved_solve(P, q, G, h, A, b, lb, ub, st,
                                        None, warm_start, kw)

    n_eq = _nrows(A)
    n_in = _nrows(G)
    if n_eq == 0 and n_in == 0 and (P is None or np.ndim(P) == 1):
        # Separable problem (diagonal or no Hessian, bounds only): the
        # answer is the per-coordinate closed form — no iteration at all.
        return _solve_separable(P, q, lb, ub)
    ub_idx = np.flatnonzero(np.isfinite(np.asarray(ub, np.float64))) \
        if ub is not None else np.empty(0, np.intp)
    lb_idx = np.flatnonzero(np.isfinite(np.asarray(lb, np.float64))) \
        if lb is not None else np.empty(0, np.intp)

    # Row order: equalities, G rows, finite upper bounds, finite lower
    # bounds (negated) — the same lowering the Maros suite certifies.
    # Large bounds-only problems (e.g. a big separable QP) get sparse
    # bound rows: densifying them would cost O(n^2) memory for what is
    # one nonzero per row.
    sparse = (_is_sparse(G) or _is_sparse(A)
              or (n > 512 and n_eq + n_in == 0))
    blocks, rhs = [], []
    if n_eq:
        blocks.append(A)
        rhs.append(np.asarray(b, np.float64).ravel())
    if n_in:
        blocks.append(G)
        rhs.append(np.asarray(h, np.float64).ravel())
    if ub_idx.size:
        E = _bound_rows(n, ub_idx, +1.0, sparse)
        blocks.append(E)
        rhs.append(np.asarray(ub, np.float64)[ub_idx])
    if lb_idx.size:
        E = _bound_rows(n, lb_idx, -1.0, sparse)
        blocks.append(E)
        rhs.append(-np.asarray(lb, np.float64)[lb_idx])

    if not blocks:
        return _solve_unconstrained(P, q)

    if sparse:
        import scipy.sparse as sp

        A_bar = sp.vstack([sp.csr_matrix(B) for B in blocks], format="csr")
    else:
        A_bar = np.vstack([np.asarray(B, np.float64) for B in blocks])
    b_bar = np.concatenate(rhs)
    m = A_bar.shape[0]

    Ky = []
    if n_eq:
        Ky.append(ConeConstraint(Cone.ZERO, range(n_eq)))
    if m > n_eq:
        Ky.append(ConeConstraint(Cone.NON_NEG, range(n_eq, m)))

    if solver is None:
        # Built here (not inside solve_cone) so the factorized solver can
        # be returned for the warm re-solve pattern.
        settings = SolverSettings(
            abs_tol=kw.get("abs_tol", 1e-4), rel_tol=kw.get("rel_tol", 1e-4),
            max_iter=kw.get("max_iter", 2500), verbose=kw.get("verbose", 0),
            polish=kw.get("polish", True),
        )
        solver = ConeSolver(A_bar, Ky=Ky, settings=settings,
                            strategy=kw.get("strategy"), dtype=kw.get("dtype"),
                            qp_via=kw.get("qp_via", "socp"), device=kw.get("device"),
                            sparse_policy=kw.get("sparse_policy", "auto"))

    out = solve_cone(A_bar, b_bar, q, Kx=(), Ky=Ky, P=P,
                     solver=solver, warm_start=warm_start, **kw)
    out["solver"] = solver

    # Split duals back into the user's blocks (stationarity convention
    # Px + q + A_bar' lam = 0, lam >= 0 on the NonNeg rows).
    lam = np.asarray(out["l"], np.float64)
    off = n_eq
    out["y_eq"] = lam[:n_eq]
    out["z_ineq"] = lam[off:off + n_in]
    off += n_in
    z_ub = np.zeros(n)
    z_ub[ub_idx] = lam[off:off + ub_idx.size]
    off += ub_idx.size
    z_lb = np.zeros(n)
    z_lb[lb_idx] = lam[off:off + lb_idx.size]
    out["z_ub"], out["z_lb"] = z_ub, z_lb
    return out


def _presolved_solve(P, q, G, h, A, b, lb, ub, st, solver, warm_start, kw):
    """Solve the reduced QP and expand the result back to full size."""
    n = q.shape[0]
    red = _reduce_qp(P, q, G, h, A, b, lb, ub, st)
    if isinstance(red, str):
        return _infeasible_result(n, red)
    fixed, free = st["fixed"], st["free"]
    G_r, h_r = red["G"], red["h"]
    A_r, b_r = red["A"], red["b"]
    if G_r is not None and G_r.shape[0] == 0:
        G_r = h_r = None
    if A_r is not None and A_r.shape[0] == 0:
        A_r = b_r = None
    out = solve_qp(red["P"], red["q"], G_r, h_r, A_r, b_r,
                   red["lb"], red["ub"], solver=solver,
                   warm_start=warm_start, presolve=False, **kw)
    if "solver" in out and out["solver"] is not None:
        out["solver"]._qp_presolve = st

    # Expand the primal, shift the objective by the substituted constant.
    x_full = np.empty(n)
    x_full[free] = np.asarray(out["x"], np.float64)
    x_full[fixed] = red["v"]
    out["x"] = x_full
    out["optval"] = float(out["optval"]) + red["const"]

    # Scatter duals back over the dropped rows (multiplier 0 there) and
    # the full variable set.
    if G is not None:
        z_full = np.zeros(G.shape[0])
        z_full[st["keep_g"]] = np.asarray(out["z_ineq"], np.float64)
        out["z_ineq"] = z_full
    if A is not None:
        y_full = np.zeros(A.shape[0])
        y_full[st["keep_a"]] = np.asarray(out["y_eq"], np.float64)
        out["y_eq"] = y_full
    z_lb = np.zeros(n)
    z_ub = np.zeros(n)
    z_lb[free] = np.asarray(out["z_lb"], np.float64)
    z_ub[free] = np.asarray(out["z_ub"], np.float64)
    # Fixed-variable multipliers from stationarity
    # (Px + q + G'z + A'y + z_ub - z_lb = 0 restricted to the fixed set).
    Pd = red["Pd"]
    if Pd is None:
        r = q
    elif isinstance(Pd, tuple):  # ("diag", p)
        r = Pd[1] * x_full + q
    else:
        r = Pd @ x_full + q
    if G is not None:
        r = r + (G.T @ out["z_ineq"] if _is_sparse(G)
                 else np.asarray(G, np.float64).T @ out["z_ineq"])
    if A is not None:
        r = r + (A.T @ out["y_eq"] if _is_sparse(A)
                 else np.asarray(A, np.float64).T @ out["y_eq"])
    z_ub[fixed] = np.maximum(-r[fixed], 0.0)
    z_lb[fixed] = np.maximum(r[fixed], 0.0)
    out["z_lb"], out["z_ub"] = z_lb, z_ub
    out["presolve"] = {
        "fixed_variables": int(fixed.size),
        "dropped_ineq_rows": int(0 if st["keep_g"] is None
                                 else np.sum(~st["keep_g"])),
        "dropped_eq_rows": int(0 if st["keep_a"] is None
                               else np.sum(~st["keep_a"])),
    }
    return out


def _bound_rows(n: int, idx, sign: float, sparse: bool):
    """±e_j rows selecting the finitely-bounded coordinates."""
    if sparse:
        import scipy.sparse as sp

        data = np.full(idx.size, sign)
        return sp.csr_matrix((data, (np.arange(idx.size), idx)),
                             shape=(idx.size, n))
    E = np.zeros((idx.size, n))
    E[np.arange(idx.size), idx] = sign
    return E


def solve_lp(
    c,
    G=None,
    h=None,
    A=None,
    b=None,
    lb=None,
    ub=None,
    solver=None,
    warm_start: bool = False,
    presolve: bool = True,
    **kw,
):
    """Solve a linear program

        minimize    c'x
        subject to  G x <= h,   A x = b,   lb <= x <= ub

    with the same result contract, presolve, warm re-solve pattern, and
    dual splitting as :func:`solve_qp` (stationarity
    ``c + G'z + A'y + z_ub - z_lb = 0``).  Routed as a pure cone-form LP
    (no epigraph variable), which keeps the HSDE's interior-point tail
    polish available — the path the LP benchmarks certify."""
    return solve_qp(None, c, G=G, h=h, A=A, b=b, lb=lb, ub=ub,
                    solver=solver, warm_start=warm_start,
                    presolve=presolve, **kw)


def solve_qps(path, sparse=False, **kw):
    """Load a QPS/MPS file and solve it in one call.

    ``objective`` in the result includes the file's constant term
    (``optval`` stays the bare ``(1/2)x'Px + q'x`` like ``solve_qp``);
    ``name`` carries the problem name.  All-zero Hessians route through
    :func:`solve_lp`.  ``sparse=True`` keeps the constraint matrices
    sparse (use for the large Maros–Mészáros instances); solver keyword
    arguments (``abs_tol``/``dtype``/...) pass through."""
    from pogs_tpu_torch.utils.qps import load_qps, qps_to_solve_qp_kwargs

    p = load_qps(path, sparse=sparse)
    qkw = qps_to_solve_qp_kwargs(p)
    P = qkw.pop("P")
    nnz = P.nnz if hasattr(P, "nnz") else np.count_nonzero(np.asarray(P))
    if nnz == 0:
        out = solve_lp(qkw.pop("q"), **qkw, **kw)
    else:
        out = solve_qp(P, qkw.pop("q"), **qkw, **kw)
    out["objective"] = float(out["optval"]) + p["c0"]
    out["name"] = p["name"]
    return out


def _solve_separable(P, q, lb, ub):
    """Per-coordinate closed form for  min Σ_j (1/2) p_j x_j² + q_j x_j
    s.t. lb ≤ x ≤ ub:  x_j* = clip(−q_j/p_j, lb_j, ub_j) (p_j > 0), or
    the bound the gradient pushes toward (p_j = 0).  Bound multipliers
    come from stationarity  p x + q + z_ub − z_lb = 0."""
    n = q.shape[0]
    if lb is None and ub is None:
        return _solve_unconstrained(P, q)
    lo = (np.full(n, -np.inf) if lb is None
          else np.asarray(lb, np.float64).ravel())
    hi = (np.full(n, np.inf) if ub is None
          else np.asarray(ub, np.float64).ravel())
    if np.any(lo > hi):
        return _infeasible_result(
            n, "bounds are inconsistent (lb > ub) at indices "
               f"{np.flatnonzero(lo > hi)[:8].tolist()}")
    p = np.zeros(n) if P is None else np.asarray(P, np.float64).ravel()
    pos = p > 0.0
    target = np.where(pos, -q / np.where(pos, p, 1.0),
                      np.where(q > 0.0, lo, np.where(q < 0.0, hi, 0.0)))
    unbounded = ~pos & ((q > 0.0) & ~np.isfinite(lo)
                        | (q < 0.0) & ~np.isfinite(hi))
    if np.any(unbounded):
        out = _infeasible_result(n, "separable problem is unbounded below "
                                    "along coordinates "
                                    f"{np.flatnonzero(unbounded)[:8].tolist()}")
        out["status"] = int(Status.UNBOUNDED)
        out["status_name"] = "UNBOUNDED"
        return out
    x = np.clip(target, lo, hi)
    r = p * x + q
    out = _infeasible_result(n, "separable closed form")
    out.update(
        x=x, optval=float(0.5 * x @ (p * x) + q @ x),
        status=int(Status.SUCCESS), status_name="SUCCESS",
        z_ub=np.maximum(-r, 0.0), z_lb=np.maximum(r, 0.0),
    )
    return out


def _solve_unconstrained(P, q):
    """No constraints: Px = -q by Cholesky (PSD-singular → least norm)."""
    if P is None:  # LP with no constraints at all
        if np.any(q != 0.0):
            raise ValueError(
                "unconstrained LP with nonzero objective is unbounded below")
        n = q.shape[0]
        out = _infeasible_result(n, "")
        del out["presolve"]
        out.update(x=np.zeros(n), optval=0.0,
                   status=int(Status.SUCCESS), status_name="SUCCESS",
                   z_lb=np.zeros(n), z_ub=np.zeros(n))
        return out
    if np.ndim(P) == 1:  # diagonal Hessian: separable closed form
        p = np.asarray(P, np.float64)
        if np.any((p == 0.0) & (q != 0.0)):
            raise ValueError(
                "unconstrained QP is unbounded below (q has a component "
                "outside range(P))")
        x = np.where(p > 0.0, -q / np.where(p > 0.0, p, 1.0), 0.0)
        out = _infeasible_result(q.shape[0], "")
        del out["presolve"]
        out.update(x=x, optval=float(0.5 * x @ (p * x) + q @ x),
                   status=int(Status.SUCCESS), status_name="SUCCESS",
                   z_lb=np.zeros(q.shape[0]), z_ub=np.zeros(q.shape[0]))
        return out
    Pd = np.asarray(
        P.todense() if _is_sparse(P) else P, np.float64)
    Pd = (Pd + Pd.T) / 2
    try:
        L = np.linalg.cholesky(Pd)
        x = np.linalg.solve(L.T, np.linalg.solve(L, -q))
    except np.linalg.LinAlgError:
        x, *_ = np.linalg.lstsq(Pd, -q, rcond=None)
        if not np.allclose(Pd @ x, -q, atol=1e-8 * (1 + np.abs(q).max())):
            raise ValueError(
                "unconstrained QP is unbounded below (q has a component "
                "outside range(P))") from None
    optval = float(0.5 * x @ Pd @ x + q @ x)
    n = q.shape[0]
    return {
        "x": x, "y": np.zeros(0), "l": np.zeros(0), "z": np.zeros(0),
        "s": np.zeros(0), "optval": optval, "iterations": 0,
        "num_iters": 0, "status": 0, "status_name": "SUCCESS",
        "solve_time": 0.0, "abs_tol": 0.0, "rel_tol": 0.0,
        "y_eq": np.zeros(0), "z_ineq": np.zeros(0),
        "z_lb": np.zeros(n), "z_ub": np.zeros(n),
    }
