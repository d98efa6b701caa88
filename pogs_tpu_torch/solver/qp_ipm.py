"""Host-side Mehrotra predictor-corrector IPM for polyhedral QPs.

A copy of ``pogs_tpu/solver/qp_ipm.py`` (numpy and scipy only), kept here
so that the port imports nothing of the JAX package.

The mid-size QP fast path:

    min ½xᵀPx + cᵀx   s.t.   b − Ax ∈ K_y,
    K_y a product of Zero / NonNeg / NonPos segments,

solved as a primal-dual interior-point method with one (sparse or dense)
KKT factorization per iteration.  Twenty-ish Newton steps reach μ ~ 1e-12
where the DR/ADMM splitting needs O(10³-10⁴) iterations to identify the
active set on ill-conditioned instances (Maros–Mészáros CVXQP family),
so on the host this is the 10-100x cheaper route to a seed that the PDAS
polish (qp_polish.py) then certifies to ~1e-11 KKT residuals.

Structure is exploited automatically: when P and A are sparse enough
(most Maros–Mészáros data is — CVXQP's "dense" arrays are >99% zeros)
the per-iteration solve is a scipy ``splu`` of the sparse quasi-definite
KKT matrix; genuinely dense data takes a dense LU of the same system.

The reference has nothing comparable — its QP story stops at warning
about the HSDE/QP mismatch (reference src/cpu/pogs.cpp:1935-1944,
python/pogs_cvxpy.py:160-173).  This module exists because "match or
beat" on QPs requires wall-clock parity with specialized QP solvers,
which no splitting method provides at mid-size on a CPU host.

Everything is float64 numpy/scipy on the host: the IPM is a seed/polish
accelerator outside the solve loop, exactly like qp_polish.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Static quasi-definite regularization of the KKT matrix; iterative
# refinement (in the polish stage) removes its footprint from the answer.
_DELTA = 1e-9
# Sparsity threshold below which the sparse KKT route is taken.
_SPARSE_FRAC = 0.05
# Beyond this dimension a dense per-iteration LU is not attempted.
_MAX_DENSE_DIM = 6000
# Divergence guard: iterates larger than this flag an infeasible /
# unbounded / hopeless instance and hand control back to the HSDE path,
# which owns certificate detection.
_BLOWUP = 1e14


def _is_sparse(M) -> bool:
    return hasattr(M, "tocsr")


def _density(M) -> float:
    if _is_sparse(M):
        return M.nnz / max(1, M.shape[0] * M.shape[1])
    M = np.asarray(M)
    return np.count_nonzero(M) / max(1, M.size)


class _KKT:
    """Per-iteration factor/solve of the condensed quasi-definite system

        [ P + GᵀWG + δI    Eᵀ  ] [dx]   [r1]
        [ E               −δI  ] [dy] = [r2]

    with W = z/s the inequality scaling.  Sparse (splu) or dense (LU)
    depending on the data; the sparsity pattern is assembled once and
    only W changes between factorizations."""

    def __init__(self, P, E, G, use_sparse: bool):
        import scipy.linalg as sla
        import scipy.sparse as sp

        self._sla = sla
        self._sp = sp
        self.n = P.shape[0] if P.ndim == 2 else P.shape[0]
        self.me = E.shape[0]
        self.sparse = use_sparse
        if use_sparse:
            Psp = (P.tocsr() if _is_sparse(P) else
                   sp.diags(P) if P.ndim == 1 else sp.csr_matrix(P))
            self.P = Psp.tocsr()
            self.E = (E.tocsr() if _is_sparse(E) else sp.csr_matrix(E))
            self.G = (G.tocsr() if _is_sparse(G) else sp.csr_matrix(G))
        else:
            self.P = (P.toarray() if _is_sparse(P) else
                      np.diag(P) if P.ndim == 1 else np.asarray(P, np.float64))
            self.E = (E.toarray() if _is_sparse(E)
                      else np.asarray(E, np.float64))
            self.G = (G.toarray() if _is_sparse(G)
                      else np.asarray(G, np.float64))
        self._factor = None

    def refactor(self, W: np.ndarray) -> bool:
        """Factor the KKT matrix for the given inequality scaling W ≥ 0.
        Returns False when the factorization fails (caller falls back)."""
        n, me = self.n, self.me
        if self.sparse:
            sp = self._sp
            GWG = (self.G.T.multiply(W) @ self.G) if self.G.shape[0] else \
                sp.csr_matrix((n, n))
            top = self.P + GWG + _DELTA * sp.eye(n)
            K = sp.bmat(
                [[top, self.E.T if me else None],
                 [self.E if me else None,
                  -_DELTA * sp.eye(me) if me else None]],
                format="csc",
            ) if me else top.tocsc()
            try:
                from scipy.sparse.linalg import splu

                # COLAMD (the default) measures ~2-4x less fill than
                # MMD_AT_PLUS_A / SymmetricMode on the mod-coupled
                # CVXQP-class patterns; keep it.
                self._factor = splu(K)
            except Exception:
                return False
        else:
            GWG = (self.G.T * W) @ self.G if self.G.shape[0] else 0.0
            dim = n + me
            K = np.zeros((dim, dim))
            K[:n, :n] = self.P + GWG
            K[np.arange(n), np.arange(n)] += _DELTA
            if me:
                K[:n, n:] = self.E.T
                K[n:, :n] = self.E
                K[n:, n:] = -_DELTA * np.eye(me)
            try:
                self._factor = self._sla.lu_factor(K)
            except Exception:
                return False
        return True

    def solve(self, r1: np.ndarray, r2: np.ndarray):
        rhs = np.concatenate([r1, r2])
        if self.sparse:
            z = self._factor.solve(rhs)
        else:
            z = self._sla.lu_solve(self._factor, rhs)
        if not np.all(np.isfinite(z)):
            return None
        return z[: self.n], z[self.n:]


def ipm_solve(
    P,
    c: np.ndarray,
    A,
    b: np.ndarray,
    kind: np.ndarray,
    tol: float = 1e-9,
    max_iter: int = 50,
) -> Optional[dict]:
    """Mehrotra predictor-corrector on the row-classified QP.

    ``kind`` follows qp_polish.row_kinds: 0 equality, +1 NonNeg slack
    (aᵢᵀx ≤ bᵢ), −1 NonPos slack (aᵢᵀx ≥ bᵢ).  ``P`` may be a dense
    (n, n) array, a 1-D diagonal, or scipy sparse; ``A`` dense or scipy
    sparse.

    Returns dict(x, lam, iters, mu) with ``lam`` the cone-convention
    duals in original row order (λ ≥ 0 on NonNeg rows, ≤ 0 on NonPos,
    free on equalities, stationarity Px + c + Aᵀλ = 0), or None when the
    method failed to converge (caller keeps its splitting path, which
    owns infeasibility certificates).
    """
    import scipy.sparse as sp

    c = np.asarray(c, np.float64)
    b = np.asarray(b, np.float64)
    kind = np.asarray(kind)
    n = c.shape[0]
    m = b.shape[0]

    if _is_sparse(A):
        A = A.tocsr().astype(np.float64)
    else:
        A = np.asarray(A, np.float64)
    eq = kind == 0
    ineq = ~eq
    sgn = kind[ineq].astype(np.float64)  # ±1 per inequality row
    idx_eq = np.flatnonzero(eq)
    idx_in = np.flatnonzero(ineq)
    E = A[idx_eq]
    # Flip NonPos rows so every inequality reads  G x + s = g,  s ≥ 0.
    if _is_sparse(A):
        G = sp.diags(sgn) @ A[idx_in]
    else:
        G = sgn[:, None] * A[idx_in]
    h = b[idx_eq]
    g = sgn * b[idx_in]
    mi = idx_in.size
    me = idx_eq.size

    dens = max(_density(P) if not (hasattr(P, "ndim") and P.ndim == 1)
               else 0.0, _density(A))
    use_sparse = (dens <= _SPARSE_FRAC and n + me > 200)
    if not use_sparse and n + me > _MAX_DENSE_DIM:
        return None
    if n + m > 500_000:  # sparse-LU fill is unbounded in principle; punt
        return None      # huge instances to the matrix-free solver paths
    Pd = P if (_is_sparse(P) or P.ndim == 1) else np.asarray(P, np.float64)
    kkt = _KKT(Pd, E, G, use_sparse)
    # The iteration's own matvecs use the same representation the KKT
    # assembly chose: dense G/E matvecs on >99%-zero data would dominate
    # the whole solve.
    E, G = kkt.E, kkt.G

    def pmv(x):
        return kkt.P @ x  # sparse csr, dense (n,n), or densified diagonal

    # -- starting point (Mehrotra's heuristic) ------------------------------
    if not kkt.refactor(np.ones(mi)):
        return None
    sol = kkt.solve(-c + (G.T @ g if mi else 0.0), h)
    if sol is None:
        return None
    x, y = sol
    s = (g - G @ x) if mi else np.zeros(0)
    z = -s.copy()
    ds = max(-1.5 * s.min(initial=0.0), 0.0)
    dz = max(-1.5 * z.min(initial=0.0), 0.0)
    s = s + ds + 0.1
    z = z + dz + 0.1
    if mi:
        dot = float(s @ z)
        s += 0.5 * dot / max(z.sum(), 1e-12)
        z += 0.5 * dot / max(s.sum(), 1e-12)

    b_sc = 1.0 + float(np.max(np.abs(b), initial=0.0))
    c_sc = 1.0 + float(np.max(np.abs(c), initial=0.0))

    if mi == 0:
        # Equality-constrained QP: the starting solve IS the answer, after
        # refining away the ±δ regularization (the factor is reused; a
        # genuinely inconsistent system keeps a visible residual and the
        # caller's acceptance test rejects it).
        for _ in range(3):
            r_d = pmv(x) + c + (E.T @ y if me else 0.0)
            r_p = (E @ x - h) if me else np.zeros(0)
            sol = kkt.solve(-r_d, -r_p)
            if sol is None:
                break
            dx, dy = sol
            x = x + dx
            y = y + dy
        lam = np.zeros(m)
        lam[idx_eq] = y
        return {"x": x, "lam": lam, "iters": 0, "mu": 0.0}

    for it in range(max_iter):
        r_d = pmv(x) + c + (E.T @ y if me else 0.0) + G.T @ z
        r_p1 = (E @ x - h) if me else np.zeros(0)
        r_p2 = G @ x + s - g
        mu = float(s @ z) / mi
        if (np.max(np.abs(r_d)) <= tol * c_sc
                and np.max(np.abs(r_p1), initial=0.0) <= tol * b_sc
                and np.max(np.abs(r_p2)) <= tol * b_sc
                and mu <= tol):
            break
        if (np.max(np.abs(x)) > _BLOWUP or np.max(z) > _BLOWUP
                or not np.isfinite(mu)):
            return None

        s_safe = np.maximum(s, 1e-300)
        W = z / s_safe
        if not kkt.refactor(W):
            return None

        def newton(r_c):
            # Eliminate (ds, dz):  dz = W·(G dx + r_p2) − r_c/s,
            #                      ds = −(G dx + r_p2).
            rhs1 = -r_d - G.T @ (W * r_p2 - r_c / s_safe)
            sol = kkt.solve(rhs1, -r_p1)
            if sol is None:
                return None
            dx, dy = sol
            Gdx = G @ dx
            dz = W * (Gdx + r_p2) - r_c / s_safe
            ds = -(Gdx + r_p2)
            return dx, dy, ds, dz

        def step_len(v, dv):
            neg = dv < 0
            if not neg.any():
                return 1.0
            return min(1.0, float(np.min(-v[neg] / dv[neg])))

        # Predictor (affine scaling).
        aff = newton(s * z)
        if aff is None:
            return None
        dx_a, dy_a, ds_a, dz_a = aff
        ap = step_len(s, ds_a)
        ad = step_len(z, dz_a)
        mu_aff = float((s + ap * ds_a) @ (z + ad * dz_a)) / mi
        sigma = min(1.0, max(0.0, mu_aff / max(mu, 1e-300))) ** 3

        # Corrector.
        corr = newton(s * z + ds_a * dz_a - sigma * mu)
        if corr is None:
            return None
        dx, dy, ds, dz = corr
        ap = 0.995 * step_len(s, ds)
        ad = 0.995 * step_len(z, dz)
        x = x + ap * dx
        s = s + ap * ds
        if me:
            y = y + ad * dy
        z = z + ad * dz
    else:
        return None

    lam = np.zeros(m)
    if me:
        lam[idx_eq] = y
    lam[idx_in] = sgn * z  # undo the row flip: cone-convention signs
    return {"x": x, "lam": lam, "iters": it, "mu": mu}
