"""Homogeneous self-dual embedding (HSDE) cone solver, as an eager torch loop.

Counterpart of ``pogs_tpu/solver/hsde.py``.  Solves

    minimize    c'x (+ ½ x'Px)
    subject to  b − A x ∈ K_y,   x free

by Douglas–Rachford splitting on the embedding u = [x; y; τ]:

    w   = (I + Q)^{-1} u              (Q the skew HSDE operator)
    z   = Π_{R^n × K_y* × R_+}(2w − u)
    u  += α (z − w)

with adaptive over-relaxation α ∈ [1.0, 1.7], the primal / dual / gap test
every 10 iterations, and the infeasibility / unboundedness certificates of
the τ → 0 branch, classified by dominance and confirmed by a second firing
at a tighter fixed-point residual.  The same constants as the JAX package.

A dense P enters the embedding as the reference's does (Q's x block gains
Px, the Gram operator becomes I + P + AᵀA, the check adds x'Px to the gap
and Px to the dual residual); the embedding with P does not have the QP
optimum as its fixed point, which is why ``ConeSolver`` solves QPs through
the epigraph SOC instead (``solver/cone.py``).  With P the LP polish is off.

Linear solvers for (I + Q) w = u, each factored once:
  * ``smw``    — Sherman–Morrison–Woodbury through the Gram inverse
                 (I + P + AᵀA)⁻¹ (or a caller's ``apply``, e.g. Woodbury
                 through the m×m inverse of a wide A);
  * ``direct`` — Cholesky of the normal equations MᵀM + δI (M = I + Q) with
                 two refinement steps, for small embeddings;
  * ``cg``     — Jacobi-preconditioned CG on the normal equations, on split
                 (x, y, τ) tuples, with a residual-tied tolerance and one
                 refinement pass; matrix-free (A's products only), so it
                 serves a sparse A.  The host reads its done flag every
                 ``cgls.CHECK_EVERY`` iterations.

The DR loop keeps no host in it: the state freezes once ``done`` is set
(``torch.where``), the host reads ``done`` once per check (every 10
iterations), and both branches of the τ test are evaluated and the right
one selected.  The host knows the iteration number, which equals the
device's ``k`` until ``done``, so the check runs only on its own
iterations.  The interior-point polish (``polish=True``) runs a Mehrotra
predictor–corrector burst on separable-only tall LPs, and adopts the point
only if it passes the full convergence test (``polish_plan``): every 250
iterations with Cholesky Newton solves within the standard size caps
(a sparse A densified for the polish only, up to 256 MiB), every 1000
beyond them (the XL caps), and beyond those, on inequality-only LPs, every
2000 with the Newton systems solved matrix-free by Jacobi-PCG on AᵀDA.

This loop with ``strategy="smw"`` and no polish is the plain version of the
CUDA cone kernel (``ops/fused_hsde.py``).

On a sharded operator (``parallel/mesh.py``, ``parallel/sparse.py``) the
state stays split as (x, y, τ), each rank holding its part of the split
side; every dot and norm on that side sums through the operator's
``reduce`` (the check's in two stacked calls, one before and one after τ is
known), the cone projections of a row-sharded y go through
``ShardedConeSet``, and the SMW and ``cg`` solves take the operator's
products.  P is whole on every rank: on the row plan Px is local, on the
column plan each rank multiplies its rows of P by x gathered (one
all-reduce of length n).  The polish, where it runs, runs whole on every
rank on the gathered A and iterate, and each rank keeps its part of the
point.  The ``direct`` strategy takes no sharded A.
"""

from __future__ import annotations

from typing import Optional

import torch

from pogs_tpu_torch.types import Status
from pogs_tpu_torch.cones.sets import ConeSet, shard_cones
from pogs_tpu_torch.linalg.cgls import CHECK_EVERY, run_frozen
from pogs_tpu_torch.linalg.matrix import (
    is_sharded, local_shape, matvecs, part, side_sums, whole,
)
from pogs_tpu_torch.solver.anderson import anderson_init, anderson_step

K_ALPHA_MIN = 1.0
K_ALPHA_MAX = 1.7
K_ALPHA_GROW = 1.02
K_TAU_TOL = 1e-8
K_TAU_REL = 1e-6      # τ/‖w‖ below this marks a certificate ray
K_KAPPA_TOL = 1e-6
K_CHECK_EVERY = 10
K_CERT_CROSS = 0.1    # the competing certificate must be 10x weaker
K_CERT_CONFIRM = 0.25  # a certificate confirms at fp ≤ 0.25·fp_tol
# Interior-point polish cadence and size caps (the dense Cholesky variant;
# the XL caps run the same burst on a sparser cadence).
K_POLISH_START = 250
K_POLISH_EVERY = 250
K_POLISH_IPM_STEPS = 10
K_POLISH_MAX_N = 2048
K_POLISH_MAX_M = 16384
K_POLISH_XL_MAX_N = 8192
K_POLISH_XL_MAX_M = 120_000
K_POLISH_XL_EVERY = 1000
K_POLISH_XL_STEPS = 6
# Beyond the XL caps, inequality-only LPs polish matrix-free (Jacobi-PCG on
# AᵀDA + δI; Zero rows carry a barrier weight the Krylov solver cannot
# absorb).
K_POLISH_CG_MAX_N = 50_000
K_POLISH_CG_MAX_M = 400_000
K_POLISH_CG_EVERY = 2000
K_POLISH_CG_STEPS = 6
K_POLISH_CG_ITERS = 800
# The dense size up to which a sparse A is densified for the Cholesky polish.
K_POLISH_DENSIFY_BYTES = 256 * 2**20


def _nrm(v):
    return torch.linalg.vector_norm(v)


def _dense(A):
    return A.dense() if hasattr(A, "dense") else A


def make_q_matvec(A, b, c, P=None):
    """Q [x;y;τ] = [Px + Aᵀy + cτ; −Ax + bτ; −cᵀx − bᵀy] and Qᵀ, packed form."""
    m, n = A.shape
    q, qt = _q_apply_split(A, b, c, P)

    def q_matvec(u):
        top, mid, bot = q(u[:n], u[n:n + m], u[n + m])
        return torch.cat([top, mid, bot[None]])

    def qt_matvec(u):
        top, mid, bot = qt(u[:n], u[n:n + m], u[n + m])
        return torch.cat([top, mid, bot[None]])

    return q_matvec, qt_matvec


def _dots(A, c, x, b, y):
    """(c·x, b·y), each summed across the shards of its side."""
    return side_sums(A, "n", [("dot", c, x)])[0], side_sums(A, "m", [("dot", b, y)])[0]


def _rmv_dots(A, y, ys):
    """(Aᵀ y, [u·v for (u, v) in ys]) for y-side pairs: on a row-sharded A
    the dots' partial sums ride in the product's all_reduce."""
    if getattr(A, "sharded_side", None) == "m":
        aty, dots = A.rmv_and(y, torch.stack([torch.dot(u, v) for u, v in ys]))
        return aty, list(dots)
    return matvecs(A)[1](y), side_sums(A, "m", [("dot", u, v) for u, v in ys])


def p_apply(A, P):
    """x ↦ Px on this rank's part of x, P a dense (n, n) tensor whole on
    every rank (None for no P): this rank's rows of P times x whole (on a
    column-sharded A, x gathered)."""
    if P is None:
        return None
    P_rows = part(A, "n", P)
    return lambda x: torch.mv(P_rows, whole(A, "n", x))


def _q_apply_split(A, b, c, P=None):
    """Split-form Q and Qᵀ: (x, y, τ) → (x', y', τ'); A a tensor or an
    operator, P a dense (n, n) tensor or None."""
    amv, armv = matvecs(A)
    pmv = p_apply(A, P)

    def q(x, y, tau):
        aty, (by,) = _rmv_dots(A, y, [(b, y)])
        top = aty + c * tau
        if P is not None:
            top = top + pmv(x)
        cx, = side_sums(A, "n", [("dot", c, x)])
        return (top, -amv(x) + b * tau, -cx - by)

    def qt(x, y, tau, sq=False):
        """Qᵀ(x, y, τ); with ``sq`` also ‖(x, y, τ)‖², its y part riding in
        the product's all-reduce on a row-sharded A."""
        aty, dots = _rmv_dots(A, y, [(b, y), (y, y)] if sq else [(b, y)])
        top = -aty - c * tau
        if P is not None:
            top = top + pmv(x)
        cx, = side_sums(A, "n", [("dot", c, x)])
        out = (top, amv(x) - b * tau, cx + dots[0])
        if sq:
            xx, = side_sums(A, "n", [("dot", x, x)])
            out = out + (xx + dots[1] + tau * tau,)
        return out

    return q, qt


def smw_setup(A, b, c, P=None):
    """Factor M = [I+P, Aᵀ; −A, I] by elimination: K = I + P + AᵀA and its
    inverse, then t = M⁻¹h and s_den = 1 + hᵀt for the rank-1 τ coupling.
    On a sharded A the Gram is the reduced local one and t this rank's
    parts."""
    if is_sharded(A):
        G = A.gram("n")
        amv, armv = A.mv, A.rmv
    else:
        A = _dense(A)
        G = A.T @ A
        amv, armv = matvecs(A)
    n = A.shape[1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    K = eye + G
    if P is not None:
        K = K + P
    L = torch.linalg.cholesky(K)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    Kinv = Linv.T @ Linv
    t_x = _kinv_part(Kinv, A, c - armv(b))
    t_y = b + amv(t_x)
    cx, by = _dots(A, c, t_x, b, t_y)
    s_den = 1.0 + cx + by
    return {"Kinv": Kinv, "t_x": t_x, "t_y": t_y, "s_den": s_den}


def _kinv_part(Kinv, A, v):
    """Kinv times an x-side vector, this rank's part in and out (Kinv whole:
    the part is gathered where A splits the x side)."""
    return part(A, "n", torch.mv(Kinv, whole(A, "n", v)))


def _smw_solve_split(factor, A, b, c, ux, uy, ut):
    """(I + Q)⁻¹ u by SMW back-substitution, split form.  ``factor`` may
    carry an ``apply`` callable for (I + AᵀA)⁻¹ that maps this rank's part
    of an x-side vector to its part of the result."""
    amv, armv = matvecs(A)
    apply_kinv = factor.get("apply") or (lambda v: _kinv_part(factor["Kinv"], A, v))
    p_x = apply_kinv(ux - armv(uy))
    p_y = uy + amv(p_x)
    cx, by = _dots(A, c, p_x, b, p_y)
    h_dot_p = cx + by
    u_tau = (ut + h_dot_p) / factor["s_den"]
    return p_x - factor["t_x"] * u_tau, p_y - factor["t_y"] * u_tau, u_tau


def smw_solve(factor, A, b, c, u):
    """Packed-vector wrapper around the split SMW solve."""
    m, n = A.shape
    wx, wy, wt = _smw_solve_split(factor, A, b, c, u[:n], u[n:n + m], u[n + m])
    return torch.cat([wx, wy, wt[None]])


def dense_q(A, b, c, P=None):
    """Materialize I + Q (dim × dim)."""
    Ad = _dense(A)
    m, n = Ad.shape
    dim = n + m + 1
    M = torch.eye(dim, dtype=Ad.dtype, device=Ad.device)
    if P is not None:
        M[:n, :n] += P
    M[:n, n:n + m] = Ad.T
    M[n:n + m, :n] = -Ad
    M[:n, n + m] = c
    M[n:n + m, n + m] = b
    M[n + m, :n] = -c
    M[n + m, n:n + m] = -b
    return M


def jacobi_inv_diag_split(A, b, c, P=None):
    """Jacobi preconditioner diag((I+Q)ᵀ(I+Q))⁻¹ as split (x, y, τ) parts,
    from A's squared products (an operator) or its squares (a tensor)."""
    m, n = local_shape(A)
    if hasattr(A, "sq_rmv"):
        col_a = A.sq_rmv(torch.ones(m, dtype=A.dtype, device=A.device))
        row_a = A.sq_mv(torch.ones(n, dtype=A.dtype, device=A.device))
    else:
        col_a = torch.sum(A * A, dim=0)
        row_a = torch.sum(A * A, dim=1)
    dx = 1.0 + col_a + c * c
    if P is not None:
        dx = dx + part(A, "n", 2.0 * torch.diagonal(P) + torch.sum(P * P, dim=0))
    dy = 1.0 + row_a + b * b
    cc, bb = _dots(A, c, c, b, b)
    dtau = 1.0 + cc + bb
    return (1.0 / torch.clamp(dx, min=1e-8), 1.0 / torch.clamp(dy, min=1e-8),
            1.0 / torch.clamp(dtau, min=1e-8))


def jacobi_inv_diag(A, b, c, P=None):
    """Packed form of the Jacobi preconditioner."""
    dx, dy, dtau = jacobi_inv_diag_split(A, b, c, P)
    return torch.cat([dx, dy, dtau[None]])


# Split (x, y, τ) tuple arithmetic for the CG; τ is a 0-d tensor.

def _t_add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _t_sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _t_scale(s, a):
    return tuple(s * x for x in a)


def _t_mul(a, b):
    return tuple(x * y for x, y in zip(a, b))


def _t_sums(terms, A=None):
    """Totals over split (x, y, τ) tuples: each term ``("dot", a, b)`` or
    ``("sum2", a)``; the x and y parts of all terms sum across the shards of
    a sharded ``A`` in one ``reduce`` per side."""
    def side(i):
        return [("dot", t[1][i], t[2][i]) if t[0] == "dot" else ("sum2", t[1][i])
                for t in terms]

    xs = side_sums(A, "n", side(0))
    ys = side_sums(A, "m", side(1))
    return [xs[i] + ys[i] + (t[1][2] * t[2][2] if t[0] == "dot" else torch.sum(t[1][2] * t[1][2]))
            for i, t in enumerate(terms)]


def _t_vdot(a, b, A=None):
    return _t_sums([("dot", a, b)], A)[0]


def _t_norm(a, A=None):
    return torch.sqrt(_t_sums([("sum2", a)], A)[0])


def cg_solve_normal_split(q, qt, inv_diag, u, x0, tol, max_iter: int, A=None):
    """PCG on (I+Q)ᵀ(I+Q) w = (I+Q)ᵀ u, every vector a split (x, y, τ)
    tuple; ``A``, a sharded operator, sums the split side's parts.  pᵀAp
    is taken as ‖(I+Q)p‖², on a row-sharded A in the product's all-reduce.
    ``cg_solve_normal_split.iterations`` counts the iterations the solves
    needed, ``.steps`` those they ran (``run_frozen``)."""
    def normal(v):
        t = _t_add(v, q(*v))
        return _t_add(t, qt(*t))

    rhs = _t_add(u, qt(*u))
    r = _t_sub(rhs, normal(x0))
    z = _t_mul(r, inv_diag)
    rhs_norm = _t_norm(rhs, A)
    tiny = torch.full_like(rhs_norm, 1e-20)

    def body(st):
        p, rz = st["p"], st["rz"]
        # pᵀ(I+Q)ᵀ(I+Q)p = ‖t‖², t = (I+Q)p: on a row-sharded A its partial
        # rides in Qᵀt's all-reduce.
        t = _t_add(p, q(*p))
        *qt_t, pAp = qt(*t, sq=True)
        Ap = _t_add(t, tuple(qt_t))
        alpha = rz / torch.where(torch.abs(pAp) <= 1e-20, tiny, pAp)
        x = _t_add(st["x"], _t_scale(alpha, p))
        r = _t_sub(st["r"], _t_scale(alpha, Ap))
        z = _t_mul(r, inv_diag)
        rz_new, r2 = _t_sums([("dot", r, z), ("sum2", r)], A)
        return {"x": x, "r": r, "p": _t_add(z, _t_scale(rz_new / rz, p)), "rz": rz_new,
                "k": st["k"] + 1, "done": torch.sqrt(r2) <= tol * rhs_norm}

    st = {"x": tuple(x0), "r": r, "p": z, "rz": _t_vdot(r, z, A),
          "k": torch.zeros((), dtype=torch.int32, device=rhs_norm.device),
          "done": rhs_norm == 0}
    if max_iter > 0:
        st = run_frozen(body, st, max_iter, CHECK_EVERY, cg_solve_normal_split)
    return st["x"]


cg_solve_normal_split.iterations = 0
cg_solve_normal_split.steps = 0


def pcg_psd(matvec, inv_diag, rhs, x0, tol, max_iter: int):
    """Jacobi-preconditioned CG on an SPD system, as the matrix-free polish
    uses it (A'DA + δI applied as two A-passes): stops at ‖r‖ ≤ tol·‖rhs‖,
    at a non-positive curvature, or at the budget, whose truncated answer
    the polish's acceptance test judges."""
    rhs_norm = torch.linalg.vector_norm(rhs)
    stop = tol * rhs_norm
    r0 = rhs - matvec(x0)
    z0 = inv_diag * r0
    one = torch.ones_like(rhs_norm)

    def body(st):
        p, rz = st["p"], st["rz"]
        Ap = matvec(p)
        denom = torch.dot(p, Ap)
        pos = denom > 0
        alpha = torch.where(pos, rz / torch.where(pos, denom, one), torch.zeros_like(rz))
        x = st["x"] + alpha * p
        r = st["r"] - alpha * Ap
        z = inv_diag * r
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.where(rz > 0, rz, one)
        return {"x": x, "r": r, "p": z + beta * p, "rz": rz_new, "k": st["k"] + 1,
                "done": (torch.linalg.vector_norm(r) <= stop) | (denom <= 0)}

    st = {"x": x0, "r": r0, "p": z0, "rz": torch.dot(r0, z0),
          "k": torch.zeros((), dtype=torch.int32, device=rhs.device), "done": rhs_norm == 0}
    st = run_frozen(body, st, max_iter, CHECK_EVERY, pcg_psd)
    return st["x"]


pcg_psd.iterations = 0
pcg_psd.steps = 0


def polish_plan(Ky: ConeSet, m: int, n: int, polish: bool, sparse: bool = False,
                itemsize: int = 8):
    """(start, every, steps, mode) of the interior-point polish ``hsde_solve``
    runs on this problem, or None.  It runs with polish on, only Zero /
    NonNeg / NonPos cones and m ≥ n: ``"chol"`` (dense Newton solves) within
    the standard caps, or on the XL cadence within the XL caps, where A is
    dense or a sparse A's dense form fits ``K_POLISH_DENSIFY_BYTES``;
    ``"cg"`` (matrix-free) beyond, on inequality-only LPs within the CG caps."""
    if not (polish and Ky.is_separable_only and m >= n):
        return None
    dense_ok = not sparse or m * n * itemsize <= K_POLISH_DENSIFY_BYTES
    if dense_ok and m <= K_POLISH_MAX_M and n <= K_POLISH_MAX_N:
        return K_POLISH_START, K_POLISH_EVERY, K_POLISH_IPM_STEPS, "chol"
    if dense_ok and m <= K_POLISH_XL_MAX_M and n <= K_POLISH_XL_MAX_N:
        return K_POLISH_XL_EVERY, K_POLISH_XL_EVERY, K_POLISH_XL_STEPS, "chol"
    z_m, _, _ = Ky.separable_masks()
    if not z_m.any() and m <= K_POLISH_CG_MAX_M and n <= K_POLISH_CG_MAX_N:
        return K_POLISH_CG_EVERY, K_POLISH_CG_EVERY, K_POLISH_CG_STEPS, "cg"
    return None


def _make_polish(A, b, c, Ky, Ky_dual, plan, abs_tol, rel_tol, sqm, sqn, b_norm, c_norm):
    """The polish burst: from the DR point (x_s, y_s, s_s), ``steps`` damped
    Mehrotra predictor–corrector steps on the LP in the sign-flipped space
    where every inequality row is NonNeg (Zero rows carry a large barrier
    weight, free rows weight 0).  The Newton systems AᵀDA + δI are solved by
    Cholesky (``"chol"``; a sparse A densified here, once) or by Jacobi-PCG
    through A's products (``"cg"``).  Returns (ok, x, y, r_pri, r_dua, gap)."""
    m, n = A.shape
    dt, dev = A.dtype, A.device
    amv, armv = matvecs(A)
    _, _, steps, mode = plan
    z_m, nn_m, np_m = Ky.separable_masks()
    p_zero = torch.as_tensor(z_m, device=dev)
    p_ineq = torch.as_tensor(nn_m | np_m, device=dev)
    p_sgn = torch.where(torch.as_tensor(np_m, device=dev),
                        torch.tensor(-1.0, dtype=dt, device=dev),
                        torch.tensor(1.0, dtype=dt, device=dev))
    p_delta = 1e-7 if dt == torch.float32 else 1e-13
    tiny = 1e-30
    sparse = getattr(A, "is_sparse", False)
    if mode == "cg" and sparse:
        Af_op = A.scale(p_sgn, torch.ones(n, dtype=dt, device=dev))
        af_mv, af_rmv, af_sq_rmv = Af_op.mv, Af_op.rmv, Af_op.sq_rmv
    else:
        # A sparse A is densified here, once, for the Cholesky burst.
        Af = (A.to_dense() if sparse else _dense(A)) * p_sgn[:, None]
        af_mv, af_rmv = matvecs(Af)

        def af_sq_rmv(Dv):
            return torch.einsum("i,ij,ij->j", Dv, Af, Af)
    zero_m = torch.zeros(m, dtype=dt, device=dev)
    one_m = torch.ones(m, dtype=dt, device=dev)
    m_i = max(float((nn_m | np_m).sum()), 1.0)

    def normal_solver(D):
        """rhs, dx0 → the Newton step dx of (AᵀDA + δI) dx = rhs."""
        if mode == "chol":
            Lm, info = torch.linalg.cholesky_ex(
                Af.T @ (D[:, None] * Af) + p_delta * torch.eye(n, dtype=dt, device=dev))
            # A failed factorisation gives NaN, as in the JAX package, and the
            # burst's acceptance test rejects it.
            Lm = torch.where(info == 0, Lm, torch.full_like(Lm, float("nan")))
            return lambda rhs, dx0: torch.cholesky_solve(rhs[:, None], Lm)[:, 0]
        inv_jac = 1.0 / torch.clamp(af_sq_rmv(D) + p_delta, min=tiny)

        def nmv(v):
            return af_rmv(D * af_mv(v)) + p_delta * v

        return lambda rhs, dx0: pcg_psd(nmv, inv_jac, rhs, dx0, 1e-10, K_POLISH_CG_ITERS)

    def ipm_step(x, y, s):
        mu = torch.dot(torch.where(p_ineq, s, zero_m), torch.where(p_ineq, y, zero_m)) / m_i
        y_safe = torch.where(p_ineq, y, one_m)
        s_safe = torch.where(p_ineq, torch.clamp(s, min=tiny), one_m)
        D_i = torch.where(p_ineq, y_safe / s_safe, zero_m)
        DZ = torch.clamp(1e4 * torch.max(D_i), min=1e8)
        D = torch.where(p_zero, DZ, D_i)
        solve_normal = normal_solver(D)
        r_p = af_mv(x) + s - p_sgn * b
        r_d = af_rmv(y) + c

        def newton(sigma_mu, dx0):
            r_c = torch.where(p_ineq, s * y - sigma_mu, zero_m)
            rc_y = torch.where(p_ineq, r_c / y_safe, zero_m)
            rhs = -r_d - af_rmv(D * (r_p - rc_y))
            dx = solve_normal(rhs, dx0)
            dy = D * (af_mv(dx) + r_p - rc_y)
            ds = torch.where(p_ineq, (-r_c - s * dy) / y_safe, zero_m)
            return dx, dy, ds

        def amax(v, dv):
            neg = dv < 0
            r = torch.where(p_ineq & neg, -v / torch.where(neg, dv, -one_m),
                            torch.full_like(v, float("inf")))
            return torch.clamp(0.995 * torch.min(r), max=1.0)

        dx, dy, ds = newton(torch.zeros((), dtype=dt, device=dev),
                            torch.zeros(n, dtype=dt, device=dev))
        ap, ad = amax(s, ds), amax(y, dy)
        mu_aff = torch.dot(torch.where(p_ineq, s + ap * ds, zero_m),
                           torch.where(p_ineq, y + ad * dy, zero_m)) / m_i
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=tiny)) ** 3, 0.0, 1.0)
        # The corrector's CG starts from the predictor's step.
        dx, dy, ds = newton(sigma * mu, dx)
        ap, ad = amax(s, ds), amax(y, dy)
        return x + ap * dx, y + ad * dy, s + ap * ds

    def burst(x_s, y_s, s_s):
        eps0 = 1e-6 * (1.0 + b_norm)
        x = x_s
        s = torch.where(p_ineq, torch.maximum(p_sgn * s_s, eps0), zero_m)
        y = torch.where(p_ineq, torch.maximum(p_sgn * y_s, eps0),
                        torch.where(p_zero, p_sgn * y_s, zero_m))
        for _ in range(steps):
            x, y, s = ipm_step(x, y, s)
        x_p, y_p = x, p_sgn * y
        s_p = b - amv(x_p)
        r_pri = _nrm(s_p - Ky.project(s_p))
        aty = armv(y_p)
        r_dua = _nrm(aty + c)
        y_cone = _nrm(y_p - Ky_dual.project(y_p))
        cx, by = torch.dot(c, x_p), torch.dot(b, y_p)
        gap = torch.abs(cx + by)
        eps_pri = sqm * abs_tol + rel_tol * torch.maximum(b_norm, _nrm(s_p))
        eps_dua = sqn * abs_tol + rel_tol * torch.maximum(_nrm(aty), c_norm)
        eps_cone = sqm * abs_tol + rel_tol * torch.clamp(_nrm(y_p), min=1.0)
        eps_gap = abs_tol + rel_tol * torch.maximum(
            torch.clamp(gap, min=1.0), torch.maximum(torch.abs(cx), torch.abs(by)))
        ok = ((r_pri <= eps_pri) & (r_dua <= eps_dua) & (y_cone <= eps_cone)
              & (gap <= eps_gap) & torch.all(torch.isfinite(x_p))
              & torch.all(torch.isfinite(y_p)))
        return ok, x_p, y_p, r_pri, r_dua, gap

    return burst


def hsde_solve(
    A,
    b,
    c,
    Ky: ConeSet,
    P=None,
    strategy: str = "smw",
    abs_tol: float = 1e-4,
    rel_tol: float = 1e-3,
    max_iter: int = 2500,
    smw_factor: Optional[dict] = None,
    use_anderson: bool = False,
    anderson_mem: int = 5,
    anderson_start: int = 10,
    u0=None,
    polish: bool = False,
):
    """Run the HSDE DR iteration on the *scaled* problem; ``P`` is None or
    a dense (n, n) PSD matrix of the scaled problem.

    Returns a dict: ``w`` and ``u`` (packed [x; y; τ]), ``status``,
    ``final_iter``, ``fp_resid``, ``r_pri``, ``r_dua`` and ``gap``, as the
    JAX function.  Unscaling happens in the caller.
    """
    m, n = A.shape
    m_loc, n_loc = local_shape(A)
    dt, dev = A.dtype, A.device
    dim = n + m + 1
    amv, armv = matvecs(A)
    sharded = is_sharded(A)
    Ky_whole = getattr(Ky, "whole", Ky)
    Ky = shard_cones(Ky, A)
    Ky_dual = Ky.dual()
    b = torch.as_tensor(b, dtype=dt, device=dev)
    c = torch.as_tensor(c, dtype=dt, device=dev)
    if P is not None:
        P = torch.as_tensor(P, dtype=dt, device=dev)
    pmv = p_apply(A, P)

    def T(v):
        return torch.as_tensor(v, dtype=dt, device=dev)

    if strategy == "smw":
        factor = smw_factor if smw_factor is not None else smw_setup(A, b, c, P)

        def lin_solve(ux, uy, ut, fp_resid):
            return _smw_solve_split(factor, A, b, c, ux, uy, ut)
    elif strategy in ("direct", "inverse"):
        if sharded:
            raise ValueError(f"the {strategy!r} strategy takes no sharded A; use 'smw' or 'cg'")
        # Cholesky of G = MᵀM + δI, then two refinement steps against the
        # unregularized MᵀM.
        M = dense_q(A, b, c, P)
        delta = (1e-6 if dt == torch.float32 else 1e-12) * dim
        L = torch.linalg.cholesky(M.T @ M + delta * torch.eye(dim, dtype=dt, device=dev))

        def solve_G(r):
            return torch.cholesky_solve(r[:, None], L)[:, 0]

        def lin_solve(ux, uy, ut, fp_resid):
            rhs = torch.mv(M.T, torch.cat([ux, uy, ut[None]]))
            w = solve_G(rhs)
            for _ in range(2):
                w = w + solve_G(rhs - torch.mv(M.T, torch.mv(M, w)))
            return w[:n], w[n:n + m], w[n + m]
    elif strategy == "cg":
        q_split, qt_split = _q_apply_split(A, b, c, P)
        inv_diag = jacobi_inv_diag_split(A, b, c, P)
        cg_max = min(20000, 20 * dim)

        def lin_solve(ux, uy, ut, fp_resid):
            # CG stops at ‖r‖ ≤ tol·‖rhs‖, and the solution's error is about
            # cond(MᵀM)·tol: with a proportional tolerance alone the DR
            # residual stalls at that level.  One refinement pass squares the
            # accuracy (cond·tol²), which restores the contraction.
            u = (ux, uy, ut)
            tol = torch.clamp(0.1 * fp_resid / torch.clamp(_t_norm(u, A), min=1.0), 1e-12, 1e-2)
            w = cg_solve_normal_split(q_split, qt_split, inv_diag, u, u, tol, cg_max, A)
            r = _t_sub(u, _t_add(w, q_split(*w)))
            zero = tuple(torch.zeros_like(x) for x in u)
            dw = cg_solve_normal_split(q_split, qt_split, inv_diag, r, zero, tol, cg_max, A)
            return _t_add(w, dw)
    else:
        raise ValueError(f"unknown HSDE strategy {strategy!r}")

    b_norm, = side_sums(A, "m", [("norm", b)])
    c_norm, = side_sums(A, "n", [("norm", c)])
    sqm = torch.sqrt(T(m))
    sqn = torch.sqrt(T(n))
    abs_t = T(abs_tol)
    rel_t = T(rel_tol)
    one = T(1.0)
    fp_tol = abs_t * torch.sqrt(T(dim)) + rel_t
    cert_tol = abs_t + rel_t
    eps_d = T(1e-12)

    plan = None if P is not None else polish_plan(
        Ky_whole, m, n, polish, sparse=bool(getattr(A, "is_sparse", False)),
        itemsize=b.element_size())
    burst = None
    if plan is not None and sharded:
        # The polish runs whole on every rank: A gathered once, the point
        # gathered at each burst, each rank keeping its part of the result.
        whole_burst = _make_polish(
            A.gather_op(), whole(A, "m", b), whole(A, "n", c), Ky_whole, Ky_whole.dual(),
            plan, abs_t, rel_t, sqm, sqn, b_norm, c_norm)

        def burst(x_s, y_s, s_s):
            ok, x_p, y_p, *rest = whole_burst(whole(A, "n", x_s), whole(A, "m", y_s),
                                              whole(A, "m", s_s))
            return (ok, part(A, "n", x_p), part(A, "m", y_p), *rest)
    elif plan is not None:
        burst = _make_polish(A, b, c, Ky, Ky_dual, plan, abs_t, rel_t, sqm, sqn,
                             b_norm, c_norm)

    def check(st, it):
        """The residual / certificate test; both τ branches, selected."""
        wx, wy, wt = st["wx"], st["wy"], st["wt"]
        # The sums of the ray w, one stacked partial sum per side.
        ax_w = -amv(wx)
        aty_w = armv(wy)
        wx2, cwx, aty_norm = side_sums(A, "n", [("sum2", wx), ("dot", c, wx),
                                                ("norm", aty_w)])
        wy2, bwy, ax_dist, y_cone = side_sums(A, "m", [
            ("sum2", wy), ("dot", b, wy), ("norm", ax_w - Ky.project(ax_w)),
            ("norm", wy - Ky_dual.project(wy))])
        w_norm = torch.sqrt(wx2 + wy2 + wt * wt)
        tau_ok = wt > torch.clamp(K_TAU_REL * w_norm, min=K_TAU_TOL)
        tau = torch.where(tau_ok, wt, one)

        # τ > 0: the primal, dual and gap test on (x, y) = w / τ.
        x_s, y_s = wx / tau, wy / tau
        s_s = b - amv(x_s)
        aty = armv(y_s)
        px = None
        if P is not None:
            px = pmv(x_s)
            aty = aty + px
        x_terms = [("dot", c, x_s), ("norm", aty + c), ("norm", aty)]
        if P is not None:
            x_terms.append(("dot", x_s, px))
        c_dot_x, r_dua, aty_nrm, *xp = side_sums(A, "n", x_terms)
        if P is not None:
            c_dot_x = c_dot_x + xp[0]
        r_pri, s_norm, r_dua_cone, y_nrm, b_dot_y = side_sums(A, "m", [
            ("norm", s_s - Ky.project(s_s)), ("norm", s_s),
            ("norm", y_s - Ky_dual.project(y_s)), ("norm", y_s), ("dot", b, y_s)])
        eps_pri = sqm * abs_t + rel_t * torch.maximum(b_norm, s_norm)
        eps_dua = sqn * abs_t + rel_t * torch.maximum(aty_nrm, c_norm)
        eps_cone = sqm * abs_t + rel_t * torch.clamp(y_nrm, min=1.0)
        gap = torch.abs(c_dot_x + b_dot_y)
        # Scale-invariant gap test (the JAX package's deviation from the
        # reference): relative to max(1, gap, |c'x|, |b'y|).
        eps_gap = abs_t + rel_t * torch.maximum(
            torch.clamp(gap, min=1.0), torch.maximum(torch.abs(c_dot_x), torch.abs(b_dot_y)))
        curr = r_pri + r_dua + r_dua_cone + gap
        alpha_pos = torch.where(curr <= st["prev_resid"] * 0.99,
                                torch.clamp(st["alpha"] * K_ALPHA_GROW, max=K_ALPHA_MAX),
                                T(K_ALPHA_MIN))
        converged = ((r_pri <= eps_pri) & (r_dua <= eps_dua)
                     & (r_dua_cone <= eps_cone) & (gap <= eps_gap))
        wx_pos, wy_pos = wx, wy
        r_o, d_o, g_o = r_pri, r_dua, gap
        if burst is not None:
            start, every, _, _ = plan
            if it >= start and it % every == 0 and bool(tau_ok & ~converged & ~st["done"]):
                ok_p, x_p, y_p, r_pp, r_dp, g_p = burst(x_s, y_s, s_s)
                wx_pos = torch.where(ok_p, x_p * tau, wx)
                wy_pos = torch.where(ok_p, y_p * tau, wy)
                r_o = torch.where(ok_p, r_pp, r_o)
                d_o = torch.where(ok_p, r_dp, d_o)
                g_o = torch.where(ok_p, g_p, g_o)
                converged = converged | ok_p

        # τ ≈ 0: the certificates of the ray w.  Unboundedness needs −A x̂ in
        # the recession cone of K_y (ax_dist).
        kappa = -cwx - bwy
        firm = (kappa > K_KAPPA_TOL) & (st["fp_resid"] <= fp_tol)
        b_neg = -bwy
        c_neg = -cwx
        infeas_sup = firm & (b_neg > cert_tol) & (aty_norm <= cert_tol * b_neg) \
            & (y_cone <= cert_tol * b_neg)
        unbdd_sup = firm & (c_neg > cert_tol) & (ax_dist <= cert_tol * c_neg)
        if P is not None:
            # The ray must also lie in P's null space.
            p_wx, = side_sums(A, "n", [("norm", pmv(wx))])
            unbdd_sup = unbdd_sup & (p_wx <= cert_tol * c_neg)
        # Dominance: each Farkas product over the joint ray norm and its
        # own data norm; the competing one must be K_CERT_CROSS x weaker,
        # and if both hold the dominant one wins.
        joint = torch.sqrt(wx2 + wy2) + eps_d
        beta = b_neg / (joint * torch.maximum(b_norm, eps_d))
        gamma = c_neg / (joint * torch.maximum(c_norm, eps_d))
        both = infeas_sup & unbdd_sup
        infeas = infeas_sup & ((gamma <= K_CERT_CROSS * beta) | (both & (beta >= gamma)))
        unbdd = unbdd_sup & ~infeas & ((beta <= K_CERT_CROSS * gamma) | (both & (gamma > beta)))
        fired = torch.where(infeas, 1, torch.where(unbdd, 2, 0)).to(torch.int32)
        # A certificate latches only when the same one fires on two
        # consecutive checks with the residual tightened past the threshold.
        confirm = (fired > 0) & (fired == st["cert_pending"]) \
            & (st["fp_resid"] <= K_CERT_CONFIRM * fp_tol)
        status_0 = torch.where(confirm & infeas, Status.INFEASIBLE.value,
                               torch.where(confirm & unbdd, Status.UNBOUNDED.value,
                                           st["status"]))
        status_pos = torch.where(converged, Status.SUCCESS.value, st["status"])

        def pick(pos, zero):
            return torch.where(tau_ok, pos, zero)

        return {
            **st,
            "alpha": pick(alpha_pos, st["alpha"]),
            "prev_resid": pick(curr, st["prev_resid"]),
            "done": st["done"] | pick(converged, confirm),
            "status": pick(status_pos, status_0).to(torch.int32),
            "r_pri": pick(r_o, st["r_pri"]),
            "r_dua": pick(d_o, st["r_dua"]),
            "gap": pick(g_o, st["gap"]),
            "cert_pending": pick(torch.zeros_like(fired), fired),
            "wx": pick(wx_pos, wx),
            "wy": pick(wy_pos, wy),
        }

    def body(st, it):
        wx, wy, wt = lin_solve(st["ux"], st["uy"], st["ut"], st["fp_resid"])
        vx, vy, vt = 2.0 * wx - st["ux"], 2.0 * wy - st["uy"], 2.0 * wt - st["ut"]
        # Project: x free, y onto K_y*, τ onto R_+.
        zy = Ky_dual.project(vy)
        zt = torch.clamp(vt, min=0.0)
        ux = st["ux"] + st["alpha"] * (vx - wx)
        uy = st["uy"] + st["alpha"] * (zy - wy)
        ut = st["ut"] + st["alpha"] * (zt - wt)
        fx, = side_sums(A, "n", [("sum2", vx - wx)])
        fy, = side_sums(A, "m", [("sum2", zy - wy)])
        fp = torch.sqrt(fx + fy + (zt - wt) ** 2)
        new = dict(st)
        if use_anderson:
            # Type-II Anderson on the DR map, its history reset whenever the
            # fixed-point residual grows.
            u_acc, aa = anderson_step(st["aa"], torch.cat([st["ux"], st["uy"], st["ut"][None]]),
                                      torch.cat([ux, uy, ut[None]]), split=aa_split)
            grew = fp > st["fp_resid"]
            aa = aa._replace(k=torch.where(grew, torch.zeros_like(aa.k), aa.k))
            take = (st["k"] >= anderson_start) & ~grew
            ux = torch.where(take, u_acc[:n_loc], ux)
            uy = torch.where(take, u_acc[n_loc:n_loc + m_loc], uy)
            ut = torch.where(take, u_acc[n_loc + m_loc], ut)
            new["aa"] = aa
        new.update(ux=ux, uy=uy, ut=ut, wx=wx, wy=wy, wt=wt, fp_resid=fp)
        if it % K_CHECK_EVERY == 0 or it >= max_iter - 1:
            new = check(new, it)
        done = new["done"] | (new["k"] >= max_iter - 1) | ~torch.isfinite(fp)
        new["k"] = torch.where(new["done"], new["k"], new["k"] + 1)
        new["done"] = done
        return new

    aa_split = None
    if use_anderson and sharded:
        on_m = torch.zeros(n_loc + m_loc + 1, dtype=torch.bool, device=dev)
        on_m[n_loc:n_loc + m_loc] = True
        on_n = torch.zeros_like(on_m)
        on_n[:n_loc] = True
        aa_split = (on_m if A.sharded_side == "m" else on_n, A.reduce)
    if u0 is None:
        ux0 = torch.zeros(n_loc, dtype=dt, device=dev)
        uy0 = torch.zeros(m_loc, dtype=dt, device=dev)
        ut0 = T(1.0)
    else:
        u0 = T(u0)
        ux0, uy0, ut0 = u0[:n_loc], u0[n_loc:n_loc + m_loc], u0[n_loc + m_loc]
    zero = T(0.0)
    st = {
        "ux": ux0, "uy": uy0, "ut": ut0,
        "wx": torch.zeros(n_loc, dtype=dt, device=dev),
        "wy": torch.zeros(m_loc, dtype=dt, device=dev), "wt": zero,
        "alpha": T(K_ALPHA_MIN), "fp_resid": T(1.0),
        "prev_resid": T(torch.finfo(dt).max),
        "k": torch.zeros((), dtype=torch.int32, device=dev),
        "done": torch.zeros((), dtype=torch.bool, device=dev),
        "status": torch.tensor(Status.MAX_ITER.value, dtype=torch.int32, device=dev),
        "r_pri": zero, "r_dua": zero, "gap": zero,
        "cert_pending": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if use_anderson:
        st["aa"] = anderson_init(n_loc + m_loc + 1, anderson_mem, dt, dev)

    for it in range(max_iter):
        new = body(st, it)
        was_done = st["done"]
        st = {key: (val if key == "aa" else torch.where(was_done, st[key], val))
              for key, val in new.items()}
        if (it % K_CHECK_EVERY == 0 or it >= max_iter - 1) and bool(st["done"]):
            break

    return {
        "w": torch.cat([st["wx"], st["wy"], st["wt"][None]]),
        "u": torch.cat([st["ux"], st["uy"], st["ut"][None]]),
        "status": st["status"],
        "final_iter": st["k"],
        "fp_resid": st["fp_resid"],
        "r_pri": st["r_pri"],
        "r_dua": st["r_dua"],
        "gap": st["gap"],
    }
