"""Batched Euclidean projections onto cones.

Counterpart of ``pogs_tpu/cones/projections.py``.  All cones of one type
and size are stacked into one (K, L) tensor and projected together: one
masked-norm pass for the SOC blocks, one batched ``torch.linalg.eigh`` for
the SDP blocks, one fixed-iteration bisection for the exponential cones.

The exponential-cone projection is the JAX package's algorithm step for
step — the 65-point sign scan on each side of the pole, the first three
sign-change brackets per side, 50 (primal) or 80 (dual) bisection steps, and
the closest valid candidate in the order (v, ray, 0, the six roots) with
argmin's first-minimum rule — because the CUDA cone kernel
(``csrc/fused_hsde.cu``) repeats it and this module is its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

E1 = 2.718281828459045  # e
# The unique pole of e^{2u} + u, and the grid's size and kept brackets.
U_POLE = -0.4263027510068963
N_GRID = 65
N_KEEP = 3


def project_soc(v):
    """Project rows of v = (p, x) onto the second-order cone ‖x‖ ≤ p.

    v: (..., L); element 0 is the head p.  Closed form: ‖x‖ ≤ −p → 0;
    ‖x‖ ≤ |p| → v; else head (‖x‖ + p)/2 and the tail scaled by
    (1 + p/‖x‖)/2.
    """
    p = v[..., :1]
    x = v[..., 1:]
    nrm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    tiny = torch.finfo(v.dtype).tiny
    scale = 0.5 * (1.0 + p / torch.clamp(nrm, min=tiny))
    zero = torch.zeros_like(p)
    one = torch.ones_like(p)
    general = nrm >= torch.abs(p)
    polar = nrm <= -p
    head = torch.where(polar, zero, torch.where(general, scale * nrm, p))
    tail_scale = torch.where(polar, zero, torch.where(general, scale, one))
    return torch.cat([head, x * tail_scale], dim=-1)


def _packed_indices(nmat: int):
    """Column-major lower-triangle packing: for 3x3, [a11, a21, a31, a22, a32, a33]."""
    rows, cols = [], []
    for col in range(nmat):
        for row in range(col, nmat):
            rows.append(row)
            cols.append(col)
    return np.asarray(rows), np.asarray(cols)


def project_sdp_packed(v, nmat: int, scaled: bool = False):
    """Project packed lower-triangular symmetric matrices onto the PSD cone.

    v: (K, L), L = nmat(nmat+1)/2.  Batched eigendecomposition, eigenvalues
    clamped at 0, reconstruction.  ``scaled=True`` is the svec convention
    (off-diagonal entries carry √2), in which the clamp is the Euclidean
    projection of the packed vector; ``scaled=False`` packs unscaled.
    """
    K, L = v.shape
    if L != nmat * (nmat + 1) // 2:
        raise ValueError("packed size mismatch")
    rows, cols = _packed_indices(nmat)
    r_idx = torch.as_tensor(rows, device=v.device)
    c_idx = torch.as_tensor(cols, device=v.device)
    off = torch.as_tensor(rows != cols, dtype=v.dtype, device=v.device)
    vmat = v * (1.0 + off * (np.sqrt(0.5) - 1.0)) if scaled else v
    X = torch.zeros((K, nmat, nmat), dtype=v.dtype, device=v.device)
    X[:, r_idx, c_idx] = vmat
    X[:, c_idx, r_idx] = vmat
    w, V = torch.linalg.eigh(X)
    w = torch.clamp(w, min=0.0)
    Xp = torch.einsum("kil,kl,kjl->kij", V, w, V)
    out = Xp[:, r_idx, c_idx]
    if scaled:
        out = out * (1.0 + off * (np.sqrt(2.0) - 1.0))
    return out


def _exp_constants(dtype):
    """(tol, U, eps) of the exponential-cone projection for a dtype."""
    if dtype == torch.float32:
        return 1e-6, 22.0, 1e-6
    return 1e-8, 50.0, 1e-9


def exp_grid(dtype) -> torch.Tensor:
    """The (2, N_GRID) scan points of the two branches, [−U, pole − eps]
    and [pole + eps, U], on the CPU.  The kernel takes the same table."""
    _, U, eps = _exp_constants(dtype)
    return torch.stack([
        torch.linspace(-U, U_POLE - eps, N_GRID, dtype=dtype),
        torch.linspace(U_POLE + eps, U, N_GRID, dtype=dtype),
    ])


def _sign(x):
    """jnp.sign: 0 at 0 and NaN at NaN (torch.sign gives 0 at NaN)."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def _project_exp_primal_impl(v, bisect_iters: int = 50):
    """Project rows v = (r, s, t) onto cl K_exp = {s > 0, s e^{r/s} ≤ t}
    ∪ {r ≤ 0, s = 0, t ≥ 0}.

    The KKT conditions reduce to a root of F(u) (u = x*/y*), whose sign is
    sign(G(u))·sign(e^{2u} + u) with the cancellation-free
        G(u) = e^{2u}(s − r(1−u)) + u(s + t e^u(1−u)) − t e^u − r.
    Each side of the pole is scanned on a fixed grid, the first N_KEEP
    sign-change brackets are bisected, and the answer is the closest valid
    candidate among {v if in the cone, the ray point, 0, the boundary
    points of the roots}.
    """
    dt = v.dtype
    tol, U, _ = _exp_constants(dt)
    r, s, t = v[..., 0], v[..., 1], v[..., 2]

    def safe_exp(x):
        return torch.exp(torch.clamp(x, -3 * U, 3 * U))

    def sign_F(u):
        w = safe_exp(u)
        w2 = w * w
        G = w2 * (s - r * (1.0 - u)) + u * (s + t * w * (1.0 - u)) - t * w - r
        return _sign(G) * _sign(w2 + u)

    def bisect(lo, hi):
        slo = sign_F(lo)
        for _ in range(bisect_iters):
            mid = 0.5 * (lo + hi)
            go_right = sign_F(mid) == slo
            lo = torch.where(go_right, mid, lo)
            hi = torch.where(go_right, hi, mid)
        return 0.5 * (lo + hi)

    grid = exp_grid(dt).to(v.device)
    los, his, hases = [], [], []
    for us in grid:  # the two branches
        sg = sign_F(us.reshape((N_GRID,) + (1,) * r.ndim))
        flip = sg[:-1] * sg[1:] <= 0
        rank = torch.cumsum(flip.to(torch.int32), dim=0)
        for j in range(1, N_KEEP + 1):
            sel = flip & (rank == j)
            idx = torch.argmax(sel.to(torch.int32), dim=0)
            los.append(us[idx])
            his.append(us[idx + 1])
            hases.append(torch.any(sel, dim=0))
    # Every bracket bisects at once; each element's steps are its own.
    roots = bisect(torch.stack(los), torch.stack(his))

    def gen_candidate(u, bracketed):
        # z* = w (r + t w)/(w² + u), y* = z*/w, x* = u y*, λ = z* − t.
        w = safe_exp(u)
        denom = w * w + u
        denom = torch.where(torch.abs(denom) < 1e-30,
                            torch.full_like(denom, 1e-30), denom)
        num = (r + t * w) / denom
        z_star = w * num
        feas = bracketed & (z_star > 0) & (z_star - t >= -tol * (1.0 + torch.abs(t)))
        return torch.stack([u * num, num, z_star], dim=-1), feas

    gens = [gen_candidate(roots[j], hases[j]) for j in range(2 * N_KEEP)]
    zero = torch.zeros_like(s)
    ray = torch.stack([torch.clamp(r, max=0.0), zero, torch.clamp(t, min=0.0)], dim=-1)
    spos = torch.clamp(s, min=torch.finfo(dt).tiny)
    v_in_cone = ((s > tol) & (spos * safe_exp(r / spos) <= t + tol)) | (
        (torch.abs(s) <= tol) & (r <= tol) & (t >= -tol))

    def dist2(c):
        return torch.sum((c - v) ** 2, dim=-1)

    INF = torch.finfo(dt).max
    cands = torch.stack([v, ray, torch.zeros_like(v)] + [g for g, _ in gens], dim=-2)
    d2 = torch.stack(
        [torch.where(v_in_cone, dist2(v), INF), dist2(ray), dist2(torch.zeros_like(v))]
        + [torch.where(feas, dist2(g), INF) for g, feas in gens],
        dim=-1,
    )
    best = torch.argmin(d2, dim=-1)  # the first minimum
    return torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]


def _exp_primal_tangent(v, p, dv):
    """Generalized-Jacobian action dΠ_K(v)[dv] at p = Π_K(v), case by case:

    1. v in the cone:            dΠ = I
    2. v in the polar cone:      dΠ = 0   (p = 0)
    3. p on the ray face
       {(x,0,z): x ≤ 0, z ≥ 0}: dΠ = diag(1{r<0}, 0, 1{t>0})
    4. p on the smooth boundary (y > 0, φ(p) = y e^{x/y} − z = 0,
       v − p = λ∇φ(p), λ > 0): implicit differentiation of the KKT
       system [p + λ∇φ(p) − v; φ(p)] = 0 in (p, λ), one batched 4×4 solve

           [[I + λ∇²φ, ∇φ], [∇φᵀ, 0]] [dp; dλ] = [dv; 0]

       with ∇φ = (w, w(1−u), −1), ∇²φ = (w/y)[[1,−u,0],[−u,u²,0],[0,0,0]],
       u = x/y, w = e^u.

    Case boundaries have measure zero; any choice there is an element of
    the generalized Jacobian.  Every case's matrix is symmetric (case 4 is
    the leading block of the inverse of a symmetric matrix), so the same
    map is also the vector-Jacobian product.
    """
    dt = v.dtype
    tol = 1e-5 if dt == torch.float32 else 1e-9
    r, t = v[..., 0], v[..., 2]
    y = p[..., 1]
    sc = 1.0 + torch.linalg.vector_norm(v, dim=-1)
    in_cone = torch.linalg.vector_norm(p - v, dim=-1) <= tol * sc
    in_polar = torch.linalg.vector_norm(p, dim=-1) <= tol * sc
    on_ray = y <= tol * sc
    generic = ~(in_cone | in_polar | on_ray)

    # Case 4, guarded where it does not apply.
    one = torch.ones_like(y)
    zero = torch.zeros_like(y)
    y_safe = torch.where(generic, torch.clamp(y, min=tol), one)
    u = torch.where(generic, p[..., 0], zero) / y_safe
    w = torch.exp(torch.clamp(u, -50.0, 50.0))
    g = torch.stack([w, w * (1.0 - u), -one], dim=-1)
    lam = torch.sum((v - p) * g, dim=-1) / torch.sum(g * g, dim=-1)
    lam = torch.where(generic, torch.clamp(lam, min=0.0), zero)
    coef = lam * w / y_safe
    M = torch.stack([
        torch.stack([1.0 + coef, -coef * u, zero, g[..., 0]], dim=-1),
        torch.stack([-coef * u, 1.0 + coef * u * u, zero, g[..., 1]], dim=-1),
        torch.stack([zero, zero, one, g[..., 2]], dim=-1),
        torch.cat([g, zero[..., None]], dim=-1),
    ], dim=-2)
    M = torch.where(generic[..., None, None], M, torch.eye(4, dtype=dt, device=v.device))
    rhs = torch.cat([dv, torch.zeros_like(dv[..., :1])], dim=-1)
    dp_gen = torch.linalg.solve(M, rhs[..., None])[..., :3, 0]

    dp_ray = torch.stack([
        torch.where(r < 0, dv[..., 0], torch.zeros_like(dv[..., 0])),
        torch.zeros_like(dv[..., 1]),
        torch.where(t > 0, dv[..., 2], torch.zeros_like(dv[..., 2])),
    ], dim=-1)
    return torch.where(
        in_cone[..., None], dv,
        torch.where(in_polar[..., None], torch.zeros_like(dv),
                    torch.where(on_ray[..., None], dp_ray, dp_gen)))


class _ProjectExpPrimal(torch.autograd.Function):
    """``_project_exp_primal_impl`` with the implicit derivative of
    ``_exp_primal_tangent`` in both modes: the bisection's own derivative is
    zero almost everywhere (its selects are piecewise constant)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(v, bisect_iters):
        return _project_exp_primal_impl(v, bisect_iters)

    @staticmethod
    def setup_context(ctx, inputs, output):
        v, _ = inputs
        ctx.save_for_backward(v, output)
        ctx.save_for_forward(v, output)

    @staticmethod
    def jvp(ctx, dv, _):
        v, p = ctx.saved_tensors
        return _exp_primal_tangent(v, p, dv)

    @staticmethod
    def backward(ctx, grad):
        v, p = ctx.saved_tensors
        return _exp_primal_tangent(v, p, grad), None


def project_exp_primal(v, bisect_iters: int = 50):
    """Projection onto the exponential cone (``_project_exp_primal_impl``),
    differentiable in forward and reverse mode (``torch.func.jacfwd`` and
    ``jacrev`` included) through the generalized Jacobian of
    ``_exp_primal_tangent``.  That Jacobian is symmetric, as the Jacobian of
    a projection onto a convex set is, so the vector-Jacobian product
    applies the same map."""
    return _ProjectExpPrimal.apply(v, bisect_iters)


def project_exp_dual(v, bisect_iters: int = 80):
    """Projection onto the dual exponential cone by Moreau decomposition:
    Π_{K*}(v) = v + Π_K(−v)."""
    return v + project_exp_primal(-v, bisect_iters)
