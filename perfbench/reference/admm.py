"""A plain graph-form ADMM: the benchmark's reference solver.

    minimize f(y) + g(x)  subject to  y = A x

by the splitting of Parikh and Boyd that POGS uses (Fougner and Boyd,
"Parameter selection and pre-conditioning for a graph form solver", 2015):
prox steps on f and g, over-relaxation α = 1.7, and the projection onto
{y = A x} through the explicit (I + AᵀA)⁻¹ (AAᵀ through Woodbury for a wide
A), with A scaled by its spectral norm and ρ balanced from the residuals.
Written from the paper in plain torch; it imports nothing of the program.

Every problem runs as K columns at once (the lanes of one matrix); each
column keeps its own ρ and stops on its own, and a stopped column's answer
is the one of the iteration at which it stopped.

``precision="tf32"`` computes every product with both operands rounded to
TF32 (10 mantissa bits, the tensor cores' inputs) and summed in float32:
the benchmark's control, the step below the float32 that the
configurations state.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable

import torch

SUCCESS, MAX_ITER = 0, 1
ALPHA = 1.7
CHECK_EVERY = 10
RHO_MIN, RHO_MAX = 1e-4, 1e4
BALANCE = 10.0


@contextlib.contextmanager
def exact_products():
    """float32 products in float32, TF32 off, restoring the caller's flags."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to nearest (ties to even) at TF32's 10 mantissa
    bits."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class Products:
    """A's products in one precision: "float64", "float32" or "tf32"."""

    def __init__(self, A: torch.Tensor, precision: str):
        if precision not in ("float64", "float32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.A = self.rounded(A.to(self.dtype))

    def rounded(self, t):
        return tf32_round(t) if self.precision == "tf32" else t

    def mm(self, M, X):
        with exact_products():
            return self.rounded(M) @ self.rounded(X)


@dataclass
class Result:
    x: torch.Tensor          # (n, K)
    y: torch.Tensor          # (m, K)
    status: torch.Tensor     # (K,) SUCCESS or MAX_ITER
    iterations: torch.Tensor  # (K,) executed iterations


def spectral_norm(pr: Products, iters: int = 50) -> float:
    """‖A‖₂ by power iteration on AᵀA from a fixed start."""
    n = pr.A.shape[1]
    v = torch.ones(n, 1, dtype=pr.dtype, device=pr.A.device) / math.sqrt(n)
    s = 0.0
    for _ in range(iters):
        w = pr.mm(pr.A.T, pr.mm(pr.A, v))
        s = float(w.norm())
        v = w / s
    return math.sqrt(s)


def graph_admm(A: torch.Tensor, prox_f: Callable, prox_g: Callable, K: int,
               abs_tol: float, rel_tol: float, max_iter: int,
               precision: str = "float64") -> Result:
    """Solve K graph-form problems on one A.

    ``prox_f(v, rho)`` and ``prox_g(v, rho)`` take (m, K) and (n, K) points
    and the (K,) ρ, and return the prox of each column's f and g in the
    original (unscaled) variables.  Stops a column where its primal and dual
    residuals fall below abs_tol·√dim + rel_tol·(norm), as POGS does."""
    pr = Products(A, precision)
    dt, dev = pr.dtype, pr.A.device
    m, n = pr.A.shape
    sigma = spectral_norm(pr)
    As = pr.rounded(pr.A / sigma)
    wide = m < n
    k = m if wide else n
    G = pr.mm(As, As.T) if wide else pr.mm(As.T, As)
    G = G + torch.eye(k, dtype=dt, device=dev)
    Ginv = torch.cholesky_inverse(torch.linalg.cholesky(G))

    def project(cx, cy):
        if wide:
            # x = c + Aᵀ(I + AAᵀ)⁻¹(d − A c)
            w = pr.mm(Ginv, cy - pr.mm(As, cx))
            x = cx + pr.mm(As.T, w)
        else:
            x = pr.mm(Ginv, cx + pr.mm(As.T, cy))
        return x, pr.mm(As, x)

    # The scaled variable y_s = y / σ: f_s(y_s) = f(σ y_s).
    def prox_fs(v, rho):
        return prox_f(sigma * v, rho / sigma ** 2) / sigma

    zeros = dict(dtype=dt, device=dev)
    x = torch.zeros(n, K, **zeros)
    y = torch.zeros(m, K, **zeros)
    xt, yt = torch.zeros_like(x), torch.zeros_like(y)
    rho = torch.ones(K, **zeros)
    out_x, out_y = torch.zeros_like(x), torch.zeros_like(y)
    done = torch.zeros(K, dtype=torch.bool, device=dev)
    iters = torch.full((K,), max_iter, dtype=torch.int64, device=dev)
    sq_m, sq_n = math.sqrt(m), math.sqrt(n)
    for it in range(max_iter):
        xin, yin = x - xt, y - yt
        x12 = prox_g(xin, rho)
        y12 = prox_fs(yin, rho)
        cx = ALPHA * x12 + (1 - ALPHA) * x + xt
        cy = ALPHA * y12 + (1 - ALPHA) * y + yt
        x_new, y_new = project(cx, cy)
        if (it + 1) % CHECK_EVERY == 0 or it == max_iter - 1:
            nrm_r = (pr.mm(As, x12) - y12).norm(dim=0)
            nrm_s = rho * torch.sqrt(((x_new - x) ** 2).sum(0) + ((y_new - y) ** 2).sum(0))
            eps_pri = abs_tol * sq_m + rel_tol * y12.norm(dim=0)
            eps_dua = rho * (abs_tol * sq_n + rel_tol * (xin - x12).norm(dim=0))
            fresh = (nrm_r < eps_pri) & (nrm_s < eps_dua) & ~done
            if bool(fresh.any()):
                out_x[:, fresh] = x12[:, fresh]
                out_y[:, fresh] = y12[:, fresh]
                iters[fresh] = it + 1
                done |= fresh
                if bool(done.all()):
                    break
            # Residual balancing: ρ up where the primal side lags, down where
            # the dual does; the scaled duals move inversely.
            ratio = (nrm_r / eps_pri) / (nrm_s / eps_dua).clamp(min=1e-30)
            scale = torch.where(ratio > BALANCE, 2.0, torch.where(ratio < 1 / BALANCE, 0.5, 1.0))
            scale = torch.where((rho * scale > RHO_MAX) | (rho * scale < RHO_MIN), 1.0, scale)
            rho = rho * scale
            xt_next, yt_next = (cx - x_new) / scale, (cy - y_new) / scale
        else:
            xt_next, yt_next = cx - x_new, cy - y_new
        x, y, xt, yt = x_new, y_new, xt_next, yt_next
    left = ~done
    out_x[:, left] = x12[:, left]
    out_y[:, left] = y12[:, left]
    status = torch.where(done, SUCCESS, MAX_ITER)
    return Result(x=out_x, y=out_y * sigma, status=status, iterations=iters)
