"""The lasso's plain reference: min ½‖Ax − b‖² + λ‖x‖₁, in float64.

``solve`` runs the plain graph-form ADMM (``reference/admm.py``) on K
right-hand sides (b_k, λ_k) of one A at once; ``optimum`` runs it in
float64 to a tight tolerance and then polishes each answer on its support
(the exact least-squares solve with the signs fixed), keeping the polished
answer where it satisfies the optimality conditions.  ``kkt`` measures
those conditions for any answer, relative to λ.  Nothing here imports the
program.
"""

from __future__ import annotations

import torch

from perfbench.reference.admm import Result, exact_products, graph_admm

# The float64 optimum: tight enough that the support is found, then polished.
OPT_TOL = 1e-8
OPT_MAX_ITER = 4000
# |x_j| above this counts as in the support (bench.py's lasso KKT check).
SUPPORT = 1e-5


def solve(A, B, lams, abs_tol, rel_tol, max_iter, precision="float64") -> Result:
    """K lasso problems on one A: B (m, K) right-hand sides, lams (K,)."""
    lam = lams.reshape(1, -1)

    def prox_f(v, rho):           # ½‖y − b‖²
        bb = B.to(v.dtype)
        return (bb + rho * v) / (1.0 + rho)

    def prox_g(v, rho):           # λ‖x‖₁
        t = lam.to(v.dtype) / rho
        return torch.sign(v) * torch.clamp(v.abs() - t, min=0.0)

    return graph_admm(A, prox_f, prox_g, B.shape[1], abs_tol, rel_tol, max_iter, precision)


class Normal:
    """AᵀA and Aᵀb in float64 for one A, and the checks built on them."""

    def __init__(self, A):
        self.A = A.to(torch.float64)
        with exact_products():
            self.G = self.A.T @ self.A

    def atb(self, B):
        with exact_products():
            return self.A.T @ B.to(torch.float64)

    def kkt(self, Atb, lams, X):
        """Each column's largest violation of the lasso's optimality
        conditions (float64), relative to ‖Aᵀb‖∞, the scale of the gradient
        at x = 0 and the λ at which the answer becomes 0: one scale for
        every λ of a path."""
        X = X.to(torch.float64)
        lam = lams.to(torch.float64).reshape(1, -1)
        with exact_products():
            grad = self.G @ X - Atb
        on = X.abs() > SUPPORT
        viol = torch.where(on, (grad + lam * torch.sign(X)).abs(),
                           torch.clamp(grad.abs() - lam, min=0.0))
        return viol.max(dim=0).values / Atb.abs().max(dim=0).values

    def objective(self, B, lams, X):
        X = X.to(torch.float64)
        with exact_products():
            r = self.A @ X - B.to(torch.float64)
        return 0.5 * (r * r).sum(0) + lams.to(torch.float64) * X.abs().sum(0)

    def polish(self, Atb, lams, X):
        """Each column solved exactly on its support with its signs fixed;
        the polished column replaces the ADMM one where its optimality
        violation is smaller."""
        out = X.to(torch.float64).clone()
        for k in range(X.shape[1]):
            on = out[:, k].abs() > SUPPORT
            if not bool(on.any()):
                continue
            s = torch.sign(out[on, k])
            rhs = Atb[on, k] - lams[k].to(torch.float64) * s
            xs = torch.linalg.solve(self.G[on][:, on], rhs)
            cand = torch.zeros_like(out[:, k])
            cand[on] = xs
            lam_k = lams[k:k + 1]
            if float(self.kkt(Atb[:, k:k + 1], lam_k, cand[:, None])[0]) < float(
                    self.kkt(Atb[:, k:k + 1], lam_k, out[:, k:k + 1])[0]):
                out[:, k] = cand
        return out

    def optimum(self, B, lams):
        """The float64 optimum of each column: (X (n, K), its kkt (K,))."""
        res = solve(self.A, B.to(torch.float64), lams.to(torch.float64),
                    OPT_TOL, OPT_TOL, OPT_MAX_ITER, "float64")
        Atb = self.atb(B)
        X = self.polish(Atb, lams, res.x)
        return X, self.kkt(Atb, lams, X)
