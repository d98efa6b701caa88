"""The 16-function proximal-operator library, elementwise on tensors.

Counterpart of ``pogs_tpu/prox/scalar.py``.  Each entry h defines
f(x) = c*h(a*x - b) + d*x + (e/2) x^2 and three evaluations:

  * ``PROX[h](v, rho)``  — argmin_x h(x) + (rho/2)(x - v)^2;
  * ``FUNC[h](x)``       — h(x);
  * ``SUBGRAD[h](v, x)`` — projection of v onto the subdifferential of h at x.

The (a,b,c,d,e) transform is applied in :mod:`pogs_tpu_torch.prox.vector`.
The device switch in ``csrc/fused_admm.cu`` mirrors these formulas one for
one.
"""

from __future__ import annotations

import torch

from pogs_tpu_torch.types import Function
from pogs_tpu_torch.prox.tools import lambertw_exp, cubic_solve, sigmoid


def _tiny(x) -> float:
    return torch.finfo(x.dtype).tiny


def _log_rho(v, rho):
    return torch.log(torch.as_tensor(rho, dtype=v.dtype, device=v.device))


# ---------------------------------------------------------------------------
# Proximal operators of the base functions h (penalty rho).
# ---------------------------------------------------------------------------

def prox_abs(v, rho):
    """Soft-thresholding: shrink v toward 0 by 1/rho."""
    k = 1.0 / rho
    return torch.clamp(v - k, min=0) + torch.clamp(v + k, max=0)


def prox_neg_entr(v, rho):
    """prox of x log x: W(e^{rho v - 1 + log rho}) / rho."""
    return lambertw_exp(rho * v - 1.0 + _log_rho(v, rho)) / rho


def prox_exp(v, rho):
    """prox of e^x: v - W(e^{v - log rho})."""
    return v - lambertw_exp(v - _log_rho(v, rho))


def prox_huber(v, rho):
    """prox of huber: shrinkage inside |v| < 1 + 1/rho, else a shift."""
    small = torch.abs(v) < 1.0 + 1.0 / rho
    return torch.where(small, v * rho / (1.0 + rho), v - torch.sign(v) / rho)


def prox_identity(v, rho):
    return v - 1.0 / rho


def prox_ind_box01(v, rho):
    return torch.clamp(v, 0.0, 1.0)


def prox_ind_eq0(v, rho):
    return torch.zeros_like(v)


def prox_ind_ge0(v, rho):
    return torch.clamp(v, min=0)


def prox_ind_le0(v, rho):
    return torch.clamp(v, max=0)


def prox_logistic(v, rho, newton_iters: int = 5, bisect_iters: int = 30):
    """prox of log(1 + e^x): root of sigma(x) + rho (x - v) = 0.

    Bracketed on [v - 1/rho, v]; guarded Newton steps, fixed-count
    bisection, then two Newton polish steps.
    """
    lo = v - 1.0 / rho
    hi = v
    x = torch.where(
        v < -2.5,
        v,
        torch.where(v > 2.5 + 1.0 / rho, v - 1.0 / rho, (rho * v - 0.5) / (0.2 + rho)),
    )

    def newton(x, lo, hi):
        sig = sigmoid(x)
        f = sig + rho * (x - v)
        g = sig * (1.0 - sig) + rho
        neg = f < 0
        lo = torch.where(neg, x, lo)
        hi = torch.where(neg, hi, x)
        x = torch.minimum(torch.maximum(x - f / g, lo), hi)
        return x, lo, hi

    for _ in range(newton_iters):
        x, lo, hi = newton(x, lo, hi)
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        neg = sigmoid(mid) + rho * (mid - v) < 0
        lo = torch.where(neg, mid, lo)
        hi = torch.where(neg, hi, mid)
    x = 0.5 * (lo + hi)
    for _ in range(2):
        x, lo, hi = newton(x, lo, hi)
    return x


def prox_max_neg0(v, rho):
    """prox of max(0, -x)."""
    z = torch.clamp(v, min=0)
    return torch.where(v + 1.0 / rho <= 0, v + 1.0 / rho, z)


def prox_max_pos0(v, rho):
    """prox of max(0, x)."""
    z = torch.clamp(v, max=0)
    return torch.where(v >= 1.0 / rho, v - 1.0 / rho, z)


def prox_neg_log(v, rho):
    """prox of -log x: positive root of x^2 - v x - 1/rho = 0."""
    return 0.5 * (v + torch.sqrt(v * v + 4.0 / rho))


def prox_recipr(v, rho):
    """prox of 1/x (x > 0): positive root of x^3 - v x^2 - 1/rho = 0."""
    return cubic_solve(-v, torch.zeros_like(v), -1.0 / rho)


def prox_square(v, rho):
    """prox of (1/2) x^2: pure shrinkage."""
    return rho * v / (1.0 + rho)


def prox_zero(v, rho):
    return v


PROX = {
    Function.ABS: prox_abs,
    Function.EXP: prox_exp,
    Function.HUBER: prox_huber,
    Function.IDENTITY: prox_identity,
    Function.INDBOX01: prox_ind_box01,
    Function.INDEQ0: prox_ind_eq0,
    Function.INDGE0: prox_ind_ge0,
    Function.INDLE0: prox_ind_le0,
    Function.LOGISTIC: prox_logistic,
    Function.MAXNEG0: prox_max_neg0,
    Function.MAXPOS0: prox_max_pos0,
    Function.NEGENTR: prox_neg_entr,
    Function.NEGLOG: prox_neg_log,
    Function.RECIPR: prox_recipr,
    Function.SQUARE: prox_square,
    Function.ZERO: prox_zero,
}


# ---------------------------------------------------------------------------
# Function evaluation h(x).
# ---------------------------------------------------------------------------

def func_abs(x):
    return torch.abs(x)


def func_neg_entr(x):
    return torch.where(x <= 0, torch.zeros_like(x),
                       x * torch.log(torch.clamp(x, min=_tiny(x))))


def func_exp(x):
    return torch.exp(x)


def func_huber(x):
    ax = torch.abs(x)
    return torch.where(ax < 1, 0.5 * ax * ax, ax - 0.5)


def func_identity(x):
    return x


def _func_zero(x):
    return torch.zeros_like(x)


def func_logistic(x):
    # log(1 + e^x), stable for large |x|.
    return torch.logaddexp(torch.zeros_like(x), x)


def func_max_neg0(x):
    return torch.clamp(-x, min=0)


def func_max_pos0(x):
    return torch.clamp(x, min=0)


def func_neg_log(x):
    return -torch.log(torch.clamp(x, min=0))


def func_recipr(x):
    return 1.0 / torch.clamp(x, min=0)


def func_square(x):
    return 0.5 * x * x


FUNC = {
    Function.ABS: func_abs,
    Function.EXP: func_exp,
    Function.HUBER: func_huber,
    Function.IDENTITY: func_identity,
    Function.INDBOX01: _func_zero,
    Function.INDEQ0: _func_zero,
    Function.INDGE0: _func_zero,
    Function.INDLE0: _func_zero,
    Function.LOGISTIC: func_logistic,
    Function.MAXNEG0: func_max_neg0,
    Function.MAXPOS0: func_max_pos0,
    Function.NEGENTR: func_neg_entr,
    Function.NEGLOG: func_neg_log,
    Function.RECIPR: func_recipr,
    Function.SQUARE: func_square,
    Function.ZERO: _func_zero,
}


# ---------------------------------------------------------------------------
# Projection of v onto the subdifferential of h at x (warm-start support).
# ---------------------------------------------------------------------------

def _ones(v):
    return torch.ones_like(v)


def subgrad_abs(v, x):
    return torch.where(x < 0, -_ones(v),
                       torch.where(x > 0, _ones(v), torch.clamp(v, -1.0, 1.0)))


def subgrad_neg_entr(v, x):
    return -torch.log(torch.clamp(x, min=_tiny(x))) - 1.0


def subgrad_exp(v, x):
    return torch.exp(x)


def subgrad_huber(v, x):
    return torch.clamp(x, -1.0, 1.0)


def subgrad_identity(v, x):
    return _ones(v)


def subgrad_ind_box01(v, x):
    return torch.where(x <= 0, torch.clamp(v, max=0),
                       torch.where(x >= 1, torch.clamp(v, min=0), torch.zeros_like(v)))


def subgrad_ind_eq0(v, x):
    return v


def subgrad_ind_ge0(v, x):
    return torch.where(x <= 0, torch.clamp(v, max=0), torch.zeros_like(v))


def subgrad_ind_le0(v, x):
    return torch.where(x >= 0, torch.clamp(v, min=0), torch.zeros_like(v))


def subgrad_logistic(v, x):
    return sigmoid(x)


def subgrad_max_neg0(v, x):
    return torch.where(x < 0, -_ones(v),
                       torch.where(x > 0, torch.zeros_like(v), torch.clamp(v, -1.0, 0.0)))


def subgrad_max_pos0(v, x):
    return torch.where(x < 0, torch.zeros_like(v),
                       torch.where(x > 0, _ones(v), torch.clamp(v, 0.0, 1.0)))


def subgrad_neg_log(v, x):
    return -1.0 / x


def subgrad_recipr(v, x):
    return 1.0 / (x * x)


def subgrad_square(v, x):
    return x


def subgrad_zero(v, x):
    return torch.zeros_like(v)


SUBGRAD = {
    Function.ABS: subgrad_abs,
    Function.EXP: subgrad_exp,
    Function.HUBER: subgrad_huber,
    Function.IDENTITY: subgrad_identity,
    Function.INDBOX01: subgrad_ind_box01,
    Function.INDEQ0: subgrad_ind_eq0,
    Function.INDGE0: subgrad_ind_ge0,
    Function.INDLE0: subgrad_ind_le0,
    Function.LOGISTIC: subgrad_logistic,
    Function.MAXNEG0: subgrad_max_neg0,
    Function.MAXPOS0: subgrad_max_pos0,
    Function.NEGENTR: subgrad_neg_entr,
    Function.NEGLOG: subgrad_neg_log,
    Function.RECIPR: subgrad_recipr,
    Function.SQUARE: subgrad_square,
    Function.ZERO: subgrad_zero,
}
