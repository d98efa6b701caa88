"""Elementwise special functions used by the prox library.

Counterpart of ``pogs_tpu/prox/tools.py`` (LambertWExp and CubicSolve of the
reference's prox_tools.h): fixed iteration counts and masked selects, so the
results match the JAX package element for element.
"""

from __future__ import annotations

import torch


def _tiny(dt) -> float:
    return torch.finfo(dt).tiny


def lambertw_exp(x):
    """Principal-branch Lambert W of e^x: the w > 0 with w + log(w) = x.

    Newton on the log form, w <- w - (w + log w - x) w / (w + 1), 20 fixed
    iterations from a two-regime guess (x - log x above 1, e^x below).
    """
    x = torch.as_tensor(x)
    dt = x.dtype
    big = x > 1.0
    w = torch.where(big, x - torch.log(torch.clamp(x, min=1.0)),
                    torch.exp(torch.clamp(x, max=1.0)))
    tiny = _tiny(dt)
    for _ in range(20):
        w = torch.clamp(w, min=tiny)
        f = w + torch.log(w) - x
        w = w - f * w / (w + 1.0)
    return torch.clamp(w, min=tiny)


def cbrt(x):
    """Real cube root sign(x)·|x|^(1/3), with cbrt(0) = 0 exactly."""
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def cubic_solve(p, q, r):
    """The single positive real root of x^3 + p x^2 + q x + r = 0.

    Depressed-cubic reduction, then Cardano (one real root) or the
    trigonometric form (three real roots), selected by the discriminant.
    """
    p = torch.as_tensor(p)
    dt = p.dtype
    q = torch.as_tensor(q, dtype=dt)
    r = torch.as_tensor(r, dtype=dt)
    third = 1.0 / 3.0

    s = p * third
    s2 = s * s
    a = q * third - s2           # depressed cubic: t^3 + 3 a t + 2 b = 0
    b = s * s2 - s * q * 0.5 + r * 0.5
    disc = a * a * a + b * b

    # Cardano branch (disc >= 0): t = A - a / A, A = cbrt(sqrt(disc) - b).
    A_card = cbrt(torch.sqrt(torch.clamp(disc, min=0)) - b)
    safe_A = torch.where(A_card == 0, torch.ones_like(A_card), A_card)
    t_card = A_card - a / safe_A
    t_card = torch.where(A_card == 0, torch.zeros_like(t_card), t_card)

    # Trigonometric branch (disc < 0, so a < 0): the largest real root.
    na = torch.clamp(-a, min=_tiny(dt))
    sq_na = torch.sqrt(na)
    cos_arg = torch.clamp(-b / (na * sq_na), -1.0, 1.0)
    theta = torch.arccos(cos_arg)
    t_trig = 2 * sq_na * torch.cos(theta * third)

    t = torch.where(disc >= 0, t_card, t_trig)
    return t - s


def sigmoid(x):
    """Numerically stable logistic sigmoid 1 / (1 + e^-x)."""
    return 0.5 * (torch.tanh(0.5 * torch.as_tensor(x)) + 1.0)
