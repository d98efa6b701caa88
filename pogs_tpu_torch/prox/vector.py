"""Vector prox / function evaluation, dispatched on the h codes present.

Counterpart of ``pogs_tpu/prox/vector.py``.  The h codes are host data, so
only the function types that occur are evaluated, each over the full vector
and combined with a mask; a single-type objective evaluates one branch.
"""

from __future__ import annotations

import numpy as np
import torch

from pogs_tpu_torch.types import Function, FunctionVector
from pogs_tpu_torch.prox.scalar import PROX, FUNC, SUBGRAD


def _dispatch(table, h: np.ndarray, *args):
    """Evaluate ``table[h_i](*args)`` elementwise over the types present."""
    out = None
    for t in np.unique(h):
        mask = h == t
        branch = table[Function(int(t))](*args)
        if mask.all():
            return branch
        mask_t = torch.as_tensor(mask, device=branch.device)
        base = torch.zeros_like(branch) if out is None else out
        out = torch.where(mask_t, branch, base)
    return out


def prox_eval(fv: FunctionVector, v, rho):
    """prox_{f, rho}(v), f_i = c_i h_i(a_i x - b_i) + d_i x + (e_i/2) x^2.

        v'   = a (v rho - d) / (e + rho) - b
        rho' = (e + rho) / (c a^2)
        out  = (prox_h(v', rho') + b) / a

    a = 0 makes the h-term constant: the prox is then (v rho - d)/(e + rho).
    """
    a, b, c, d, e = fv.params
    a_safe = torch.where(a == 0, torch.ones_like(a), a)
    vt = a_safe * (v * rho - d) / (e + rho) - b
    rt = (e + rho) / (c * a_safe * a_safe)
    out = _dispatch(PROX, fv.h, vt, rt)
    return torch.where(a == 0, (v * rho - d) / (e + rho), (out + b) / a_safe)


def func_eval(fv: FunctionVector, x):
    """sum_i c_i h_i(a_i x_i - b_i) + d_i x_i + (e_i/2) x_i^2."""
    a, b, c, d, e = fv.params
    hval = _dispatch(FUNC, fv.h, a * x - b)
    return torch.sum(c * hval + d * x + 0.5 * e * x * x)


def proj_subgrad_eval(fv: FunctionVector, v, x):
    """Project v onto the subdifferential of f at x."""
    a, b, c, d, e = fv.params
    ac = a * c
    affine = d + e * x  # result when a == 0 or c == 0
    safe_ac = torch.where(ac == 0, torch.ones_like(ac), ac)
    vt = (v - d - e * x) / safe_ac
    out = _dispatch(SUBGRAD, fv.h, vt, a * x - b)
    return torch.where(ac == 0, affine, ac * out + affine)


def scale_f(fv: FunctionVector, d_scale) -> FunctionVector:
    """Scale f by the row equilibration d: a,d /= d_i, e /= d_i^2."""
    return fv.replace_params(
        a=fv.a / d_scale, d=fv.d / d_scale, e=fv.e / (d_scale * d_scale)
    )


def scale_g(fv: FunctionVector, e_scale) -> FunctionVector:
    """Scale g by the column equilibration e: a,d *= e_j, e *= e_j^2."""
    return fv.replace_params(
        a=fv.a * e_scale, d=fv.d * e_scale, e=fv.e * (e_scale * e_scale)
    )
