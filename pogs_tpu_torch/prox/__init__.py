"""Proximal-operator library (16 scalar functions + vector dispatch)."""

from pogs_tpu_torch.prox.tools import lambertw_exp, cubic_solve, sigmoid
from pogs_tpu_torch.prox.scalar import PROX, FUNC, SUBGRAD
from pogs_tpu_torch.prox.vector import (
    prox_eval,
    func_eval,
    proj_subgrad_eval,
    scale_f,
    scale_g,
)

__all__ = [
    "lambertw_exp",
    "cubic_solve",
    "sigmoid",
    "PROX",
    "FUNC",
    "SUBGRAD",
    "prox_eval",
    "func_eval",
    "proj_subgrad_eval",
    "scale_f",
    "scale_g",
]
