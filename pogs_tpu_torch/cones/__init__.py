"""Cone library: projections onto the supported cones, and cone sets."""

from pogs_tpu_torch.cones.projections import (
    project_soc,
    project_sdp_packed,
    project_exp_primal,
    project_exp_dual,
)
from pogs_tpu_torch.cones.sets import ConeSet, dual_cone, is_separable, validate_cones

__all__ = [
    "project_soc",
    "project_sdp_packed",
    "project_exp_primal",
    "project_exp_dual",
    "ConeSet",
    "dual_cone",
    "is_separable",
    "validate_cones",
]
