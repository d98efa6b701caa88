"""Solver cores: graph-form ADMM and the cone-form HSDE solver."""

from pogs_tpu_torch.solver.admm import admm_loop, postsolve_verify
from pogs_tpu_torch.solver.graph import GraphFormSolver, admm_solve
from pogs_tpu_torch.solver.hsde import hsde_solve

__all__ = ["admm_loop", "postsolve_verify", "GraphFormSolver", "admm_solve", "hsde_solve"]
