"""The port's differentiable cone layer against pogs_tpu's, on the same
inputs.

``diff_cone_solve`` on an LP, an SOCP and an exponential-cone problem (those
of tests/test_diff_cone.py): the same numpy data from one seed through the
JAX layer (called as its tests call it, under ``jax.grad``) and the port's.
Pass: the same status and iteration count, x within 1e-8·max(1, ‖x‖∞), and
the gradients w.r.t. A, b and c within rtol 1e-6, atol 1e-9.  CPU, float64.

Inside a JAX solve loop the exponential projection's unrolled bisection
takes a minute to compile, so the JAX projection is compiled on its own and
called through ``jax.pure_callback``, as tests/test_torch_cone_solver.py
does; its derivative stays the JAX package's own rule
(``_exp_primal_tangent`` at the projected point), which JAX transposes for
the reverse pass.
"""

from functools import partial

import numpy as np
import pytest
import torch
import jax

from pogs_tpu.api.diff_cone import diff_cone_solve as j_diff_cone_solve
import pogs_tpu.cones.projections as j_proj
import pogs_tpu.cones.sets as j_sets
from pogs_tpu.types import Cone as JCone, ConeConstraint as JCC, SolverSettings as JSet

from pogs_tpu_torch.api.diff_cone import diff_cone_solve
from pogs_tpu_torch.types import Cone, ConeConstraint, SolverSettings
from tests.test_torch_diff_parity import _assert_parity, _jax_grads, _port_grads

torch.set_num_threads(1)

CONE_TIGHT = dict(abs_tol=1e-10, rel_tol=1e-10, max_iter=40000)


@pytest.fixture(scope="module")
def jax_exp_by_callback():
    saved = (j_sets.project_exp_primal, j_sets.project_exp_dual)
    primal = jax.jit(saved[0], static_argnums=1)

    @partial(jax.custom_jvp, nondiff_argnums=(1,))
    def proj(v, bisect_iters=50):
        return jax.pure_callback(lambda x: np.asarray(primal(x, bisect_iters)),
                                 jax.ShapeDtypeStruct(v.shape, v.dtype), v,
                                 vmap_method="sequential")

    @proj.defjvp
    def _proj_jvp(bisect_iters, primals, tangents):
        (v,), (dv,) = primals, tangents
        p = proj(v, bisect_iters)
        return p, j_proj._exp_primal_tangent(v, p, dv)

    j_sets.project_exp_primal = proj
    j_sets.project_exp_dual = lambda v, bisect_iters=80: v + proj(-v, bisect_iters)
    try:
        yield
    finally:
        j_sets.project_exp_primal, j_sets.project_exp_dual = saved


def _lp(rng, m=18, n=8):
    A = rng.standard_normal((m, n))
    b = A @ rng.standard_normal(n) + rng.random(m) + 0.1
    c = rng.standard_normal(n)
    A = np.vstack([A, np.eye(n), -np.eye(n)])
    b = np.concatenate([b, np.full(n, 5.0), np.full(n, 5.0)])
    return A, b, c, [(Cone.NON_NEG, range(A.shape[0]))]


def _socp(rng, n=6):
    F = rng.standard_normal((n + 2, n))
    g = rng.standard_normal(n + 2)
    d = rng.standard_normal(n)
    x0 = rng.standard_normal(n)
    e = float(d @ x0 - np.linalg.norm(F @ x0 - g) - 1.0)
    c = rng.standard_normal(n)
    A = np.vstack([np.eye(n), -np.eye(n), -d[None, :], F])
    b = np.concatenate([np.full(n, 4.0), np.full(n, 4.0), [-e], g])
    return A, b, c, [(Cone.NON_NEG, range(2 * n)), (Cone.SOC, range(2 * n, 3 * n + 3))]


def _exp(rng):
    A = np.vstack([np.eye(2), -np.eye(2), [[-1.0, 0.0], [0.0, 0.0], [0.0, -1.0]]])
    b = np.array([3.0, 3.0, 3.0, 3.0, 0.0, 1.0, 0.0])
    c = np.array([-1.0, 1.0])
    return A, b, c, [(Cone.NON_NEG, range(4)), (Cone.EXP_PRIMAL, range(4, 7))]


@pytest.mark.parametrize("problem", ["lp", "socp", "exp"])
def test_diff_cone_solve_matches_jax(rng, problem, jax_exp_by_callback):
    A, b, c, cones = {"lp": _lp, "socp": _socp, "exp": _exp}[problem](rng)
    w = rng.standard_normal(A.shape[1])
    j_cones = [JCC(JCone(int(k)), idx) for k, idx in cones]
    p_cones = [ConeConstraint(k, idx) for k, idx in cones]
    out_j = _jax_grads(lambda *a: j_diff_cone_solve(*a, j_cones, settings=JSet(**CONE_TIGHT)),
                       (A, b, c), w)
    out_p = _port_grads(lambda *a: diff_cone_solve(*a, p_cones,
                                                   settings=SolverSettings(**CONE_TIGHT)),
                        (A, b, c), w)
    _assert_parity(out_j, out_p)
