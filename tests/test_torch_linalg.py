"""The port's dense matrix, equilibration, norm estimate and direct
projector against pogs_tpu's, in float64.

Tolerances: rtol 1e-12 for elementwise and Sinkhorn results (the same
operations, summed in another order by each framework's BLAS); rtol 1e-10
for the Cholesky-based inverse and projections (condition number of G + I
on the order of 10 here).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pogs_tpu.linalg.equil import equilibrate as j_equilibrate
from pogs_tpu.linalg.matrix import DenseMatrix as JDense
from pogs_tpu.linalg.norm import norm2_est as j_norm2_est
from pogs_tpu.projector.direct import DirectProjector as JProj
from pogs_tpu_torch.linalg.equil import equilibrate
from pogs_tpu_torch.linalg.matrix import DenseMatrix
from pogs_tpu_torch.linalg.norm import norm2_est
from pogs_tpu_torch.projector.direct import DirectProjector

torch.set_num_threads(1)


def _mat(m, n, seed=0, zero_row=None, zero_col=None):
    A = np.random.default_rng(seed).standard_normal((m, n))
    if zero_row is not None:
        A[zero_row, :] = 0.0
    if zero_col is not None:
        A[:, zero_col] = 0.0
    return A


def test_dense_matrix_ops():
    A = _mat(9, 6, 1)
    P, J = DenseMatrix(torch.tensor(A)), JDense(jnp.asarray(A))
    x, y = np.arange(6.0), np.arange(9.0)
    for pv, jv in ((P.mv(torch.tensor(x)), J.mv(jnp.asarray(x))),
                   (P.rmv(torch.tensor(y)), J.rmv(jnp.asarray(y))),
                   (P.sq_mv(torch.tensor(x)), J.sq_mv(jnp.asarray(x))),
                   (P.sq_rmv(torch.tensor(y)), J.sq_rmv(jnp.asarray(y)))):
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-12)
    d, e = np.linspace(1, 2, 9), np.linspace(0.5, 1, 6)
    np.testing.assert_allclose(
        P.scale(torch.tensor(d), torch.tensor(e)).scalar_mul(3.0).dense().numpy(),
        np.asarray(J.scale(jnp.asarray(d), jnp.asarray(e)).scalar_mul(3.0).dense()),
        rtol=1e-14)
    assert float(P.frob2()) == pytest.approx(float(J.frob2()), rel=1e-13)
    assert P.shape == (9, 6) and not P.is_sparse


@pytest.mark.parametrize("shape,zero_row,zero_col", [
    ((40, 25), None, None),
    ((40, 25), 3, 7),      # a zero row and a zero column are pinned to scale 1
    ((20, 45), 0, 44),
])
def test_equilibrate_matches(shape, zero_row, zero_col):
    A = _mat(*shape, seed=2, zero_row=zero_row, zero_col=zero_col)
    p = equilibrate(DenseMatrix(torch.tensor(A)))
    j = j_equilibrate(JDense(jnp.asarray(A)))
    np.testing.assert_allclose(p.A.dense().numpy(), np.asarray(j.A.dense()), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(p.d.numpy(), np.asarray(j.d), rtol=1e-12)
    np.testing.assert_allclose(p.e.numpy(), np.asarray(j.e), rtol=1e-12)
    # Tensor input follows the JAX package's dense-array path.
    pt = equilibrate(torch.tensor(A))
    jt = j_equilibrate(jnp.asarray(A))
    np.testing.assert_allclose(pt.A.numpy(), np.asarray(jt.A), rtol=1e-12, atol=1e-14)


def test_norm2_est_matches_with_jax_start_vector():
    A = _mat(50, 30, 3)
    x0 = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (30,), dtype=jnp.float32))
    p = norm2_est(torch.tensor(A), x0=torch.tensor(x0))
    j = j_norm2_est(jnp.asarray(A))
    assert float(p) == pytest.approx(float(j), rel=1e-12)
    # Its own start vector converges to the same norm within the tolerance.
    own = norm2_est(torch.tensor(A), seed=0)
    assert float(own) == pytest.approx(np.linalg.norm(A, 2), rel=1e-2)
    assert float(norm2_est(torch.zeros(5, 4, dtype=torch.float64))) == 0.0


@pytest.mark.parametrize("method", ["inverse", "cholesky"])
@pytest.mark.parametrize("shape", [(40, 25), (25, 40)], ids=["tall", "wide"])
def test_direct_projector_matches(shape, method):
    A = _mat(*shape, seed=4)
    m, n = shape
    rng = np.random.default_rng(9)
    x0, y0 = rng.standard_normal(n), rng.standard_normal(m)
    pp, jp = DirectProjector(method), JProj(method)
    pf = pp.init(torch.tensor(A))
    jf = jp.init(jnp.asarray(A))
    np.testing.assert_allclose(pf["op"].numpy(), np.asarray(jf["op"]), rtol=1e-10, atol=1e-13)
    px, py = pp.project(torch.tensor(A), pf, torch.tensor(x0), torch.tensor(y0))
    jx, jy = jp.project(jnp.asarray(A), jf, jnp.asarray(x0), jnp.asarray(y0))
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=1e-10, atol=1e-12)
    # The projection lands on the graph y = A x.
    np.testing.assert_allclose(A @ px.numpy(), py.numpy(), atol=1e-10)
