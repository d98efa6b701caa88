"""The port's cone library against pogs_tpu's, on the same seeded points.

Projections onto the SOC, the PSD cone (svec-scaled and unscaled packing)
and the exponential cone and its dual, and ``ConeSet``'s project, dual,
constrain_average, distance and svec_scale; the cone-hooked equilibration;
``ConeConstraint``.  Tolerances: float64 within 1e-10, float32 within 1e-5
(the exponential bisection runs in the working type in both packages).

The JAX exponential projection runs eagerly here (op by op): compiling its
unrolled bisection takes longer than running it on a few hundred points.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pogs_tpu.types import Cone as JC, ConeConstraint as JCC
from pogs_tpu.cones.sets import ConeSet as JSet
from pogs_tpu.cones import projections as jp
from pogs_tpu.linalg.equil import equilibrate as j_equilibrate
from pogs_tpu.linalg.matrix import DenseMatrix as JDense

import pogs_tpu_torch as P
from pogs_tpu_torch.cones import projections as pp
from pogs_tpu_torch.cones.sets import ConeSet
from pogs_tpu_torch.linalg.equil import equilibrate
from pogs_tpu_torch.linalg.matrix import DenseMatrix

torch.set_num_threads(1)

_NP = {"f32": np.float32, "f64": np.float64}
_T = {"f32": torch.float32, "f64": torch.float64}
_TOL = {"f32": 1e-5, "f64": 1e-10}


def _soc_points(rng):
    """Rows covering the three SOC cases: polar (‖x‖ ≤ −p), inside
    (‖x‖ ≤ p), and the general case."""
    v = rng.standard_normal((60, 5))
    nx = np.linalg.norm(v[:, 1:], axis=1)
    v[:20, 0] = -2.0 * nx[:20]
    v[20:40, 0] = 2.0 * nx[20:40]
    return v


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_project_soc(dt):
    v = _soc_points(np.random.default_rng(0)).astype(_NP[dt])
    out = pp.project_soc(torch.tensor(v)).numpy()
    np.testing.assert_allclose(out, np.asarray(jp.project_soc(jnp.asarray(v))), atol=_TOL[dt])


@pytest.mark.parametrize("scaled", [True, False])
def test_project_sdp(scaled):
    rng = np.random.default_rng(1)
    v = rng.standard_normal((7, 10))  # seven 4x4 blocks
    out = pp.project_sdp_packed(torch.tensor(v), 4, scaled=scaled).numpy()
    ref = np.asarray(jp.project_sdp_packed(jnp.asarray(v), 4, scaled=scaled))
    np.testing.assert_allclose(out, ref, atol=1e-10)


def _exp_points(rng):
    """Random points plus points in each candidate region: inside the cone
    (v), in the polar cone (0), on the ray face r ≤ 0, s = 0, t ≥ 0 (ray),
    and near the z = 0 edge (a root)."""
    v = list(rng.standard_normal((300, 3)) * 2.0)
    for _ in range(10):
        r, s = rng.standard_normal(), abs(rng.standard_normal()) + 0.1
        v.append([r, s, s * np.exp(r / s) + abs(rng.standard_normal())])  # inside
        v.append([-abs(rng.standard_normal()) - 1.0, -abs(rng.standard_normal()),
                  -abs(rng.standard_normal()) - 0.5])
        v.append([-abs(rng.standard_normal()), -abs(rng.standard_normal()) - 0.1,
                  abs(rng.standard_normal())])
        v.append([rng.standard_normal(), 1e-3 * rng.random(), -1e-3 * rng.random()])
    return np.asarray(v)


def _classify(v, p):
    """Which candidate each projection is: 0 v, 1 the origin, 2 the ray
    point, 3 a root."""
    same = np.all(np.abs(p - v) <= 1e-12 * (1 + np.abs(v)), axis=1)
    origin = np.all(p == 0, axis=1)
    ray = (p[:, 1] == 0) & ~origin & ~same
    return np.where(same, 0, np.where(origin, 1, np.where(ray, 2, 3)))


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_project_exp_primal_and_dual(dt):
    v = _exp_points(np.random.default_rng(2)).astype(_NP[dt])
    vt = torch.tensor(v)
    prim = pp.project_exp_primal(vt).numpy()
    dual = pp.project_exp_dual(vt).numpy()
    np.testing.assert_allclose(prim, np.asarray(jp._project_exp_primal_impl(jnp.asarray(v))),
                               atol=_TOL[dt])
    np.testing.assert_allclose(
        dual, np.asarray(jnp.asarray(v) + jp._project_exp_primal_impl(-jnp.asarray(v), 80)),
        atol=_TOL[dt])
    if dt == "f64":
        assert set(_classify(v.astype(np.float64), prim.astype(np.float64))) == {0, 1, 2, 3}


def _cone_list():
    """Every cone type, two SOC sizes, and free rows."""
    return [(JC.ZERO, [0, 1]), (JC.NON_NEG, [2, 3, 4]), (JC.NON_POS, [5]),
            (JC.SOC, range(6, 10)), (JC.SOC, range(10, 14)), (JC.SOC, range(14, 17)),
            (JC.SDP, range(17, 23)), (JC.EXP_PRIMAL, [23, 24, 25]),
            (JC.EXP_DUAL, [26, 27, 28])], 31


def _sets(cones, m):
    return (JSet([JCC(k, i) for k, i in cones], m),
            ConeSet([P.ConeConstraint(int(k), i) for k, i in cones], m))


def test_cone_set_against_jax():
    cones, m = _cone_list()
    J, K = _sets(cones, m)
    v = np.random.default_rng(3).standard_normal(m) * 2.0
    vt, vj = torch.tensor(v), jnp.asarray(v)
    np.testing.assert_allclose(K.project(vt).numpy(), np.asarray(J.project(vj)), atol=1e-10)
    np.testing.assert_allclose(K.dual().project(vt).numpy(),
                               np.asarray(J.dual().project(vj)), atol=1e-10)
    assert [(int(c.cone), c.indices) for c in K.dual().constraints] == \
        [(int(c.cone), c.indices) for c in J.dual().constraints]
    np.testing.assert_allclose(K.constrain_average(vt).numpy(),
                               np.asarray(J.constrain_average(vj)), atol=1e-12)
    assert float(K.distance(vt)) == pytest.approx(float(J.distance(vj)), abs=1e-10)
    np.testing.assert_array_equal(K.svec_scale(), J.svec_scale())
    for a, b in zip(K.separable_masks(), J.separable_masks()):
        np.testing.assert_array_equal(a, b)
    assert K.is_separable_only == J.is_separable_only is False
    assert K.has_sdp and not K.is_empty and len(K) == len(J)
    # The input is left as it was.
    np.testing.assert_array_equal(vt.numpy(), v)


def test_cone_set_validation():
    with pytest.raises(ValueError):
        ConeSet([P.ConeConstraint(P.Cone.NON_NEG, [0, 1]),
                 P.ConeConstraint(P.Cone.ZERO, [1])], 3)
    with pytest.raises(ValueError):
        ConeSet([P.ConeConstraint(P.Cone.NON_NEG, [3])], 3)
    with pytest.raises(ValueError):
        ConeSet([P.ConeConstraint(P.Cone.SDP, [0, 1])], 3)
    with pytest.raises(ValueError):
        ConeSet([P.ConeConstraint(P.Cone.EXP_PRIMAL, [0, 1])], 3)


def test_cone_hooked_equilibration_against_jax():
    cones, m = _cone_list()
    J, K = _sets(cones, m)
    Jx, Kx = _sets([(JC.NON_NEG, [0, 1]), (JC.SOC, [2, 3, 4])], 6)
    A = np.random.default_rng(4).standard_normal((m, 6))
    A[14] = 0.0  # a zero row inside an SOC: pinned, then averaged
    p = equilibrate(DenseMatrix(torch.tensor(A)), constrain_d=K.constrain_average,
                    constrain_e=Kx.constrain_average)
    j = j_equilibrate(JDense(jnp.asarray(A)), constrain_d=J.constrain_average,
                      constrain_e=Jx.constrain_average)
    np.testing.assert_allclose(p.d.numpy(), np.asarray(j.d), rtol=1e-10)
    np.testing.assert_allclose(p.e.numpy(), np.asarray(j.e), rtol=1e-10)
    np.testing.assert_allclose(p.A.dense().numpy(), np.asarray(j.A.dense()), atol=1e-10)
    # The scaling is uniform inside every SOC.
    d = p.d.numpy()
    assert np.ptp(d[6:10]) == 0 and np.ptp(d[14:17]) == 0


def test_cone_constraint():
    a = P.ConeConstraint(P.Cone.SOC, range(3))
    b = P.ConeConstraint(3, [0, 1, 2])
    assert a == b and hash(a) == hash(b) and len(a) == 3
    assert a.indices == (0, 1, 2) and isinstance(a.cone, P.Cone)
    assert a != P.ConeConstraint(P.Cone.SOC, [0, 1])
    with pytest.raises(AttributeError):
        a.cone = P.Cone.ZERO
    j = JCC(JC.SOC, range(3))
    assert (int(a.cone), a.indices) == (int(j.cone), j.indices)
