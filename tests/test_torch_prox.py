"""The port's prox library against pogs_tpu's, elementwise in float64.

Tolerance: rtol 1e-10 (atol 1e-12 near zero).  Both sides run the same
formulas with the same fixed iteration counts in float64; what differs is
the libm of each framework (exp, log, tanh, acos, cbrt vs pow), which
agrees to a few ulps.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pogs_tpu.prox.scalar as Js
import pogs_tpu.prox.tools as Jt
import pogs_tpu.prox.vector as Jv
from pogs_tpu.types import Function as JFunction, FunctionVector as JFV
import pogs_tpu_torch.prox.scalar as Ps
import pogs_tpu_torch.prox.tools as Pt
import pogs_tpu_torch.prox.vector as Pv
from pogs_tpu_torch.types import Function, FunctionVector

torch.set_num_threads(1)

RTOL, ATOL = 1e-10, 1e-12

_V = np.concatenate([np.linspace(-6.0, 6.0, 49), [0.0, 1e-3, -1e-3, 0.999, 1.0, 1.001]])
_RHO = np.array([0.3, 1.0, 7.5])
V = np.repeat(_V, len(_RHO))
RHO = np.tile(_RHO, len(_V))


def _close(p, j):
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL,
                               equal_nan=True)


@pytest.mark.parametrize("fn", list(Function), ids=lambda f: f.name)
def test_prox_matches(fn):
    p = Ps.PROX[fn](torch.tensor(V), torch.tensor(RHO))
    j = Js.PROX[JFunction(int(fn))](jnp.asarray(V), jnp.asarray(RHO))
    _close(p, j)


@pytest.mark.parametrize("fn", list(Function), ids=lambda f: f.name)
def test_func_matches(fn):
    p = Ps.FUNC[fn](torch.tensor(_V))
    j = Js.FUNC[JFunction(int(fn))](jnp.asarray(_V))
    _close(p, j)


@pytest.mark.parametrize("fn", list(Function), ids=lambda f: f.name)
def test_subgrad_matches(fn):
    x = np.roll(_V, 7)
    p = Ps.SUBGRAD[fn](torch.tensor(_V), torch.tensor(x))
    j = Js.SUBGRAD[JFunction(int(fn))](jnp.asarray(_V), jnp.asarray(x))
    _close(p, j)


def _mixed(rng, n):
    h = rng.integers(0, 16, n).astype(np.int32)
    h[:16] = np.arange(16)  # every type present
    a = rng.uniform(0.5, 2.0, n)
    a[::5] = 0.0            # a = 0 entries take the quadratic branch
    b = rng.standard_normal(n)
    c = rng.uniform(0.1, 2.0, n)
    d = rng.standard_normal(n)
    e = rng.uniform(0.0, 1.0, n)
    return h, (a, b, c, d, e)


def test_prox_eval_and_func_eval_mixed():
    rng = np.random.default_rng(5)
    n = 64
    h, params = _mixed(rng, n)
    fp = FunctionVector(h, a=params[0], b=params[1], c=params[2], d=params[3], e=params[4])
    fj = JFV(h, a=params[0], b=params[1], c=params[2], d=params[3], e=params[4],
             dtype=np.float64)
    v = rng.standard_normal(n)
    for rho in (0.5, 2.0):
        _close(Pv.prox_eval(fp, torch.tensor(v), torch.tensor(rho)),
               Jv.prox_eval(fj, jnp.asarray(v), rho))
    # FUNC is finite only on each function's domain: evaluate at the prox
    # output, which lies in it.
    x = Jv.prox_eval(fj, jnp.asarray(v), 1.0)
    _close(Pv.func_eval(fp, torch.tensor(np.asarray(x))), Jv.func_eval(fj, x))
    _close(Pv.proj_subgrad_eval(fp, torch.tensor(v), torch.tensor(np.asarray(x))),
           Jv.proj_subgrad_eval(fj, jnp.asarray(v), x))


def test_scale_f_g_match():
    rng = np.random.default_rng(6)
    h, params = _mixed(rng, 20)
    fp = FunctionVector(h, a=params[0], b=params[1], c=params[2],
                        d=params[3], e=params[4])
    fj = JFV(h, a=params[0], b=params[1], c=params[2], d=params[3], e=params[4],
             dtype=np.float64)
    s = rng.uniform(0.5, 2.0, 20)
    for pfun, jfun in ((Pv.scale_f, Jv.scale_f), (Pv.scale_g, Jv.scale_g)):
        for p, j in zip(pfun(fp, torch.tensor(s)).params, jfun(fj, jnp.asarray(s)).params):
            _close(p, j)


def test_lambertw_exp_matches():
    x = np.concatenate([np.linspace(-30.0, 30.0, 61), [0.0, -0.0, 1.0, 700.0, -700.0]])
    p = Pt.lambertw_exp(torch.tensor(x))
    _close(p, Jt.lambertw_exp(jnp.asarray(x)))
    # w e^w = e^x in log form where w is representable.
    w = p.numpy()
    ok = w > 1e-300
    np.testing.assert_allclose((w + np.log(w))[ok], x[ok], rtol=1e-12, atol=1e-12)


def test_cubic_solve_matches():
    # The prox of 1/x calls it as cubic_solve(-v, 0, -1/rho); cover both
    # discriminant branches, v = 0 and negative v.
    v = np.concatenate([np.linspace(-5.0, 5.0, 41), [0.0]])
    rho = np.full_like(v, 0.7)
    p = Pt.cubic_solve(torch.tensor(-v), torch.zeros(len(v), dtype=torch.float64),
                       torch.tensor(-1.0 / rho))
    j = Jt.cubic_solve(jnp.asarray(-v), jnp.zeros(len(v)), jnp.asarray(-1.0 / rho))
    _close(p, j)
    r = p.numpy()
    np.testing.assert_allclose(r ** 3 - v * r ** 2 - 1.0 / rho, 0.0, atol=1e-10)
    # The Cardano branch with A = 0 (p = q = r = 0) must give the root 0.
    z = torch.zeros(3, dtype=torch.float64)
    assert torch.equal(Pt.cubic_solve(z, z, z), z)


def test_cbrt_zero_and_negative():
    x = torch.tensor([0.0, -0.0, 8.0, -27.0, 1e-300], dtype=torch.float64)
    c = Pt.cbrt(x)
    assert c[0] == 0 and c[1] == 0
    # |x|^(1/3) with 1/3 rounded to a double: a few ulps off the true root.
    np.testing.assert_allclose(c[2:].numpy(), [2.0, -3.0, 1e-100], rtol=1e-13)
