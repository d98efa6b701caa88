"""pogs_tpu_torch types against pogs_tpu's: enum values, settings defaults,
and the package's import hygiene (no jax, no pogs_tpu)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pogs_tpu.types as J
import pogs_tpu_torch.types as P

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["Function", "Cone", "Status"])
def test_enum_values_match(name):
    # The C ABI exposes these integers: names and values must be equal.
    jx, pt = getattr(J, name), getattr(P, name)
    assert [(e.name, int(e)) for e in jx] == [(e.name, int(e)) for e in pt]


def test_settings_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(J.SolverSettings)}
    pf = {f.name: f.default for f in dataclasses.fields(P.SolverSettings)}
    assert jf == pf
    st = P.SolverSettings().replace(max_iter=7)
    assert st.max_iter == 7 and st.abs_tol == J.SolverSettings().abs_tol


def test_import_pulls_in_no_jax():
    code = ("import sys, pogs_tpu_torch, pogs_tpu_torch.parallel, pogs_tpu_torch.cones, "
            "pogs_tpu_torch.solver.hsde, pogs_tpu_torch.solver.cone, pogs_tpu_torch.api.cone, "
            "pogs_tpu_torch.ops.fused_hsde, pogs_tpu_torch.api.qp, pogs_tpu_torch.solver.qp_ipm, "
            "pogs_tpu_torch.solver.qp_polish, pogs_tpu_torch.utils.qps; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'pogs_tpu' or m.startswith('pogs_tpu.')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_function_vector_clamps_and_broadcast():
    fv = P.FunctionVector(P.Function.ABS, 4, a=2.0, c=[-1.0, 1.0, 2.0, -3.0],
                          e=-0.5, dtype=np.float32)
    ref = J.FunctionVector(J.Function.ABS, 4, a=2.0, c=[-1.0, 1.0, 2.0, -3.0],
                           e=-0.5, dtype=np.float32)
    assert fv.h.dtype == np.int32 and fv.n == 4
    for p, r in zip(fv.params, ref.params):
        assert p.dtype == torch.float32
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    with pytest.raises(ValueError):
        P.FunctionVector([0, 1, 2], n=4)
    with pytest.raises(ValueError):
        P.FunctionVector(P.Function.ABS, 3, b=[1.0, 2.0])


def test_function_obj_and_from_objs():
    objs = [P.FunctionObj(P.Function.SQUARE, b=1.0), P.FunctionObj(P.Function.ABS, c=-2.0)]
    assert objs[1].c == 0.0
    fv = P.FunctionVector.from_objs(objs)
    np.testing.assert_array_equal(fv.h, [14, 0])
    np.testing.assert_array_equal(fv.b.numpy(), [1.0, 0.0])


def test_solver_result_as_dict():
    t = torch.arange(3, dtype=torch.float64)
    res = P.SolverResult(x=t, y=t, mu=t, nu=t, optval=torch.tensor(1.5),
                         final_iter=torch.tensor(7), status=P.Status.SUCCESS,
                         solve_time=0.25)
    d = res.as_dict()
    assert set(d) == {"x", "y", "mu", "l", "optval", "iterations", "status", "solve_time"}
    assert d["iterations"] == 7 and d["status"] == 0 and d["optval"] == 1.5
    assert isinstance(d["x"], np.ndarray)
