"""The port's fused_admm_loop against pogs_tpu's Pallas kernel (interpret
mode on the CPU), on bit-identical scaled inputs.

The JAX package makes the init state (equilibrated A, Ginv, ‖A‖₂) and the
scaled objective; ``init_state_from_numpy`` carries them over.  On CPU
tensors the port's wrapper runs the kernel's plain version (the eager loop
with the inverse projector).

Tolerances, as tests/test_fused.py holds the Pallas kernel to the XLA loop:
  * float64: the same status and iteration count, x12 and z within 1e-9;
  * float32: the same status, iterations within 2 (sums run in another
    order in torch's CPU BLAS and in XLA), optval within 1e-4 relative,
    x12 and z within 2e-5 (5e-5 for logistic).
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pogs_tpu.types import Function as JF, FunctionVector as JFV, SolverSettings as JSet
from pogs_tpu.prox.vector import scale_f as j_scale_f, scale_g as j_scale_g
from pogs_tpu.linalg.equil import equilibrate as j_equilibrate
from pogs_tpu.linalg.norm import norm2_est as j_norm2_est
from pogs_tpu.projector.direct import DirectProjector as JProj
from pogs_tpu.ops.fused_admm import fused_admm_loop as j_fused
from pogs_tpu.solver.graph import GraphFormSolver as JSolver

import pogs_tpu_torch as P
from pogs_tpu_torch.ops import fused_admm as pf
from pogs_tpu_torch.utils.interop import init_state_from_numpy

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NP = {"f32": np.float32, "f64": np.float64}


def _psettings(st):
    return P.SolverSettings(**dataclasses.asdict(st))


def _both(A, f_spec, g_spec, st, dt):
    """Run the Pallas kernel and the port's wrapper on identical inputs."""
    m, n = A.shape
    Aj = jnp.asarray(A, dt)
    eq = j_equilibrate(Aj)
    nA = j_norm2_est(eq.A)
    fac = JProj().init(eq.A, s=1.0)
    f = JFV(f_spec[0], m, dtype=dt, **f_spec[1])
    g = JFV(g_spec[0], n, dtype=dt, **g_spec[1])
    f_s = j_scale_f(f, eq.d)
    g_s = j_scale_g(g, eq.e)
    fpar = tuple(jnp.asarray(p, dt) for p in f_s.params)
    gpar = tuple(jnp.asarray(p, dt) for p in g_s.params)
    z0 = jnp.zeros((m + n,), dt)
    ref = j_fused(eq.A, fac["op"], nA, f.h, fpar, g.h, gpar, st, z0, z0, 1.0,
                  interpret=True)

    state = init_state_from_numpy({"A": np.asarray(eq.A), "d": np.asarray(eq.d),
                                   "e": np.asarray(eq.e), "norm_A": np.asarray(nA),
                                   "factor": {"op": np.asarray(fac["op"])}},
                                  device="cpu")
    tz = torch.zeros(m + n, dtype=state["A"].dtype)
    out = pf.fused_admm_loop(
        state["A"], state["factor"]["op"], state["norm_A"],
        f.h, tuple(torch.tensor(np.asarray(p)) for p in fpar),
        g.h, tuple(torch.tensor(np.asarray(p)) for p in gpar),
        _psettings(st), tz, tz, 1.0)
    return ref, out


def _assert_match(ref, out, dtype, atol32=2e-5):
    it_r, it_o = int(ref["final_iter"]), int(out["final_iter"])
    assert int(ref["status"]) == int(out["status"])
    if dtype == "f64":
        assert it_r == it_o
        atol = 1e-9
    else:
        assert abs(it_r - it_o) <= 2
        atol = atol32
    assert float(out["optval"]) == pytest.approx(float(ref["optval"]), rel=1e-4)
    for key in ("x12", "z", "zt"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=atol)
    return it_r, it_o


@pytest.fixture
def rng7():
    return np.random.default_rng(7)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_fused_lasso_tall(rng7, dtype):
    A, b = rng7.standard_normal((60, 40)), rng7.standard_normal(60)
    ref, out = _both(A, (JF.SQUARE, {"b": b}), (JF.ABS, {"c": 0.5}),
                     JSet(max_iter=400), _NP[dtype])
    _assert_match(ref, out, dtype)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_fused_lasso_wide(rng7, dtype):
    A, b = rng7.standard_normal((30, 70)), rng7.standard_normal(30)
    ref, out = _both(A, (JF.SQUARE, {"b": b}), (JF.ABS, {"c": 0.3}),
                     JSet(max_iter=400), _NP[dtype])
    _assert_match(ref, out, dtype)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_fused_logistic(rng7, dtype):
    A = rng7.standard_normal((50, 20))
    labels = np.sign(rng7.standard_normal(50))
    ref, out = _both(A, (JF.LOGISTIC, {"a": -labels}), (JF.ABS, {"c": 0.2}),
                     JSet(max_iter=400), _NP[dtype])
    _assert_match(ref, out, dtype, atol32=5e-5)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_fused_nonneg_gapstop(rng7, dtype):
    A, b = rng7.standard_normal((40, 25)), rng7.standard_normal(40)
    ref, out = _both(A, (JF.SQUARE, {"b": b}), (JF.INDGE0, {}),
                     JSet(max_iter=400, gap_stop=True), _NP[dtype])
    _assert_match(ref, out, dtype)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_fused_max_iter_status(rng7, dtype):
    A, b = rng7.standard_normal((40, 25)), rng7.standard_normal(40)
    ref, out = _both(A, (JF.SQUARE, {"b": b}), (JF.ABS, {"c": 0.5}),
                     JSet(max_iter=5), _NP[dtype])
    _assert_match(ref, out, dtype)
    assert int(out["status"]) == int(P.Status.MAX_ITER)
    assert int(out["final_iter"]) == 4


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_fused_warm_lambda_path(rng7, dtype):
    """Warm-started repeat solves through the fused path on one solver,
    from the JAX solver's own init state."""
    dt = _NP[dtype]
    A, b = rng7.standard_normal((40, 24)).astype(dt), rng7.standard_normal(40)
    st = JSet(max_iter=600, use_fused=True)
    js = JSolver(A, dtype=dt, settings=st).init()
    init = js._init_state
    exported = {"A": np.asarray(init["A"].dense()), "d": np.asarray(init["d"]),
                "e": np.asarray(init["e"]), "norm_A": np.asarray(init["norm_A"]),
                "factor": {"op": np.asarray(init["factor"]["op"])}}
    ps = P.GraphFormSolver(A, dtype=dt, device="cpu", settings=_psettings(st))
    ps.load_init_state(init_state_from_numpy(exported, device="cpu"))
    f_j = JFV(JF.SQUARE, 40, b=b, dtype=dt)
    f_p = P.FunctionVector(P.Function.SQUARE, 40, b=b, dtype=dt)
    seq_j, seq_p = [], []
    for frac in (1.0, 0.7, 0.5):
        rj = js.solve(f_j, JFV(JF.ABS, 24, c=frac * 0.6, dtype=dt))
        rp = ps.solve(f_p, P.FunctionVector(P.Function.ABS, 24, c=frac * 0.6, dtype=dt))
        assert int(rj.status) == int(rp.status) == 0
        seq_j.append(int(rj.final_iter))
        seq_p.append(int(rp.final_iter))
        atol = 1e-9 if dtype == "f64" else 5e-5
        np.testing.assert_allclose(rp.x.numpy(), np.asarray(rj.x), atol=atol)
    if dtype == "f64":
        assert seq_p == seq_j
    else:
        assert all(abs(a - c) <= 2 for a, c in zip(seq_p, seq_j))
    assert min(seq_p[1:]) <= seq_p[0]


def test_wrapper_raises_instead_of_falling_back():
    """A CUDA request where there is no CUDA raises; nothing runs the plain
    version in its place."""
    A = torch.eye(3, dtype=torch.float32)
    before = pf.fused_admm_loop.launches
    with pytest.raises((RuntimeError, AssertionError)):
        # The launch path itself (as a CUDA tensor would take it): it must
        # build and launch the kernel, and here it cannot.
        pf._launch(A, torch.eye(3), torch.tensor(1.0), np.zeros(3, np.int32),
                   (A[0],) * 5, np.zeros(3, np.int32), (A[0],) * 5,
                   P.SolverSettings(), torch.zeros(6), torch.zeros(6), 1.0, None)
    with pytest.raises(ValueError):
        pf.fused_admm_loop(A.to("meta"), torch.eye(3), 1.0, np.zeros(3, np.int32),
                           (A[0],) * 5, np.zeros(3, np.int32), (A[0],) * 5,
                           P.SolverSettings(), torch.zeros(6), torch.zeros(6), 1.0)
    # Malformed input is refused before anything is built or launched.
    ok_h, bad_h = np.zeros(3, np.int32), np.zeros(2, np.int32)
    for h_f, h_g in ((bad_h, ok_h), (ok_h, np.full(3, 16, np.int32))):
        with pytest.raises(ValueError):
            pf._launch(A, torch.eye(3), torch.tensor(1.0), h_f, (A[0],) * 5, h_g,
                       (A[0],) * 5, P.SolverSettings(), torch.zeros(6), torch.zeros(6),
                       1.0, None)
    with pytest.raises(ValueError):
        pf._launch(A, torch.eye(2), torch.tensor(1.0), ok_h, (A[0],) * 5, ok_h,
                   (A[0],) * 5, P.SolverSettings(), torch.zeros(6), torch.zeros(6), 1.0, None)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            P.solve_lasso(np.eye(3, dtype=np.float32), np.ones(3), 0.1)  # default: cuda
        with pytest.raises((RuntimeError, AssertionError)):
            P.GraphFormSolver(np.eye(3), device="cuda")
    assert pf.fused_admm_loop.launches == before


def test_use_fused_gates():
    from pogs_tpu_torch.solver.graph import _use_fused

    st = P.SolverSettings()
    f32 = torch.float32
    assert _use_fused(f32, "cuda", st, "inverse")
    assert _use_fused(torch.float64, "cuda", st, "inverse")
    assert not _use_fused(f32, "cpu", st, "inverse")
    assert not _use_fused(f32, "cuda", st, "cholesky")
    assert not _use_fused(torch.float16, "cuda", st, "inverse")
    assert not _use_fused(f32, "cuda", st.replace(use_anderson=True), "inverse")
    assert not _use_fused(f32, "cuda", st.replace(use_fused=False), "inverse")
    # Forcing on CPU takes the wrapper, which runs the plain version there.
    assert _use_fused(f32, "cpu", st.replace(use_fused=True), "inverse")
    with pytest.raises(ValueError):
        _use_fused(f32, "cpu", st.replace(use_fused=True, use_exact_tol=True), "inverse")


def test_cuda_source_names_every_function_code():
    # The prox library of both kernels lives in one shared header.
    src = open(os.path.join(ROOT, "pogs_tpu_torch", "csrc", "prox.cuh")).read()
    enum = dict(re.findall(r"\b([A-Z0-9]+) = (\d+)", src.split("enum Fn")[1].split("};")[0]))
    assert {k: int(v) for k, v in enum.items()} == {f.name: int(f) for f in P.Function}
    for fn_name in ("prox_base", "func_base"):
        body = src.split(f"__device__ T {fn_name}(")[1].split("\n}\n")[0]
        cases = set(re.findall(r"case ([A-Z0-9]+):", body))
        assert cases == {f.name for f in P.Function}, fn_name
