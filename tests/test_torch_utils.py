"""The port's checkpoint / resume, profiling and verbose output on the CPU
(device="cpu"), mirroring tests/test_utils.py, and checkpoints that cross
between the two packages.

A dense checkpoint written by either package loads in the other (the same
.npz layout and matrix fingerprint).  The warm solve from it is held to the
other package's warm solve from the same file, both from the JAX package's
init state, to the parity standard of tests/test_fused.py:54-63: the same
status and iteration count, optval within 1e-4 relative, x and z within
atol 2e-5.  tests/test_utils.py's test_published_tables_in_sync_with_artifacts
checks the JAX package's own published tables and has no twin here.
"""

import json
import os

import numpy as np
import pytest
import torch

from pogs_tpu.solver.graph import GraphFormSolver as JSolver
from pogs_tpu.types import (Function as JF, FunctionVector as JFV,
                            SolverSettings as JSet)
import pogs_tpu_torch as P
from pogs_tpu_torch import (
    Function, FunctionVector, GraphFormSolver, SolverSettings, Status,
    PhaseTimer,
)
from pogs_tpu_torch.utils.interop import init_state_from_numpy
from pogs_tpu_torch.utils.profiling import busy_time

torch.set_num_threads(1)


def _problem(m=40, n=20, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    f = FunctionVector(Function.SQUARE, m, b=b)
    g = FunctionVector(Function.ABS, n, c=0.3)
    return A, f, g


def _solver(A, **kw):
    return GraphFormSolver(A, device="cpu", **kw)


def test_checkpoint_roundtrip(tmp_path):
    A, f, g = _problem()
    st = SolverSettings(abs_tol=1e-6, rel_tol=1e-6)
    s1 = _solver(A, settings=st)
    r1 = s1.solve(f, g)
    assert r1.status == Status.SUCCESS
    path = tmp_path / "ckpt.npz"
    s1.save_state(path)

    # A fresh solver resumed from the checkpoint converges immediately.
    s2 = _solver(A, settings=st).load_state(path)
    r2 = s2.solve(f, g)
    assert r2.status == Status.SUCCESS
    assert int(r2.final_iter) <= max(3, int(r1.final_iter) // 5)
    assert float(r2.optval) == pytest.approx(float(r1.optval), rel=1e-5)


def test_checkpoint_rejects_wrong_matrix(tmp_path):
    A, f, g = _problem(seed=1)
    s1 = _solver(A)
    s1.solve(f, g)
    path = tmp_path / "ckpt.npz"
    s1.save_state(path)

    B, _, _ = _problem(seed=2)
    with pytest.raises(ValueError, match="different matrix"):
        _solver(B).load_state(path)
    # Same shape, strict off: allowed.
    _solver(B).load_state(path, strict=False)
    # Another shape is rejected even without strict.
    C, _, _ = _problem(m=30, seed=2)
    with pytest.raises(ValueError, match="checkpoint shape"):
        _solver(C).load_state(path, strict=False)


def test_checkpoint_requires_state(tmp_path):
    A, f, g = _problem()
    with pytest.raises(ValueError, match="no state"):
        _solver(A).save_state(tmp_path / "x.npz")


def test_checkpoint_loads_on_the_solvers_dtype(tmp_path):
    """A float64 checkpoint restored into a float32 solver of the same A
    (the fingerprint hashes A's float32 bytes in both)."""
    A, f, g = _problem()
    s1 = _solver(A)
    s1.solve(f, g)
    path = tmp_path / "ckpt.npz"
    s1.save_state(path)
    s2 = _solver(A, dtype=np.float32).load_state(path)
    assert s2._z.dtype == s2._zt.dtype == torch.float32
    assert s2._z.device.type == "cpu"
    np.testing.assert_array_equal(s2._z.numpy(), s1._z.numpy().astype(np.float32))
    assert s2.rho == s1.rho


def test_phase_timer():
    t = PhaseTimer()
    with t.phase("init"):
        pass
    with t.phase("solve"):
        pass
    with t.phase("solve"):
        pass
    assert t.counts["solve"] == 2
    s = t.summary()
    assert "init" in s and "solve" in s and "share" in s


def test_verbose_banner_and_summary(capsys):
    A, f, g = _problem()
    st = SolverSettings(verbose=1)
    res = _solver(A, settings=st).solve(f, g)
    out = capsys.readouterr().out
    assert "pogs_tpu" in out
    assert "status: SUCCESS" in out
    assert "optval" in out
    assert res.status == Status.SUCCESS


def test_device_time_runs():
    from pogs_tpu_torch import device_time

    calls = []

    def f(x):
        calls.append(1)
        return x * 2.0

    x = torch.ones(128)
    dt = device_time(f, x, reps=5, warmup=2)
    assert dt >= 0.0
    assert len(calls) == 1 + 2 + 5


def test_checkpoint_sparse_solver(tmp_path):
    sp = pytest.importorskip("scipy.sparse")
    A = sp.random(30, 15, density=0.4, random_state=5, format="csr")
    b = np.random.default_rng(0).standard_normal(30)
    f = FunctionVector(Function.SQUARE, 30, b=b)
    g = FunctionVector(Function.ABS, 15, c=0.1)
    s1 = _solver(A, sparse_policy="keep")
    r1 = s1.solve(f, g)
    assert r1.status == Status.SUCCESS
    path = tmp_path / "sparse_ckpt.npz"
    s1.save_state(path)
    s2 = _solver(A, sparse_policy="keep").load_state(path)
    assert s2.A.is_sparse
    r2 = s2.solve(f, g)
    assert r2.status == Status.SUCCESS
    assert int(r2.final_iter) <= int(r1.final_iter)
    # The sparse fingerprint covers the pattern as well as the values.
    B = A.copy()
    B.data = B.data[::-1].copy()
    with pytest.raises(ValueError, match="different matrix"):
        _solver(B, sparse_policy="keep").load_state(path)


def test_profiler_trace_writes(tmp_path):
    from pogs_tpu_torch import trace

    with trace(str(tmp_path)) as prof:
        torch.ones(64) * 2.0
    assert any(files for _, _, files in os.walk(tmp_path))
    with open(prof.trace_path) as fh:
        assert "traceEvents" in json.load(fh)


def test_busy_time_on_a_cpu_trace(tmp_path):
    """A window traced on the CPU holds no CUDA kernel: idle share 1."""
    from pogs_tpu_torch import trace

    with trace(str(tmp_path)) as prof:
        with torch.profiler.record_function("window"):
            torch.ones(256) @ torch.ones(256)
    rec = busy_time(prof.trace_path, "window")
    assert rec["window_ms"] > 0
    assert rec["kernel_ms"] == 0.0 and rec["kernels"] == 0
    assert rec["idle_share"] == 1.0
    with pytest.raises(ValueError, match="no event named"):
        busy_time(prof.trace_path, "missing")


def test_busy_time_takes_the_union_inside_the_window(tmp_path):
    """Kernels that overlap count once, and only their part in the window."""
    events = [
        {"name": "window", "ph": "X", "cat": "user_annotation", "ts": 100.0, "dur": 100.0},
        {"name": "k1", "ph": "X", "cat": "kernel", "ts": 90.0, "dur": 20.0},   # 10 inside
        {"name": "k2", "ph": "X", "cat": "kernel", "ts": 120.0, "dur": 20.0},  # 120-140
        {"name": "k2", "ph": "X", "cat": "kernel", "ts": 130.0, "dur": 20.0},  # 140-150 new
        {"name": "k3", "ph": "X", "cat": "kernel", "ts": 190.0, "dur": 30.0},  # 10 inside
        {"name": "k4", "ph": "X", "cat": "kernel", "ts": 300.0, "dur": 5.0},   # outside
        {"name": "memcpy", "ph": "X", "cat": "gpu_memcpy", "ts": 150.0, "dur": 10.0},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    rec = busy_time(str(path), "window")
    assert rec["window_ms"] == pytest.approx(0.1)
    assert rec["kernel_ms"] == pytest.approx(0.05)
    assert rec["idle_share"] == pytest.approx(0.5)
    assert rec["kernels"] == 4
    assert rec["kernel_ms_by_name"] == pytest.approx({"k1": 0.01, "k2": 0.04, "k3": 0.01})


# ---------------------------------------------------------------------------
# Checkpoints across the packages.
# ---------------------------------------------------------------------------

M, N = 60, 40
_RNG = np.random.default_rng(11)
A0 = _RNG.standard_normal((M, N))
B0 = _RNG.standard_normal(M)
LAM = 0.2 * float(np.max(np.abs(A0.T @ B0)))
TOL = dict(abs_tol=1e-6, rel_tol=1e-6)


def _jax_solver():
    return JSolver(A0, settings=JSet(use_fused=False, **TOL))


def _port_solver(js):
    """A port solver on the JAX solver's init state."""
    js.init()
    init = js._init_state
    ps = _solver(A0, settings=SolverSettings(**TOL))
    ps.load_init_state(init_state_from_numpy({
        "A": np.asarray(init["A"].dense()), "d": np.asarray(init["d"]),
        "e": np.asarray(init["e"]), "norm_A": np.asarray(init["norm_A"]),
        "factor": {"op": np.asarray(init["factor"]["op"])},
    }, device="cpu"))
    return ps


def _warm_solves(path):
    """Both packages' warm solves from the checkpoint at ``path``, at a
    smaller λ than the one the checkpoint was solved at."""
    js = _jax_solver().load_state(path)
    ps = _port_solver(js).load_state(path)
    rj = js.solve(JFV(JF.SQUARE, M, b=B0), JFV(JF.ABS, N, c=0.6 * LAM))
    rp = ps.solve(FunctionVector(Function.SQUARE, M, b=B0),
                  FunctionVector(Function.ABS, N, c=0.6 * LAM))
    return (js, rj), (ps, rp)


def _assert_parity(js, rj, ps, rp):
    assert rp.status == Status(int(rj.status)) == Status.SUCCESS
    assert int(rp.final_iter) == int(rj.final_iter)
    assert float(rp.optval) == pytest.approx(float(rj.optval), rel=1e-4)
    np.testing.assert_allclose(rp.x.numpy(), np.asarray(rj.x), atol=2e-5)
    np.testing.assert_allclose(ps._z.numpy(), np.asarray(js._z), atol=2e-5)
    np.testing.assert_allclose(ps._zt.numpy(), np.asarray(js._zt), atol=2e-5)
    assert ps.rho == pytest.approx(js.rho, rel=1e-12)


def test_checkpoint_from_jax_loads_in_the_port(tmp_path):
    js = _jax_solver()
    assert int(js.solve(JFV(JF.SQUARE, M, b=B0), JFV(JF.ABS, N, c=LAM)).status) == 0
    path = tmp_path / "jax.npz"
    js.save_state(path)
    (js2, rj), (ps, rp) = _warm_solves(path)
    _assert_parity(js2, rj, ps, rp)


def test_checkpoint_from_the_port_loads_in_jax(tmp_path):
    ps = _port_solver(_jax_solver())
    r = ps.solve(FunctionVector(Function.SQUARE, M, b=B0), FunctionVector(Function.ABS, N, c=LAM))
    assert r.status == Status.SUCCESS
    path = tmp_path / "port.npz"
    ps.save_state(path)
    data = np.load(path)
    assert sorted(data.files) == ["fingerprint", "rho", "shape", "z", "zt"]
    (js, rj), (ps2, rp) = _warm_solves(path)
    _assert_parity(js, rj, ps2, rp)
    # The port's checkpoint carries the JAX package's fingerprint of A.
    from pogs_tpu.utils.checkpoint import _fingerprint as jax_fingerprint

    assert str(data["fingerprint"]) == jax_fingerprint(JSolver(A0).A)


def test_checkpoint_cross_rejects_another_matrix(tmp_path):
    """A JAX checkpoint of another A is refused by the port under strict."""
    js = _jax_solver()
    js.solve(JFV(JF.SQUARE, M, b=B0), JFV(JF.ABS, N, c=LAM))
    path = tmp_path / "jax.npz"
    js.save_state(path)
    with pytest.raises(ValueError, match="different matrix"):
        _solver(A0 + 1e-3).load_state(path)
    assert P.load_state(_solver(A0), path).rho == js.rho
