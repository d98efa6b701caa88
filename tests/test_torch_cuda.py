"""The fused solve kernel on the card against its plain version.

Marked ``cuda``: every test skips where torch sees no CUDA device.  On a
machine with one:  python -m pytest tests/test_torch_cuda.py -q

Tolerances, kernel against the eager loop on the same card and inputs: the
same status, iterations within 2 (the kernel sums in another order),
optval within 1e-4 relative, x12 and z within 5e-5·max(1, ‖·‖∞).
"""

import numpy as np
import pytest
import torch

import pogs_tpu_torch as P
from pogs_tpu_torch.ops import fused_admm as pf

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(A, f, g, dtype):
    from pogs_tpu_torch.prox.vector import scale_f, scale_g

    solver = P.GraphFormSolver(A, dtype=dtype, device="cuda").init()
    st = solver._init_state

    def cast(fv):
        return fv.replace_params(*(p.to(device="cuda", dtype=dtype) for p in fv.params))

    return st, scale_f(cast(f), st["d"]), scale_g(cast(g), st["e"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [(60, 40), (30, 70)], ids=["tall", "wide"])
def test_kernel_matches_plain(cuda, shape, dtype):
    rng = np.random.default_rng(7)
    m, n = shape
    A = rng.standard_normal(shape)
    f = P.FunctionVector(P.Function.SQUARE, m, b=rng.standard_normal(m))
    g = P.FunctionVector(P.Function.ABS, n, c=0.4)
    st, f_s, g_s = _inputs(A, f, g, dtype)
    z0 = torch.zeros(m + n, dtype=dtype, device=cuda)
    args = (st["A"], st["factor"]["op"], st["norm_A"], f.h, tuple(f_s.params),
            g.h, tuple(g_s.params), P.SolverSettings(max_iter=500), z0, z0, 1.0)
    before = pf.fused_admm_loop.launches
    out = pf.fused_admm_loop(*args)
    ref = pf.fused_admm_loop_ref(*args)
    torch.cuda.synchronize()
    assert pf.fused_admm_loop.launches == before + 1
    assert int(out["status"]) == int(ref["status"]) == 0
    assert abs(int(out["final_iter"]) - int(ref["final_iter"])) <= 2
    assert float(out["optval"]) == pytest.approx(float(ref["optval"]), rel=1e-4)
    for key in ("x12", "z"):
        lim = 5e-5 * max(1.0, float(ref[key].abs().max()))
        assert float((out[key] - ref[key]).abs().max()) <= lim


def test_main_path_launches_kernel_once_per_solve(cuda):
    rng = np.random.default_rng(1)
    A = rng.standard_normal((80, 50)).astype(np.float32)
    b = rng.standard_normal(80).astype(np.float32)
    before = pf.fused_admm_loop.launches
    r = P.solve_lasso(A, b, 0.2 * float(np.max(np.abs(A.T @ b))))
    assert pf.fused_admm_loop.launches == before + 1
    assert r["status"] == int(P.Status.SUCCESS)
