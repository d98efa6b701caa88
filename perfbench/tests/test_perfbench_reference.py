"""The plain reference against closed forms at tiny sizes on the CPU."""

import numpy as np
import pytest
import torch

from perfbench.reference import admm, lasso as rl


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0 - 2 ** -12,
                      1e-30, 0.0], dtype=torch.float32)
    r = admm.tf32_round(x)
    # Ten mantissa bits: a tie rounds to even, anything else to nearest.
    assert r.tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0, r[5].item(), 0.0]
    assert abs(r[5].item() - 1e-30) <= 1e-30 * 2 ** -11
    y = torch.randn(1000)
    assert float(((admm.tf32_round(y) - y).abs() / y.abs()).max()) <= 2 ** -11


def test_lasso_orthogonal_design_closed_form():
    # With orthonormal columns the lasso's answer is soft(Aᵀb, λ).
    gen = torch.Generator().manual_seed(3)
    Q, _ = torch.linalg.qr(torch.randn(60, 20, dtype=torch.float64, generator=gen))
    b = torch.randn(60, 3, dtype=torch.float64, generator=gen)
    lams = torch.tensor([0.1, 0.5, 1.0], dtype=torch.float64)
    normal = rl.Normal(Q)
    X, kkt = normal.optimum(b, lams)
    atb = Q.T @ b
    want = torch.sign(atb) * torch.clamp(atb.abs() - lams, min=0)
    assert torch.allclose(X, want, atol=1e-10)
    assert float(kkt.max()) < 1e-9


def test_lasso_optimum_satisfies_its_conditions():
    gen = torch.Generator().manual_seed(4)
    A = torch.randn(80, 40, dtype=torch.float64, generator=gen)
    b = torch.randn(80, 2, dtype=torch.float64, generator=gen)
    normal = rl.Normal(A)
    lam_max = (A.T @ b).abs().max(dim=0).values
    lams = torch.stack([0.1 * lam_max[0], 1e-3 * lam_max[1]])
    X, kkt = normal.optimum(b, lams)
    assert float(kkt.max()) < 1e-9
    # The objective is no lower anywhere near.
    f = normal.objective(b, lams, X)
    for _ in range(5):
        Y = X + 1e-3 * torch.randn(X.shape, dtype=torch.float64, generator=gen)
        assert torch.all(normal.objective(b, lams, Y) >= f - 1e-12)


@pytest.mark.parametrize("precision", ["float32", "tf32"])
def test_lower_precisions_run(precision):
    gen = torch.Generator().manual_seed(7)
    A = torch.randn(50, 20, generator=gen)
    b = torch.randn(50, 1, generator=gen)
    res = rl.solve(A, b, torch.tensor([0.5]), 1e-4, 1e-3, 2500, precision)
    assert res.x.dtype == torch.float32 and int(res.status[0]) in (admm.SUCCESS, admm.MAX_ITER)
