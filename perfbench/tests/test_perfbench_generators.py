"""The inputs' protocols at a tiny size on the CPU: the lasso's data as benchmarks/problems.py makes them, the same from the same
seed (large seeds included), and a request made again bit for bit."""

import math

import pytest
import torch

from perfbench import data
from perfbench.problems import lasso

BIG = 2 ** 33 + 12345
LASSO = dict(m=3000, n=400, dtype="float32", sparsity=0.9, noise=0.1, lambda_ratio=0.1)


def test_stream_seeds():
    assert data.stream_seed(BIG, data.REQUEST, 3) == data.stream_seed(BIG, data.REQUEST, 3)
    assert data.stream_seed(BIG, data.REQUEST, 3) != data.stream_seed(BIG, data.REQUEST, 4)
    assert data.stream_seed(BIG, data.MATRIX) != data.stream_seed(BIG + 2 ** 32, data.MATRIX)
    assert 0 <= data.stream_seed(2 ** 31 + 7, data.WARMUP) < 2 ** 63
    with pytest.raises(ValueError):
        data.stream_seed(-1)


def test_sample_holds_the_must_and_is_drawn_from_the_seed():
    s = data.sample(BIG, 50, 8, must=[42])
    assert len(s) == 8 and 42 in s and s == sorted(s)
    assert s == data.sample(BIG, 50, 8, must=[42])
    assert data.sample(3, 5, 8) == [0, 1, 2, 3, 4]


def test_lasso_protocol():
    gen = data.generator("cpu", BIG, data.MATRIX)
    A = lasso.make_matrix(LASSO, gen, "cpu")
    assert A.shape == (3000, 400) and A.dtype == torch.float32
    assert abs(float(A.mean())) < 0.01 and abs(float(A.std()) - 1) < 0.01
    gen = data.generator("cpu", BIG, data.REQUEST, 0)
    b, lam_max = lasso.make_response(LASSO, A, gen)
    # Made again from the same stream: the same x_true, noise and b.
    gen = data.generator("cpu", BIG, data.REQUEST, 0)
    x_true = torch.randn(400, generator=gen)
    x_true = x_true * (torch.rand(400, generator=gen) >= 0.9)
    noise = torch.randn(3000, generator=gen)
    assert 0.04 < float((x_true != 0).float().mean()) < 0.17
    assert torch.allclose(b, A @ x_true + 0.1 * noise, atol=1e-4)
    assert float(lam_max) == pytest.approx(float((A.T @ b).abs().max()), rel=1e-6)
    b2, _ = lasso.make_response(LASSO, A, data.generator("cpu", BIG, data.REQUEST, 0))
    assert torch.equal(b, b2)
    b3, _ = lasso.make_response(LASSO, A, data.generator("cpu", BIG, data.REQUEST, 1))
    assert not torch.equal(b, b3)


def test_path_ladder_is_glmnets():
    import pogs_tpu_torch as P

    e = lasso.Path(P, dict(LASSO, m=40, n=20, abs_tol=1e-4, rel_tol=1e-3, max_iter=2500,
                           gap_stop=False, adaptive_rho=True, rho=1.0),
                   {"nlambda": 100, "lambda_min_ratio": 1e-4}, BIG, "cpu")
    e.setup()
    req = e.request(0)
    lam = req["lams"].double()
    lam_max = float(lam[0])
    assert lam.shape == (100,)
    assert float(lam[-1]) == pytest.approx(1e-4 * lam_max, rel=1e-5)
    assert float(lam[50]) == pytest.approx(lam_max * 1e-4 ** (50 / 99), rel=1e-5)
    assert lam_max == pytest.approx(float((e.A.T @ req["b"]).abs().max()), rel=1e-6)
