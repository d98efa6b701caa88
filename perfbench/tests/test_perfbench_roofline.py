"""roofline.py gives chip_smoke.py's numbers, from which it was copied."""

import importlib.util

import pytest

from perfbench import harness, roofline


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_copy_source",
                                                  harness.ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("iters", [1, 173, 2500])
def test_solve_work_5000x2500(smoke, iters):
    args = (5000, 2500, iters, 1, 4)
    assert roofline.solve_work(*args) == smoke.solve_work(*args)
    assert roofline.bound_ms(*roofline.solve_work(*args), "float32") == smoke.bound_ms(
        *smoke.solve_work(*args), "float32")


def test_sweep_5000x2500(smoke):
    import torch

    out = {"status": torch.tensor([0] * 30 + [1, 1]),
           "final_iter": torch.tensor(list(range(100, 132)))}
    iters = int((out["final_iter"] + 1).sum())
    ours = roofline.bound_ms(*roofline.sweep_work(5000, 2500, iters, 30, 32, 4), "float32")
    assert ours == smoke.sweep_bound(out, 5000, 2500, 4, False)


def test_peaks(smoke):
    assert roofline.PEAK_BYTES == smoke.PEAK_BYTES
    assert roofline.PEAK_FLOPS == smoke.PEAK_FLOPS
