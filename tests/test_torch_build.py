"""Building the CUDA kernels (pogs_tpu_torch/ops/_build.py) where no compiler
runs: it raises and leaves no file behind."""

import os

import pytest

from pogs_tpu_torch.ops import _build


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_LIBS", {})
    return tmp_path / "kernels"


def test_missing_nvcc_raises_and_leaves_no_file(build_dir, monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(tmp_path / "no" / "nvcc"))
    build_dir.mkdir()
    (build_dir / "keep.txt").write_text("x")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("fused_admm_sweep")
    assert sorted(os.listdir(build_dir)) == ["keep.txt"]


def test_nvcc_that_does_not_start_leaves_no_file(build_dir, monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("not a program")
    fake.chmod(0o644)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    with pytest.raises(OSError):
        _build.load_all(["fused_admm", "fused_admm_sweep"])
    assert os.listdir(build_dir) == []
