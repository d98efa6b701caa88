"""Build and load the package's CUDA kernels.

Each kernel source in ``pogs_tpu_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (sm_90a) into a shared library with a plain C interface, at first
use, and loaded with ``ctypes``.  The library lands in ``build/pogs_tpu_torch/``
at the root of the checkout, named by a hash of the source, of every shared
header (``csrc/*.cuh``) and of the flags, so a changed source or header
rebuilds and an unchanged one loads at once.  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pogs_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict = {}
# The compiler's output (registers, shared memory, spills) of each build.
BUILD_LOGS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def _start(name: str):
    """Start nvcc on ``csrc/<name>.cu`` into a temporary file; returns
    (process, temporary path, library path).  Raises before it creates
    any file when there is no nvcc, and removes the temporary file when
    the compiler does not start."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except BaseException:
        os.unlink(tmp)
        raise
    return proc, tmp, library_path(name)


def _finish(name: str, proc, tmp: str, out: Path):
    try:
        BUILD_LOGS[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}.cu:\n{BUILD_LOGS[name]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_all(names) -> dict:
    """Build every missing library of ``names`` at once (one nvcc each,
    started together), and load them all.  Returns {name: CDLL}."""
    started, errors = {}, []
    try:
        for name in names:
            if name not in _LIBS and not library_path(name).exists():
                started[name] = _start(name)
    finally:
        # Wait for every compiler started, even when one of them failed.
        for name, (proc, tmp, out) in started.items():
            try:
                _finish(name, proc, tmp, out)
            except RuntimeError as exc:
                errors.append(exc)
    if errors:
        raise errors[0]
    for name in names:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return {name: _LIBS[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, and load it."""
    return load_all([name])[name]
