"""Matmul-precision control.

The equilibrated Gram matrix loses the accuracy that the direct projector
needs if float32 products run in TF32 (about three decimal digits), and the
splitting iterations then stall just above tolerance.  Solver init and solve
run inside :func:`highest_precision`, which turns TF32 off for matmuls and
cuDNN and pins ``torch.set_float32_matmul_precision("highest")``, and
restores the caller's settings on exit.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def highest_precision():
    """Context manager: full float32 matmul precision, TF32 off."""
    old_matmul = torch.backends.cuda.matmul.allow_tf32
    old_cudnn = torch.backends.cudnn.allow_tf32
    old_prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old_prec)
        torch.backends.cuda.matmul.allow_tf32 = old_matmul
        torch.backends.cudnn.allow_tf32 = old_cudnn
