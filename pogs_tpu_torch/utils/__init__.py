"""Utilities: precision control and state interop."""

from pogs_tpu_torch.utils.precision import highest_precision
from pogs_tpu_torch.utils.interop import init_state_from_numpy

__all__ = ["highest_precision", "init_state_from_numpy"]
