"""Utilities: precision control, state interop, checkpoint / resume and
profiling."""

from pogs_tpu_torch.utils.precision import highest_precision
from pogs_tpu_torch.utils.interop import init_state_from_numpy
from pogs_tpu_torch.utils.checkpoint import save_state, load_state
from pogs_tpu_torch.utils.profiling import trace, busy_time, PhaseTimer, device_time

__all__ = ["highest_precision", "init_state_from_numpy", "save_state", "load_state",
           "trace", "busy_time", "PhaseTimer", "device_time"]
