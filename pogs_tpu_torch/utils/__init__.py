"""Utilities: precision control, state interop, checkpoint / resume,
profiling and the QPS reader / writer."""

from pogs_tpu_torch.utils.precision import highest_precision
from pogs_tpu_torch.utils.interop import init_state_from_numpy
from pogs_tpu_torch.utils.checkpoint import save_state, load_state
from pogs_tpu_torch.utils.profiling import trace, busy_time, PhaseTimer, device_time
from pogs_tpu_torch.utils.qps import load_qps, loads_qps, qps_to_solve_qp_kwargs, save_qps

__all__ = ["highest_precision", "init_state_from_numpy", "save_state", "load_state",
           "trace", "busy_time", "PhaseTimer", "device_time", "load_qps", "loads_qps",
           "qps_to_solve_qp_kwargs", "save_qps"]
