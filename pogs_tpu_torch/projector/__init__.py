"""Graph projectors."""

from pogs_tpu_torch.projector.direct import DirectProjector
from pogs_tpu_torch.projector.indirect import CglsProjector

__all__ = ["DirectProjector", "CglsProjector"]
