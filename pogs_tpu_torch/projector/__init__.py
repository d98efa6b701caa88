"""Graph projectors."""

from pogs_tpu_torch.projector.direct import DirectProjector

__all__ = ["DirectProjector"]
