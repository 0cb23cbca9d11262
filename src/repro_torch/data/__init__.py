"""Data plumbing shared by the engines: the bounded background
:class:`~repro_torch.data.pipeline.Prefetcher`."""
from repro_torch.data.pipeline import Prefetcher

__all__ = ["Prefetcher"]
