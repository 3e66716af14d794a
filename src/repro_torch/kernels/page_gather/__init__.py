"""Paged gather (port of ``repro.kernels.page_gather``)."""
from repro_torch.kernels.page_gather.ops import page_gather, page_gather_plain

__all__ = ["page_gather", "page_gather_plain"]
