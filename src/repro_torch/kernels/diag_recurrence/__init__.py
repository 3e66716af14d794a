"""Diagonal linear recurrence (port of ``repro.kernels.diag_recurrence``)."""
from repro_torch.kernels.diag_recurrence.ops import diag_recurrence, diag_recurrence_plain

__all__ = ["diag_recurrence", "diag_recurrence_plain"]
