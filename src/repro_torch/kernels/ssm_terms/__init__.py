"""Recurrence inputs of the Mamba-1 selective scan (no TPU counterpart)."""
from repro_torch.kernels.ssm_terms.ops import ssm_terms, ssm_terms_plain

__all__ = ["ssm_terms", "ssm_terms_plain"]
