"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

Importing this package builds nothing: a kernel is compiled at its first
launch (``kernels/build.py``).
"""
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain
from repro_torch.kernels.diag_recurrence import diag_recurrence, diag_recurrence_plain
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.fleet_scan import fleet_scan, fleet_scan_plain
from repro_torch.kernels.page_gather import page_gather, page_gather_plain
from repro_torch.kernels.ssm_terms import ssm_terms, ssm_terms_plain

__all__ = ["decode_attention", "decode_attention_plain", "diag_recurrence",
           "diag_recurrence_plain", "flash_attention", "flash_attention_plain",
           "fleet_scan", "fleet_scan_plain",
           "page_gather", "page_gather_plain", "ssm_terms", "ssm_terms_plain"]
