"""Optimizer, schedule and gradient compression (port of ``repro.optim``)."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from repro_torch.optim.compression import (
    CompressionConfig,
    compress_gradients,
    decompress_gradients,
    init_error_feedback,
)
from repro_torch.optim.schedule import cosine_schedule

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "global_norm", "cosine_schedule",
    "CompressionConfig", "compress_gradients", "decompress_gradients",
    "init_error_feedback",
]
