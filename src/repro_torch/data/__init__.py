"""Synthetic training data (port of ``repro.data``)."""
from repro_torch.data.pipeline import (
    DataConfig,
    SyntheticTokenPipeline,
    batch_to_torch,
    make_batch_specs,
)

__all__ = ["DataConfig", "SyntheticTokenPipeline", "batch_to_torch", "make_batch_specs"]
