"""Serving steps over the model (port of ``repro.models.api``, serving half).

Each ``make_*`` returns a plain callable; PyTorch runs eagerly, so there is no
jit around it. A batch is a dict: ``"tokens"``, and for the stub frontends
``"frames"`` (whisper's audio frames) or ``"patches"`` (a VLM's image
patches), as the reference's batches carry them. The loss and the train step
come with the training slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import padded_vocab
from repro_torch.models.transformer import decode_step, forward, init_decode_state, init_params


def frontend_embeds_from_batch(batch: Dict[str, torch.Tensor],
                               cfg: ArchConfig) -> Optional[torch.Tensor]:
    if cfg.frontend == "audio_frames":
        return batch["frames"]
    if cfg.frontend == "vision_patches":
        return batch["patches"]
    return None


def make_prefill_step(cfg: ArchConfig, *, state_len: Optional[int] = None) -> Callable:
    def prefill_step(params, batch):
        """batch["tokens"]: (B, S), and the frontend's embeddings -> (next_token
        (B,) int32, decode state)."""
        logits, state = forward(params, batch["tokens"], cfg,
                                frontend_embeds=frontend_embeds_from_batch(batch, cfg),
                                make_state=True, state_len=state_len, logits_slice=1)
        next_token = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1)
        return next_token.to(torch.int32), state

    return prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    def serve_step(params, state, token):
        """token: (B, 1) -> (next_token (B,) int32, new_state)."""
        logits, new_state = decode_step(params, state, token, cfg)
        return torch.argmax(logits[:, : cfg.vocab_size], dim=-1).to(torch.int32), new_state

    return serve_step


def make_serve_step_with_logits(cfg: ArchConfig) -> Callable:
    def serve_step(params, state, token):
        logits, new_state = decode_step(params, state, token, cfg)
        return logits[:, : cfg.vocab_size], new_state

    return serve_step


__all__ = [
    "make_prefill_step", "make_serve_step", "make_serve_step_with_logits", "init_params",
    "init_decode_state", "frontend_embeds_from_batch", "padded_vocab",
]
