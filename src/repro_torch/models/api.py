"""Model-level steps: loss, train step, prefill, serve step (port of
``repro.models.api``).

Each ``make_*`` returns a plain callable; PyTorch runs eagerly, so there is no
jit around it. A batch is a dict: ``"tokens"``, and for the stub frontends
``"frames"`` (whisper's audio frames) or ``"patches"`` (a VLM's image
patches), as the reference's batches carry them.

Cross-entropy is computed in chunks over the sequence, each chunk's logits
(B, c, Vp) recomputed in the backward, so the full (B, S, Vp) fp32 logits
never exist at once.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tree import TreeDef, leaves
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import padded_vocab, unembed
from repro_torch.models.transformer import decode_step, forward, init_decode_state, init_params
from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule


def chunked_cross_entropy(embed_params: dict, feats: torch.Tensor, targets: torch.Tensor,
                          cfg: ArchConfig, *, chunk: int = 512,
                          z_loss_coef: float = 1e-4) -> torch.Tensor:
    """Mean over the B*S positions of cross-entropy plus ``z_loss_coef`` *
    lse^2, from post-final-norm features (B, S, D) and targets (B, S). The
    sequence is padded to whole chunks (padded positions masked out); each
    chunk's logits are recomputed in the backward; padded vocabulary rows
    are masked with -1e30."""
    B, S, D = feats.shape
    C = min(chunk, S)
    pad = (-S) % C
    if pad:
        feats = F.pad(feats, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
    n = feats.shape[1] // C
    fc = feats.reshape(B, n, C, D).transpose(0, 1)
    tc = targets.reshape(B, n, C).transpose(0, 1).long()
    mask = (torch.arange(n * C, device=feats.device).reshape(n, C)[:, None, :] < S).float()

    def chunk_loss(f, t, m):
        logits = unembed(embed_params, f, cfg)
        vp = logits.shape[-1]
        live = torch.arange(vp, device=logits.device) < cfg.vocab_size
        logits = torch.where(live, logits, torch.full_like(logits, -1e30))
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, t[..., None], dim=-1)[..., 0]
        ce = torch.sum((lse - gold) * m)
        zl = torch.sum(torch.square(lse) * m)
        return ce + z_loss_coef * zl

    losses = torch.stack([checkpoint(chunk_loss, fc[i], tc[i], mask[i], use_reentrant=False)
                          for i in range(n)])
    return torch.sum(losses) / (B * S)


def frontend_embeds_from_batch(batch: Dict[str, torch.Tensor],
                               cfg: ArchConfig) -> Optional[torch.Tensor]:
    if cfg.frontend == "audio_frames":
        return batch["frames"]
    if cfg.frontend == "vision_patches":
        return batch["patches"]
    return None


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            remat: str = "unit", rec_chunk: int = 256, ce_chunk: int = 512
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(ce + aux, {"ce", "aux"})``: next-token cross-entropy over the
    features (a VLM's patch positions predict nothing: the feature at
    ``n_front - 1 + i`` predicts token i) plus the MoE aux loss."""
    tokens = batch["tokens"]
    fe = frontend_embeds_from_batch(batch, cfg)
    feats, aux = forward(params, tokens, cfg, frontend_embeds=fe, remat=remat,
                         rec_chunk=rec_chunk, return_features=True, return_aux=True)
    n_front = 0 if (cfg.is_encoder_decoder or fe is None) else fe.shape[1]
    if n_front > 0:
        pred, targets = feats[:, n_front - 1:-1], tokens
    else:
        pred, targets = feats[:, :-1], tokens[:, 1:]
    ce = chunked_cross_entropy(params["embed"], pred, targets, cfg, chunk=ce_chunk)
    return ce + aux, {"ce": ce, "aux": aux}


def make_train_step(cfg: ArchConfig, *, adamw: AdamWConfig = AdamWConfig(),
                    peak_lr: float = 3e-4, warmup_steps: int = 100,
                    total_steps: int = 10_000, remat: str = "unit",
                    rec_chunk: int = 256) -> Callable:
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``: the loss's gradients by ``torch.autograd.grad`` over the
    parameter leaves, then AdamW at the cosine schedule's rate. The
    parameters and moments are updated in place (:func:`adamw_update`);
    metrics are device scalars: ``loss``, ``lr``, ``ce``, ``aux``,
    ``grad_norm``, ``clip_scale``."""
    def train_step(params, opt_state, batch, step):
        treedef = TreeDef.of(params)
        live = [p.detach().requires_grad_(True) for p in leaves(params)]
        with torch.enable_grad():
            loss, parts = loss_fn(treedef.unflatten(live), batch, cfg, remat=remat,
                                  rec_chunk=rec_chunk)
            grads = torch.autograd.grad(loss, live, allow_unused=True,
                                        materialize_grads=True)
        lr = cosine_schedule(step, peak_lr=peak_lr, warmup_steps=warmup_steps,
                             total_steps=total_steps).to(loss.device)
        params, opt_state, om = adamw_update(treedef.unflatten(list(grads)), opt_state,
                                             params, lr, adamw)
        metrics = {"loss": loss.detach(), "lr": lr,
                   **{k: v.detach() for k, v in parts.items()}, **om}
        return params, opt_state, metrics

    return train_step


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
    "loss_fn", "chunked_cross_entropy", "make_train_step", "make_prefill_step",
    "make_serve_step", "make_serve_step_with_logits", "init_params",
    "init_decode_state", "frontend_embeds_from_batch", "padded_vocab",
]
