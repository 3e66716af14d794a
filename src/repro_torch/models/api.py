"""Model-level steps: loss, train step, prefill, serve step (port of
``repro.models.api``).

Each ``make_*`` returns a plain callable; PyTorch runs eagerly, so there is no
jit around it. A batch is a dict: ``"tokens"``, and for the stub frontends
``"frames"`` (whisper's audio frames) or ``"patches"`` (a VLM's image
patches), as the reference's batches carry them.

Cross-entropy is computed in chunks over the sequence, each chunk's logits
(B, c, Vp) recomputed in the backward, so the full (B, S, Vp) fp32 logits
never exist at once.

Every step takes ``par`` (``models/sharding.Parallel``) to run on a mesh of
ranks: the cross-entropy is vocab-parallel, the loss is normalised over the
global batch, the train step averages gradients over the data axes
(``data``, or ``pod`` x ``data``) with one ``all_reduce``, and the serve
steps take the argmax across vocab shards.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

import torch.distributed as dist

from repro_torch.core.tree import TreeDef, leaves
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import padded_vocab, unembed
from repro_torch.models.sharding import (
    Parallel,
    all_reduce,
    g,
    gather_cuts,
    gather_vocab,
    param_pspecs,
    sharded_mask,
    tp_of,
    vocab_argmax,
    zero1_cuts,
)
from repro_torch.models.transformer import decode_step, forward, init_decode_state, init_params
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule


def chunked_cross_entropy(embed_params: dict, feats: torch.Tensor, targets: torch.Tensor,
                          cfg: ArchConfig, *, chunk: int = 512,
                          z_loss_coef: float = 1e-4, par: Optional[Parallel] = None,
                          n_positions: Optional[int] = None) -> torch.Tensor:
    """Mean over the B*S positions of cross-entropy plus ``z_loss_coef`` *
    lse^2, from post-final-norm features (B, S, D) and targets (B, S). The
    sequence is padded to whole chunks (padded positions masked out); each
    chunk's logits are recomputed in the backward; padded vocabulary rows
    are masked with -1e30. With ``par`` the logits are this rank's block of
    the vocabulary: the max, the sum of exponentials and the gold logit are
    ``all_reduce``d over ``model`` (the last two through ``g``), and the
    z-loss uses the same global lse. ``n_positions`` (default B*S) divides
    the sum: the global batch's positions where the batch splits over
    ``data``."""
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

    split = tp_of(par) > 1

    def chunk_loss(f, t, m):
        logits = unembed(embed_params, f, cfg, par)
        vl = logits.shape[-1]
        v0 = par.tp_rank * vl if split else 0
        cols = torch.arange(v0, v0 + vl, device=logits.device)
        logits = torch.where(cols < cfg.vocab_size, logits, torch.full_like(logits, -1e30))
        if split:
            gmax = all_reduce(logits.detach().amax(dim=-1), par.model_group,
                              dist.ReduceOp.MAX)
            lse = torch.log(g(torch.exp(logits - gmax[..., None]).sum(dim=-1), par)) + gmax
            local = t - v0
            mine = (local >= 0) & (local < vl)
            gold = torch.take_along_dim(logits, local.clamp(0, vl - 1)[..., None],
                                        dim=-1)[..., 0]
            gold = g(torch.where(mine, gold, torch.zeros_like(gold)), par)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.take_along_dim(logits, t[..., None], dim=-1)[..., 0]
        ce = torch.sum((lse - gold) * m)
        zl = torch.sum(torch.square(lse) * m)
        return ce + z_loss_coef * zl

    losses = torch.stack([checkpoint(chunk_loss, fc[i], tc[i], mask[i], use_reentrant=False)
                          for i in range(n)])
    return torch.sum(losses) / (n_positions or B * S)


def frontend_embeds_from_batch(batch: Dict[str, torch.Tensor],
                               cfg: ArchConfig) -> Optional[torch.Tensor]:
    if cfg.frontend == "audio_frames":
        return batch["frames"]
    if cfg.frontend == "vision_patches":
        return batch["patches"]
    return None


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
            remat: str = "unit", rec_chunk: int = 256, ce_chunk: int = 512,
            par: Optional[Parallel] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(ce + aux, {"ce", "aux"})``: next-token cross-entropy over the
    features (a VLM's patch positions predict nothing: the feature at
    ``n_front - 1 + i`` predicts token i) plus the MoE aux loss. With
    ``par`` the batch is this rank's rows of a global batch split over
    ``data``, and the values are this data rank's shares: their sum over
    ``data`` is the global batch's loss."""
    tokens = batch["tokens"]
    fe = frontend_embeds_from_batch(batch, cfg)
    feats, aux = forward(params, tokens, cfg, frontend_embeds=fe, remat=remat,
                         rec_chunk=rec_chunk, return_features=True, return_aux=True,
                         par=par)
    dp = par.dp if par is not None else 1
    n_front = 0 if (cfg.is_encoder_decoder or fe is None) else fe.shape[1]
    if n_front > 0:
        pred, targets = feats[:, n_front - 1:-1], tokens
    else:
        pred, targets = feats[:, :-1], tokens[:, 1:]
    ce = chunked_cross_entropy(params["embed"], pred, targets, cfg, chunk=ce_chunk,
                               par=par, n_positions=targets.numel() * dp)
    if dp > 1:                     # the mean over the batch's rows of each row's aux
        aux = aux / dp
    return ce + aux, {"ce": ce, "aux": aux}


def make_train_step(cfg: ArchConfig, *, adamw: AdamWConfig = AdamWConfig(),
                    peak_lr: float = 3e-4, warmup_steps: int = 100,
                    total_steps: int = 10_000, remat: str = "unit",
                    rec_chunk: int = 256, par: Optional[Parallel] = None) -> Callable:
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``: the loss's gradients by ``torch.autograd.grad`` over the
    parameter leaves, then AdamW at the cosine schedule's rate. The
    parameters and moments are updated in place (:func:`adamw_update`);
    metrics are device scalars: ``loss``, ``lr``, ``ce``, ``aux``,
    ``grad_norm``, ``clip_scale``.

    With ``par`` the parameters and moments are this rank's shards and the
    batch its rows of the global batch, which must split over ``data``; the
    gradients are summed over ``data`` in one ``all_reduce`` of one flat
    buffer, and the metrics are the global batch's. With ``par.zero1`` the
    moments are this ``data`` rank's slices (:func:`init_opt_state`): each
    rank updates its slice of the parameters and one more ``all_reduce``
    over ``data`` gathers them (``sharding.gather_cuts``); parameters, loss
    and ``grad_norm`` are bitwise those of the step without it."""
    def train_step(params, opt_state, batch, step):
        loss, parts, grads = loss_and_grads(params, batch, cfg, remat=remat,
                                            rec_chunk=rec_chunk, par=par)
        shard = {}
        if par is not None:
            shard = dict(sharded=sharded_mask(param_pspecs(cfg, params, par.tp)),
                         reduce=lambda t: all_reduce(t, par.model_group))
            if par.zero1:
                shard.update(cuts=zero1_cuts(cfg, params, par),
                             gather=lambda ts, cuts: gather_cuts(ts, cuts, par))
        lr = cosine_schedule(step, peak_lr=peak_lr, warmup_steps=warmup_steps,
                             total_steps=total_steps).to(loss.device)
        params, opt_state, om = adamw_update(grads, opt_state, params, lr, adamw, **shard)
        metrics = {"loss": loss.detach(), "lr": lr,
                   **{k: v.detach() for k, v in parts.items()}, **om}
        return params, opt_state, metrics

    return train_step


def init_opt_state(params, cfg: ArchConfig, par: Optional[Parallel] = None) -> dict:
    """The AdamW state the train step of ``cfg`` on ``par`` takes: the
    moments whole, or under ``par.zero1`` this ``data`` rank's slices."""
    cuts = zero1_cuts(cfg, params, par) if par is not None and par.zero1 else None
    return adamw_init(params, cuts)


def loss_and_grads(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig, *,
                   remat: str = "unit", rec_chunk: int = 256,
                   par: Optional[Parallel] = None):
    """``(loss, parts, grads)``: the train step's loss and its parts
    (detached) and the gradients, a tree like ``params`` (with ``par``:
    this rank's shards, summed over ``data``; the loss the global batch's)."""
    treedef = TreeDef.of(params)
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss, parts = loss_fn(treedef.unflatten(live), batch, cfg, remat=remat,
                              rec_chunk=rec_chunk, par=par)
        grads = list(torch.autograd.grad(loss, live, allow_unused=True,
                                         materialize_grads=True))
    loss, parts = loss.detach(), {k: v.detach() for k, v in parts.items()}
    if par is not None:
        grads, loss, parts = _reduce_over_data(grads, loss, parts, par)
    return loss, parts, treedef.unflatten(grads)


def _reduce_over_data(grads: List[torch.Tensor], loss: torch.Tensor,
                      parts: Dict[str, torch.Tensor], par: Parallel):
    """Sum the gradients over ``data`` in one ``all_reduce`` of one flat
    buffer, and the loss and its parts in another."""
    if par.dp == 1:
        return grads, loss, parts
    flat = all_reduce(torch.cat([gr.reshape(-1) for gr in grads]), par.data_group)
    grads = [gr.view_as(g0) for gr, g0 in
             zip(flat.split([g0.numel() for g0 in grads]), grads)]
    keys = sorted(parts)
    vals = all_reduce(torch.stack([loss.detach()] + [parts[k].detach() for k in keys]),
                      par.data_group)
    return grads, vals[0], dict(zip(keys, vals[1:]))


def _needs_batch(par: Optional[Parallel]) -> None:
    if par is not None and par.batch is None:
        raise ValueError("a sharded prefill needs the global batch: Parallel.for_batch")


def make_prefill_step(cfg: ArchConfig, *, state_len: Optional[int] = None,
                      par: Optional[Parallel] = None) -> Callable:
    """With ``par`` (its global batch set, ``Parallel.for_batch``) the batch
    is this rank's rows where the batch splits over ``data``, else all of
    it, and the state is this rank's part."""
    _needs_batch(par)

    def prefill_step(params, batch):
        """batch["tokens"]: (B, S), and the frontend's embeddings -> (next_token
        (B,) int32, decode state)."""
        logits, state = forward(params, batch["tokens"], cfg,
                                frontend_embeds=frontend_embeds_from_batch(batch, cfg),
                                make_state=True, state_len=state_len, logits_slice=1,
                                par=par)
        next_token = vocab_argmax(logits[:, -1], cfg, par)
        return next_token.to(torch.int32), state

    return prefill_step


def make_serve_step(cfg: ArchConfig, par: Optional[Parallel] = None) -> Callable:
    _needs_batch(par)

    def serve_step(params, state, token):
        """token: (B, 1) -> (next_token (B,) int32, new_state)."""
        logits, new_state = decode_step(params, state, token, cfg, par=par)
        return vocab_argmax(logits, cfg, par).to(torch.int32), new_state

    return serve_step


def make_serve_step_with_logits(cfg: ArchConfig, par: Optional[Parallel] = None
                                ) -> Callable:
    """The logits over the whole live vocabulary (gathered across vocab
    shards with ``par``)."""
    _needs_batch(par)

    def serve_step(params, state, token):
        logits, new_state = decode_step(params, state, token, cfg, par=par)
        return gather_vocab(logits, par)[:, : cfg.vocab_size], new_state

    return serve_step


__all__ = [
    "loss_fn", "loss_and_grads", "chunked_cross_entropy", "make_train_step", "make_prefill_step",
    "make_serve_step", "make_serve_step_with_logits", "init_params", "init_opt_state",
    "init_decode_state", "frontend_embeds_from_batch", "padded_vocab",
]
