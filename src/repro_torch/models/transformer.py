"""The model: init, prefill forward and single-token decode, for every family.

Port of ``repro.models.transformer``: dense GLOBAL/LOCAL attention layers,
attention-free Mamba-1 stacks (SSM layers), hybrid RG-LRU/local-attention
stacks (Griffin, with remainder layers), mixture-of-experts MLPs
(``models/moe.py``), the encoder-decoder (whisper: a non-causal encoder over
stub frame embeddings, sinusoidal positions, cross attention in every decoder
layer) and the VLM (stub patch embeddings prepended to the tokens).
Parameters keep the reference layout, so a page table built by either
package names the same leaves: one repeating pattern unit stacked along a
leading ``n_units`` axis in ``params["unit"]`` (a tuple, one dict per pattern
position), remainder layers in ``params["rem"]``, whisper's encoder stacked
along ``n_enc_layers`` in ``params["enc"]`` with ``params["enc_norm"]``.
JAX's ``vmap`` init draws the stacked leaves directly here, and its
``lax.scan`` over units is a Python loop that indexes the stacked leaves by
unit. The decode state keeps the same layout: per pattern position a
:class:`~repro_torch.models.attention.KVCache`,
:class:`~repro_torch.models.ssm.SSMState` or
:class:`~repro_torch.models.rglru.RGLRUState` whose leaves carry a leading
``n_units`` axis, per remainder layer an unstacked one, ``pos``, and for the
encoder-decoder ``cross``: each unit's encoder keys and values,
``(n_units, B, Hkv, Senc, hd)`` (the reference orders the last three axes
``Senc, Hkv, hd``; the port keeps the cache layout its kernels read).

Every entry point takes ``par``, a rank's place on a ``("data", "model")``
or ``("pod", "data", "model")`` mesh
(:class:`~repro_torch.models.sharding.Parallel`), or None for one rank.
With it the parameters are the rank's shards (``sharding.shard_tree``), the
tokens (and a VLM's patches or whisper's frames) its rows of the batch where
the batch covers the data axes, logits come out as its block of the
vocabulary (``sharding.gather_vocab`` joins them) and each rank builds and
updates only its part of the decode state. Every family runs at any model
axis the reference's rules cut: whisper's encoder layers are
tensor-parallel like the decoder's, and its cross state is kept whole.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch import spans
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.diag_recurrence import diag_recurrence
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import GLOBAL_ATTN, LOCAL_ATTN, RECURRENT, SSM, ArchConfig
from repro_torch.models.sharding import Parallel
from repro_torch.models.layers import (
    embed_tokens,
    init_embedding,
    init_mlp,
    init_rmsnorm,
    mlp,
    rmsnorm,
    sinusoidal_position_at,
    sinusoidal_positions,
    unembed,
)

#: the span of one prefill layer in :func:`forward`, by layer type
LAYER_SPANS = {t: f"forward.layer.{t}" for t in (GLOBAL_ATTN, LOCAL_ATTN, RECURRENT, SSM)}


def _ltype(cfg: ArchConfig, i: int) -> str:
    """The layer type of remainder layer ``i`` (the pattern, cycled)."""
    return cfg.attn_pattern[i % len(cfg.attn_pattern)]


def _init_layer(gen: torch.Generator, cfg: ArchConfig, ltype: str, dtype,
                lead=(), *, cross: bool = False) -> Dict[str, Any]:
    d = cfg.d_model
    if ltype == SSM:
        return {"ln1": init_rmsnorm(gen, d, dtype, lead),
                "ssm": ssm_mod.init_ssm(gen, cfg, dtype, lead)}
    p: Dict[str, Any] = {"ln1": init_rmsnorm(gen, d, dtype, lead)}
    if ltype == RECURRENT:
        p["rec"] = rglru_mod.init_rglru(gen, cfg, dtype, lead)
    else:
        p["attn"] = attn.init_attention(gen, cfg, dtype, lead)
    if cross:
        p["lnx"] = init_rmsnorm(gen, d, dtype, lead)
        p["xattn"] = attn.init_attention(gen, cfg, dtype, lead, cross=True)
    p["ln2"] = init_rmsnorm(gen, d, dtype, lead)
    if cfg.n_experts > 0:
        p["moe"] = moe_mod.init_moe(gen, cfg, dtype, lead)
    else:
        p["mlp"] = init_mlp(gen, cfg, dtype, lead)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random parameters on ``gen.device``, drawn from ``gen``. The SSM and
    RG-LRU leaves the reference keeps in fp32 (``dt_bias``, ``A_log``,
    ``D``, ``b_a``, ``b_x``, ``lambda``) and the MoE router are fp32 here too."""
    lead = (cfg.n_pattern_units,)
    cross = cfg.is_encoder_decoder
    params = {
        "embed": init_embedding(gen, cfg, dtype),
        "final_norm": init_rmsnorm(gen, cfg.d_model, dtype),
        "unit": tuple(_init_layer(gen, cfg, t, dtype, lead, cross=cross)
                      for t in cfg.attn_pattern),
        "rem": tuple(_init_layer(gen, cfg, _ltype(cfg, i), dtype, cross=cross)
                     for i in range(cfg.n_remainder_layers)),
    }
    if cross:                 # encoder layers: non-causal global attention
        params["enc"] = _init_layer(gen, cfg, GLOBAL_ATTN, dtype, (cfg.n_enc_layers,))
        params["enc_norm"] = init_rmsnorm(gen, cfg.d_model, dtype)
    return params


def _index(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_mlp_part(p: Dict[str, Any], x: torch.Tensor, cfg: ArchConfig, *,
                    decode: bool = False, par: Optional[Parallel] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The MLP sublayer, dense or mixture-of-experts: ``(x, aux)``, aux the
    experts' load-balancing loss (None for a dense MLP: no device work);
    decode routes with ``no_drop`` as the reference does."""
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if cfg.n_experts > 0:
        out, aux = moe_mod.moe_ffn(p["moe"], h, cfg, no_drop=decode, par=par)
    else:
        out, aux = mlp(p["mlp"], h, cfg.mlp, par), None
    return x + out, aux


def _add_aux(acc: Optional[torch.Tensor], aux: Optional[torch.Tensor]):
    """Sum of two aux losses, None standing for 0."""
    if acc is None:
        return aux
    return acc if aux is None else acc + aux


def _apply_layer(p: Dict[str, Any], x: torch.Tensor, cfg: ArchConfig, ltype: str,
                 positions: torch.Tensor, attention_fn: Callable, recurrence_fn: Callable,
                 make_state: bool = False, state_len: Optional[int] = None,
                 rec_chunk: int = 256, causal: bool = True,
                 cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 par: Optional[Parallel] = None):
    """Returns ``(x, layer state, aux)``, the state None unless
    ``make_state``, aux None without experts."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if ltype == SSM:                      # the Mamba block replaces attention and MLP
        out, st = ssm_mod.ssm_prefill(p["ssm"], h, cfg, make_state=make_state,
                                      chunk=rec_chunk, recurrence_fn=recurrence_fn,
                                      par=par)
        return x + out, st, None
    if ltype == RECURRENT:
        out, st = rglru_mod.rglru_prefill(p["rec"], h, cfg, make_state=make_state,
                                          recurrence_fn=recurrence_fn, par=par)
    else:
        out = attn.attention_prefill(p["attn"], h, cfg, ltype, positions, causal=causal,
                                     attention_fn=attention_fn, make_cache=make_state,
                                     state_len=state_len, par=par)
        out, st = out if make_state else (out, None)
    x = x + out
    if cross_kv is not None:
        hx = rmsnorm(p["lnx"], x, cfg.norm_eps)
        x = x + attn.cross_attention(p["xattn"], hx, *cross_kv, cfg,
                                     attention_fn=attention_fn, par=par)
    x, aux = _apply_mlp_part(p, x, cfg, par=par)
    return x, st, aux


REMAT = ("none", "unit", "dots")
_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of the products without batch dims
    (JAX's ``dots_with_no_batch_dims_saveable``), recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable, remat: str) -> Callable:
    """``fn`` as the backward sees it under ``remat``: ``none`` keeps every
    activation, ``unit`` recomputes the whole segment in the backward
    (non-reentrant ``torch.utils.checkpoint``), ``dots`` recomputes all but
    the matrix products' outputs (selective checkpointing)."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    if remat == "none":
        return fn
    context_fn = (functools.partial(create_selective_checkpoint_contexts, _dots_policy)
                  if remat == "dots" else noop_context_fn)
    return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=context_fn)


def _stack(states):
    """Per-unit layer states -> one state whose leaves lead with the unit axis."""
    return type(states[0])(*(torch.stack(leaves) for leaves in zip(*states)))


def encode(params: Dict[str, Any], frames: torch.Tensor, cfg: ArchConfig, *,
           attention_fn: Callable = flash_attention, remat: bool = False,
           par: Optional[Parallel] = None) -> torch.Tensor:
    """frames: (B, Senc, D) stub embeddings -> the encoder output, through
    ``n_enc_layers`` non-causal global layers in the parameters' dtype; with
    ``remat`` each layer is recomputed in the backward. With ``par`` the
    layers are tensor-parallel (their shards of ``params["enc"]``) and the
    frames and the output are replicated over ``model``."""
    x = frames.to(params["enc_norm"]["scale"].dtype)
    S = x.shape[1]
    x = x + sinusoidal_positions(S, cfg.d_model, x.device).to(x.dtype)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)

    def layer(x, u):
        return _apply_layer(_index(params["enc"], u), x, cfg, GLOBAL_ATTN, positions,
                            attention_fn, diag_recurrence, causal=False, par=par)[0]

    layer = _remat(layer, "unit" if remat else "none")
    for u in range(cfg.n_enc_layers):
        x = layer(x, u)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,                   # (B, S) integer
    cfg: ArchConfig,
    *,
    frontend_embeds: Optional[torch.Tensor] = None,   # (B, F, D): audio frames / patches
    logits_slice: Optional[int] = None,     # keep only the last N positions' logits
    return_features: bool = False,          # skip unembed
    attention_fn: Callable = flash_attention,
    recurrence_fn: Callable = diag_recurrence,
    make_state: bool = False,
    state_len: Optional[int] = None,        # decode-state capacity (prompt + budget)
    rec_chunk: int = 256,                   # SSM positions expanded per recurrence call
    remat: str = "none",                    # none | unit | dots (training)
    return_aux: bool = False,               # also return the MoE aux loss
    par: Optional[Parallel] = None,         # this rank's place on the mesh
):
    """Logits fp32 (B, S_total, Vp), or features (B, S_total, D) with
    ``return_features``.

    ``frontend_embeds`` feeds the stub frontends: whisper's encoder takes the
    frames (required) and the decoder adds sinusoidal positions to the
    tokens; a VLM prepends the patches, so S_total = F + S and positions run
    over both. ``attention_fn`` and ``recurrence_fn`` are the prefill
    attention core (self and cross attention, and the encoder's) and the
    diagonal recurrence: the kernel wrappers by default, or their plain
    versions to check the kernel path. With ``make_state`` it returns
    ``(logits, state)``: the decode state ``{"unit", "rem", "pos"}`` (and
    ``"cross"`` for the encoder-decoder) laid out as the reference's, caches
    sized for ``state_len`` positions. With ``return_aux`` the MoE
    load-balancing loss (fp32 scalar, summed over the layers; 0 without
    experts) follows the logits: ``(logits, aux)`` or ``(logits, aux,
    state)``, the reference's order. ``remat`` (``none``, ``unit``:
    recompute each pattern unit in the backward; ``dots``: keep only the
    matrix products' outputs, see :func:`_remat`) bounds a training step's
    activation memory; the encoder's layers are recomputed unless it is
    ``none``. The reference's attention ``q_chunk`` has no counterpart: the
    attention core is the kernel. With ``par`` the logits are this rank's
    block of the vocabulary, and a decode state needs ``par.batch``, the
    global batch (``Parallel.for_batch``).
    """
    if make_state and remat != "none":
        raise ValueError("remat is for training: a forward that makes the decode "
                         "state keeps its activations")
    with spans.span("forward"):
        with spans.span("forward.embed"):
            x = embed_tokens(params["embed"], tokens, cfg, par)
        enc_out = None
        if cfg.is_encoder_decoder:
            if frontend_embeds is None:
                raise ValueError(f"{cfg.name} needs stub frame embeddings (frontend_embeds)")
            enc_out = encode(params, frontend_embeds, cfg, attention_fn=attention_fn,
                             remat=remat != "none", par=par)
            x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)
        elif frontend_embeds is not None:       # VLM: prepend the patch embeddings
            x = torch.cat([frontend_embeds.to(x.device, x.dtype), x], dim=1)
        S = x.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        run = dict(attention_fn=attention_fn, recurrence_fn=recurrence_fn,
                   make_state=make_state, state_len=state_len, rec_chunk=rec_chunk, par=par)
        unit_states = [[] for _ in cfg.attn_pattern]
        cross_k, cross_v = [], []

        def unit(x, u):
            """One pattern unit: ``(x, aux)`` (aux None without experts); states
            and cross keys are collected on the side (only when ``make_state``,
            so never under remat)."""
            aux = None
            for i, ltype in enumerate(cfg.attn_pattern):
                p = _index(params["unit"][i], u)
                ck = None
                if enc_out is not None:
                    ck = attn.project_cross_kv(p["xattn"], enc_out, cfg, par)
                with spans.span(LAYER_SPANS[ltype]):
                    x, st, a = _apply_layer(p, x, cfg, ltype, positions, cross_kv=ck, **run)
                aux = _add_aux(aux, a)
                unit_states[i].append(st)
            if enc_out is not None and make_state:   # the reference keeps the unit's last
                kv = attn.whole_cross_kv(*ck, cfg, par)   # layer's, replicated over model
                cross_k.append(kv[0])
                cross_v.append(kv[1])
            return x, aux

        unit = _remat(unit, remat)
        aux_loss = None
        for u in range(cfg.n_pattern_units):
            x, a = unit(x, u)
            aux_loss = _add_aux(aux_loss, a)
        rem_states = []
        for i, p in enumerate(params.get("rem", ())):
            ltype = _ltype(cfg, i)
            with spans.span(LAYER_SPANS[ltype]):
                x, st, a = _apply_layer(p, x, cfg, ltype, positions, **run)
            aux_loss = _add_aux(aux_loss, a)
            rem_states.append(st)
        with spans.span("forward.head"):
            x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
            if logits_slice is not None:
                x = x[:, -logits_slice:]
            out = x if return_features else unembed(params["embed"], x, cfg, par)
        if return_aux and aux_loss is None:
            aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
        head = (out, aux_loss) if return_aux else (out,)
        if not make_state:
            return head if return_aux else out
        state = {"unit": tuple(_stack(s) for s in unit_states),
                 "rem": tuple(rem_states),
                 "pos": torch.full((tokens.shape[0],), S, dtype=torch.int32,
                                   device=x.device)}
        if cross_k:
            state["cross"] = {"k": torch.stack(cross_k), "v": torch.stack(cross_v)}
        return (*head, state)


# ---------------------------------------------------------------------------------
# Single-token decode
# ---------------------------------------------------------------------------------

def _apply_layer_decode(p: Dict[str, Any], x: torch.Tensor, st, pos: torch.Tensor,
                        cfg: ArchConfig, ltype: str,
                        decode_fn: Callable = decode_attention,
                        cross_kv: Optional[Tuple[torch.Tensor, ...]] = None,
                        par: Optional[Parallel] = None):
    """One token through one layer; ``st`` is written in place. ``cross_kv``
    is the encoder's (keys, values, validity mask) for cross attention."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if ltype == SSM:
        out, st = ssm_mod.ssm_decode(p["ssm"], h, st, cfg, par)
        return x + out, st
    if ltype == RECURRENT:
        out, st = rglru_mod.rglru_decode(p["rec"], h, st, cfg, par)
    else:
        out, st = attn.attention_decode(p["attn"], h, st, pos, cfg, ltype,
                                        decode_fn=decode_fn, par=par)
    x = x + out
    if cross_kv is not None:
        hx = rmsnorm(p["lnx"], x, cfg.norm_eps)
        x = x + attn.cross_attention_decode(p["xattn"], hx, *cross_kv, cfg,
                                            decode_fn=decode_fn, par=par)
    return _apply_mlp_part(p, x, cfg, decode=True, par=par)[0], st


def _empty_layer_state(cfg: ArchConfig, ltype: str, batch: int, seq_len: int, dtype,
                       device=None, par: Optional[Parallel] = None):
    if ltype == SSM:
        return ssm_mod.empty_ssm_state(cfg, batch, dtype, device, par)
    if ltype == RECURRENT:
        return rglru_mod.empty_rglru_state(cfg, batch, dtype, device, par)
    return attn.empty_cache(cfg, ltype, batch, seq_len, dtype, device, par)


def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int,
                      dtype=torch.bfloat16, device=None,
                      par: Optional[Parallel] = None) -> Dict[str, Any]:
    """An empty decode state for ``batch`` slots of ``seq_len`` positions on
    ``device`` (default: the current default device, the CPU unless set).
    Recurrent states keep ``h`` in fp32 whatever ``dtype`` is, as the
    reference's do. With ``par`` (whose global batch is ``batch``) it is
    this rank's part: its rows where the batch covers the data axis, its kv
    heads and channels where they split over ``model``, its block of a cache's
    slots where the positions split (``sharding.decode_state_pspecs``)."""
    n_units = cfg.n_pattern_units
    if par is not None:
        par = par.for_batch(batch)
        if par.batch_covers:
            batch //= par.dp

    def stacked(st):
        if n_units == 0:
            return st
        return type(st)(*(leaf.expand(n_units, *leaf.shape).contiguous() for leaf in st))

    unit = tuple(stacked(_empty_layer_state(cfg, t, batch, seq_len, dtype, device, par))
                 for t in cfg.attn_pattern)
    rem = tuple(_empty_layer_state(cfg, _ltype(cfg, i), batch, seq_len, dtype, device, par)
                for i in range(cfg.n_remainder_layers))
    state = {"unit": unit, "rem": rem,
             "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.is_encoder_decoder:
        shape = (n_units, batch, cfg.n_kv_heads, cfg.n_enc_positions,
                 cfg.resolved_head_dim)
        state["cross"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype, device=device)}
    return state


def decode_step(
    params: Dict[str, Any],
    state: Dict[str, Any],
    token: torch.Tensor,                    # (B, 1) integer
    cfg: ArchConfig,
    *,
    decode_fn: Callable = decode_attention,
    par: Optional[Parallel] = None,
):
    """One autoregressive step. Returns ``(logits fp32 (B, Vp), new_state)``
    (with ``par``: this rank's block of Vp; ``par.batch`` the global batch).

    Caches and recurrent states are updated in place: the returned state
    holds the same tensors as ``state`` (with ``pos`` advanced in a new
    tensor), so a caller that needs the old state clones it first.
    ``decode_fn`` is the attention core (kernel wrapper by default, or its
    plain version).
    """
    pos = state["pos"]                                    # (B,) per-slot positions
    x = embed_tokens(params["embed"], token, cfg, par)
    cross = state.get("cross")
    if cfg.is_encoder_decoder:
        sin = sinusoidal_position_at(pos, cfg.d_model).to(x.dtype)   # (B, D) | (D,)
        x = x + (sin[:, None] if sin.dim() == 2 else sin[None, None])
    if cross is not None:     # every encoder position is valid: one mask per step
        enc_valid = torch.ones((cross["k"].shape[3],), dtype=torch.bool, device=x.device)
    for u in range(cfg.n_pattern_units):
        ck = (cross["k"][u], cross["v"][u], enc_valid) if cross is not None else None
        for i, ltype in enumerate(cfg.attn_pattern):
            unit_st = state["unit"][i]
            st = type(unit_st)(*(leaf[u] for leaf in unit_st))     # views
            x, _ = _apply_layer_decode(_index(params["unit"][i], u), x, st, pos, cfg,
                                       ltype, decode_fn, cross_kv=ck, par=par)
    new_rem = []
    for i in range(cfg.n_remainder_layers):
        x, st = _apply_layer_decode(params["rem"][i], x, state["rem"][i], pos, cfg,
                                    _ltype(cfg, i), decode_fn, par=par)
        new_rem.append(st)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg, par)[:, 0]  # (B, Vp)
    new_state = dict(state)                               # "unit" updated in place
    new_state["rem"] = tuple(new_rem)
    new_state["pos"] = pos + 1
    return logits, new_state
