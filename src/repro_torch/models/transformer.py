"""Decoder-only model: init, prefill forward and single-token decode.

Port of ``repro.models.transformer`` for the decoder-only families: dense
GLOBAL/LOCAL attention layers with a dense MLP, attention-free Mamba-1 stacks
(SSM layers) and hybrid RG-LRU/local-attention stacks (Griffin, with remainder
layers). Parameters keep the reference layout, so a page table built by either
package names the same leaves: one repeating pattern unit stacked along a
leading ``n_units`` axis in ``params["unit"]`` (a tuple, one dict per pattern
position), remainder layers in ``params["rem"]``. JAX's ``vmap`` init draws
the stacked leaves directly here, and its ``lax.scan`` over units is a Python
loop that indexes the stacked leaves by unit. The decode state keeps the same
layout: per pattern position a :class:`~repro_torch.models.attention.KVCache`,
:class:`~repro_torch.models.ssm.SSMState` or
:class:`~repro_torch.models.rglru.RGLRUState` whose leaves carry a leading
``n_units`` axis, per remainder layer an unstacked one, and ``pos``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.diag_recurrence import diag_recurrence
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as attn
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import GLOBAL_ATTN, LOCAL_ATTN, RECURRENT, SSM, ArchConfig
from repro_torch.models.layers import (
    embed_tokens,
    init_embedding,
    init_mlp,
    init_rmsnorm,
    mlp,
    rmsnorm,
    unembed,
)

_PORTED_LAYERS = (GLOBAL_ATTN, LOCAL_ATTN, SSM, RECURRENT)


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the configurations this port does not run yet."""
    if (cfg.n_experts > 0 or cfg.is_encoder_decoder or cfg.frontend is not None
            or any(t not in _PORTED_LAYERS for t in cfg.attn_pattern)):
        raise NotImplementedError(
            f"{cfg.name}: the dense, SSM (Mamba-1) and hybrid RG-LRU families are "
            "ported; MoE, encoder-decoder and VLM configs wait for ROADMAP.md "
            "queue 1, 'Other architectures'")


def _ltype(cfg: ArchConfig, i: int) -> str:
    """The layer type of remainder layer ``i`` (the pattern, cycled)."""
    return cfg.attn_pattern[i % len(cfg.attn_pattern)]


def _init_layer(gen: torch.Generator, cfg: ArchConfig, ltype: str, dtype,
                lead=()) -> Dict[str, Any]:
    d = cfg.d_model
    if ltype == SSM:
        return {"ln1": init_rmsnorm(gen, d, dtype, lead),
                "ssm": ssm_mod.init_ssm(gen, cfg, dtype, lead)}
    p: Dict[str, Any] = {"ln1": init_rmsnorm(gen, d, dtype, lead)}
    if ltype == RECURRENT:
        p["rec"] = rglru_mod.init_rglru(gen, cfg, dtype, lead)
    else:
        p["attn"] = attn.init_attention(gen, cfg, dtype, lead)
    p["ln2"] = init_rmsnorm(gen, d, dtype, lead)
    p["mlp"] = init_mlp(gen, cfg, dtype, lead)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random parameters on ``gen.device``, drawn from ``gen``. The SSM and
    RG-LRU leaves the reference keeps in fp32 (``dt_bias``, ``A_log``,
    ``D``, ``b_a``, ``b_x``, ``lambda``) are fp32 here too."""
    check_supported(cfg)
    lead = (cfg.n_pattern_units,)
    return {
        "embed": init_embedding(gen, cfg, dtype),
        "final_norm": init_rmsnorm(gen, cfg.d_model, dtype),
        "unit": tuple(_init_layer(gen, cfg, t, dtype, lead) for t in cfg.attn_pattern),
        "rem": tuple(_init_layer(gen, cfg, _ltype(cfg, i), dtype)
                     for i in range(cfg.n_remainder_layers)),
    }


def _index(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_layer(p: Dict[str, Any], x: torch.Tensor, cfg: ArchConfig, ltype: str,
                 positions: torch.Tensor, attention_fn: Callable, recurrence_fn: Callable,
                 make_state: bool = False, state_len: Optional[int] = None,
                 rec_chunk: int = 256):
    """Returns ``(x, layer state)``, the state None unless ``make_state``."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if ltype == SSM:                      # the Mamba block replaces attention and MLP
        out, st = ssm_mod.ssm_prefill(p["ssm"], h, cfg, make_state=make_state,
                                      chunk=rec_chunk, recurrence_fn=recurrence_fn)
        return x + out, st
    if ltype == RECURRENT:
        out, st = rglru_mod.rglru_prefill(p["rec"], h, cfg, make_state=make_state,
                                          recurrence_fn=recurrence_fn)
    else:
        out = attn.attention_prefill(p["attn"], h, cfg, ltype, positions, causal=True,
                                     attention_fn=attention_fn, make_cache=make_state,
                                     state_len=state_len)
        out, st = out if make_state else (out, None)
    x = x + out
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], h, cfg.mlp), st


def _stack(states):
    """Per-unit layer states -> one state whose leaves lead with the unit axis."""
    return type(states[0])(*(torch.stack(leaves) for leaves in zip(*states)))


def forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,                   # (B, S) integer
    cfg: ArchConfig,
    *,
    logits_slice: Optional[int] = None,     # keep only the last N positions' logits
    return_features: bool = False,          # skip unembed
    attention_fn: Callable = flash_attention,
    recurrence_fn: Callable = diag_recurrence,
    make_state: bool = False,
    state_len: Optional[int] = None,        # decode-state capacity (prompt + budget)
    rec_chunk: int = 256,                   # SSM positions expanded per recurrence call
):
    """Logits fp32 (B, S, Vp), or features (B, S, D) with ``return_features``.

    ``attention_fn`` and ``recurrence_fn`` are the prefill attention core and
    the diagonal recurrence: the kernel wrappers by default, or their plain
    versions to check the kernel path. With ``make_state`` it returns
    ``(logits, state)``: the decode state ``{"unit", "rem", "pos"}`` laid out
    as the reference's, caches sized for ``state_len`` positions. The
    reference also returns an aux loss, which only its MoE family makes.
    """
    check_supported(cfg)
    x = embed_tokens(params["embed"], tokens, cfg)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    run = dict(attention_fn=attention_fn, recurrence_fn=recurrence_fn,
               make_state=make_state, state_len=state_len, rec_chunk=rec_chunk)
    unit_states = [[] for _ in cfg.attn_pattern]
    for u in range(cfg.n_pattern_units):
        for i, ltype in enumerate(cfg.attn_pattern):
            x, st = _apply_layer(_index(params["unit"][i], u), x, cfg, ltype,
                                 positions, **run)
            unit_states[i].append(st)
    rem_states = []
    for i, p in enumerate(params.get("rem", ())):
        x, st = _apply_layer(p, x, cfg, _ltype(cfg, i), positions, **run)
        rem_states.append(st)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logits_slice is not None:
        x = x[:, -logits_slice:]
    out = x if return_features else unembed(params["embed"], x, cfg)
    if not make_state:
        return out
    state = {"unit": tuple(_stack(s) for s in unit_states),
             "rem": tuple(rem_states),
             "pos": torch.full((tokens.shape[0],), S, dtype=torch.int32,
                               device=x.device)}
    return out, state


# ---------------------------------------------------------------------------------
# Single-token decode
# ---------------------------------------------------------------------------------

def _apply_layer_decode(p: Dict[str, Any], x: torch.Tensor, st, pos: torch.Tensor,
                        cfg: ArchConfig, ltype: str,
                        decode_fn: Callable = decode_attention):
    """One token through one layer; ``st`` is written in place."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if ltype == SSM:
        out, st = ssm_mod.ssm_decode(p["ssm"], h, st, cfg)
        return x + out, st
    if ltype == RECURRENT:
        out, st = rglru_mod.rglru_decode(p["rec"], h, st, cfg)
    else:
        out, st = attn.attention_decode(p["attn"], h, st, pos, cfg, ltype,
                                        decode_fn=decode_fn)
    x = x + out
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], h, cfg.mlp), st


def _empty_layer_state(cfg: ArchConfig, ltype: str, batch: int, seq_len: int, dtype,
                       device=None):
    if ltype == SSM:
        return ssm_mod.empty_ssm_state(cfg, batch, dtype, device)
    if ltype == RECURRENT:
        return rglru_mod.empty_rglru_state(cfg, batch, dtype, device)
    return attn.empty_cache(cfg, ltype, batch, seq_len, dtype, device)


def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int,
                      dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """An empty decode state for ``batch`` slots of ``seq_len`` positions on
    ``device`` (default: the current default device, the CPU unless set).
    Recurrent states keep ``h`` in fp32 whatever ``dtype`` is, as the
    reference's do."""
    check_supported(cfg)
    n_units = cfg.n_pattern_units

    def stacked(st):
        if n_units == 0:
            return st
        return type(st)(*(leaf.expand(n_units, *leaf.shape).contiguous() for leaf in st))

    unit = tuple(stacked(_empty_layer_state(cfg, t, batch, seq_len, dtype, device))
                 for t in cfg.attn_pattern)
    rem = tuple(_empty_layer_state(cfg, _ltype(cfg, i), batch, seq_len, dtype, device)
                for i in range(cfg.n_remainder_layers))
    return {"unit": unit, "rem": rem,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def decode_step(
    params: Dict[str, Any],
    state: Dict[str, Any],
    token: torch.Tensor,                    # (B, 1) integer
    cfg: ArchConfig,
    *,
    decode_fn: Callable = decode_attention,
):
    """One autoregressive step. Returns ``(logits fp32 (B, Vp), new_state)``.

    Caches and recurrent states are updated in place: the returned state
    holds the same tensors as ``state`` (with ``pos`` advanced in a new
    tensor), so a caller that needs the old state clones it first.
    ``decode_fn`` is the attention core (kernel wrapper by default, or its
    plain version).
    """
    check_supported(cfg)
    pos = state["pos"]                                    # (B,) per-slot positions
    x = embed_tokens(params["embed"], token, cfg)
    for u in range(cfg.n_pattern_units):
        for i, ltype in enumerate(cfg.attn_pattern):
            unit_st = state["unit"][i]
            st = type(unit_st)(*(leaf[u] for leaf in unit_st))     # views
            x, _ = _apply_layer_decode(_index(params["unit"][i], u), x, st, pos, cfg,
                                       ltype, decode_fn)
    new_rem = []
    for i in range(cfg.n_remainder_layers):
        x, st = _apply_layer_decode(params["rem"][i], x, state["rem"][i], pos, cfg,
                                    _ltype(cfg, i), decode_fn)
        new_rem.append(st)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg)[:, 0]       # (B, Vp)
    new_state = dict(state)                               # "unit" updated in place
    new_state["rem"] = tuple(new_rem)
    new_state["pos"] = pos + 1
    return logits, new_state
