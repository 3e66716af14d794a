"""Architecture configuration system.

Every assigned architecture (plus the paper-workload analogues and reduced smoke
variants) is expressed as an :class:`ArchConfig`. The model code in this package is
written against this single config type, so a new architecture is a new config file,
not new model code.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple


# Layer-type tags used in ``attn_pattern`` (the repeating temporal-mixing unit).
GLOBAL_ATTN = "global"      # full causal attention
LOCAL_ATTN = "local"        # sliding-window causal attention
RECURRENT = "recurrent"     # RG-LRU block (Griffin / recurrentgemma)
SSM = "ssm"                 # Mamba-1 selective-scan block


@dataclass(frozen=True)
class ArchConfig:
    """A complete architecture description.

    ``attn_pattern`` is the repeating unit of temporal-mixing layer types; the model
    applies ``n_layers`` layers by cycling the pattern (remainder layers allowed, e.g.
    recurrentgemma's 26 = 8x(R,R,A) + (R,R)). Scan-over-layers stacks parameters per
    pattern *unit*, keeping the lowered HLO size independent of depth.
    """

    name: str
    family: str                     # dense | ssm | hybrid | moe | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    attn_pattern: Tuple[str, ...] = (GLOBAL_ATTN,)
    window: int = 4096              # sliding-window size for LOCAL_ATTN layers
    attn_logit_softcap: Optional[float] = None   # gemma2: 50.0
    final_logit_softcap: Optional[float] = None  # gemma2: 30.0
    qk_norm: bool = False           # qwen3: RMSNorm on per-head q,k
    qkv_bias: bool = False          # qwen1.5: bias on qkv projections
    mlp: str = "swiglu"             # swiglu | geglu | gelu (plain 2-matrix MLP)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    expert_pad_to: int = 0          # pad expert tensors so EP shards evenly (perf
                                    # iteration B, EXPERIMENTS.md §Perf); 0 = off

    # SSM (Mamba-1)
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None   # defaults to ceil(d_model / 16)

    # Hybrid (RG-LRU / Griffin)
    lru_width: Optional[int] = None  # defaults to d_model
    conv1d_width: int = 4

    # Encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    n_enc_positions: int = 1500     # whisper: 1500 audio frames after conv frontend

    # Modality frontend stubs ([audio]/[vlm]: input_specs supplies embeddings)
    frontend: Optional[str] = None  # None | 'audio_frames' | 'vision_patches'
    n_frontend_tokens: int = 0      # prepended embedding tokens for vlm

    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    emb_scale: bool = False         # gemma-style sqrt(d_model) embedding scaling
    max_seq_len: int = 1 << 20      # positions supported structurally

    # ---- derived sizes -------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank if self.dt_rank is not None else math.ceil(self.d_model / 16)

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width if self.lru_width is not None else self.d_model

    @property
    def n_experts_padded(self) -> int:
        import os
        if os.environ.get("REPRO_PERF_BASELINE", "") == "1":
            return self.n_experts
        return max(self.n_experts, self.expert_pad_to)

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.expand * self.d_model

    @property
    def n_pattern_units(self) -> int:
        return self.n_layers // len(self.attn_pattern)

    @property
    def n_remainder_layers(self) -> int:
        return self.n_layers - self.n_pattern_units * len(self.attn_pattern)

    @property
    def is_attention_free(self) -> bool:
        return all(t in (SSM, RECURRENT) for t in self.attn_pattern)

    @property
    def has_bounded_kv(self) -> bool:
        """True when no layer keeps an unbounded (full-sequence) KV cache."""
        return all(t != GLOBAL_ATTN for t in self.attn_pattern)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs eligible for the ``long_500k`` shape.

        Per DESIGN.md §4: SSM / hybrid / SWA archs qualify; gemma2's alternating
        local/global also qualifies (decode is O(1) per token per local layer and
        O(seq) only on global layers, with the sharded cache fitting the pod).
        """
        if self.is_encoder_decoder:
            return False
        return any(t in (SSM, RECURRENT, LOCAL_ATTN) for t in self.attn_pattern)

    # ---- parameter counting (for roofline MODEL_FLOPS and pool accounting) ---
    def param_count(self, *, include_embeddings: bool = True) -> int:
        d, h = self.d_model, self.resolved_head_dim
        total = 0
        per_type = {}
        # temporal-mixing layer params by type
        attn = d * (self.n_heads * h) + 2 * d * (self.n_kv_heads * h) + (self.n_heads * h) * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * h
        per_type[GLOBAL_ATTN] = attn
        per_type[LOCAL_ATTN] = attn
        di = self.d_inner
        per_type[SSM] = (
            d * 2 * di                      # in_proj
            + di * self.d_conv              # depthwise conv
            + di * (self.resolved_dt_rank + 2 * self.ssm_state)  # x_proj
            + self.resolved_dt_rank * di + di                    # dt_proj
            + di * self.ssm_state + di      # A_log, D
            + di * d                        # out_proj
        )
        w = self.resolved_lru_width
        per_type[RECURRENT] = (
            2 * d * w                       # linear_x, linear_y branch
            + w * self.conv1d_width         # conv1d
            + 2 * w                         # RG-LRU a-param, input-gate... (diag)
            + 2 * w * w // 1                # gates (approx: input & recurrence gates are diag-block; use w each)
            + w * d                         # out proj
        )
        # MLP params per layer
        if self.n_experts > 0:
            mlp = self.n_experts * (3 if self.mlp in ("swiglu", "geglu") else 2) * d * self.d_ff
            mlp += d * self.n_experts       # router
        else:
            mlp = (3 if self.mlp in ("swiglu", "geglu") else 2) * d * self.d_ff
        for i in range(self.n_layers):
            t = self.attn_pattern[i % len(self.attn_pattern)]
            total += per_type[t]
            if t != SSM:                    # mamba blocks replace attn+mlp together
                total += mlp
            total += 2 * d                  # norms
        if self.is_encoder_decoder:
            enc = self.n_enc_layers * (per_type[GLOBAL_ATTN] + mlp + 2 * d)
            xattn = self.n_layers * per_type[GLOBAL_ATTN]  # cross-attention
            total += enc + xattn
        if include_embeddings:
            total += self.vocab_size * d
            if not self.tie_embeddings:
                total += self.vocab_size * d
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.param_count(include_embeddings=False)
        full = self.param_count(include_embeddings=False)
        expert_mlp = (3 if self.mlp in ("swiglu", "geglu") else 2) * self.d_model * self.d_ff
        inactive = (self.n_experts - self.top_k) * expert_mlp * self.n_layers
        return int(full - inactive)

    def validate(self) -> None:
        assert self.n_layers >= len(self.attn_pattern) or self.n_layers > 0
        assert self.n_heads % max(self.n_kv_heads, 1) == 0 or self.is_attention_free
        if self.n_experts:
            assert 0 < self.top_k <= self.n_experts

    def reduced(self, **overrides) -> "ArchConfig":
        """A tiny same-family variant for CPU smoke tests."""
        base = dict(
            n_layers=min(self.n_layers, 2 * len(self.attn_pattern)),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            window=min(self.window, 16),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            capacity_factor=4.0,  # no token drops at smoke-test scale

            ssm_state=min(self.ssm_state, 4) if self.ssm_state else 0,
            dt_rank=4 if self.ssm_state else None,
            lru_width=32 if RECURRENT in self.attn_pattern else None,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_enc_positions=min(self.n_enc_positions, 16),
            n_frontend_tokens=min(self.n_frontend_tokens, 4),
            max_seq_len=1 << 12,
        )
        base.update(overrides)
        out = dataclasses.replace(self, name=self.name + "-reduced", **base)
        out.validate()
        return out


# ---------------------------------------------------------------------------------
# Input shapes assigned to the LM family (assignment: 4 shapes x 10 archs = 40 cells)
# ---------------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
