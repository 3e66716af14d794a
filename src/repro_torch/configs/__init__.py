"""Assigned-architecture registry (port of ``repro.configs``).

Each module defines ``CONFIG``, the exact published configuration, copied from
the JAX package so the port never imports it. ``get_config(name)`` and
``list_archs()`` are the programmatic API; ``get_reduced(name)`` returns the
CPU smoke-test variant. The port's model runs every id: the dense ones
(gemma2_27b, qwen3_1_7b, h2o_danube3_4b, qwen1_5_0_5b, fnbench_tiny),
falcon_mamba_7b (SSM), recurrentgemma_2b (RG-LRU hybrid), the MoE ones
(granite_moe_3b_a800m, moonshot_v1_16b_a3b), whisper_small (encoder-decoder)
and internvl2_1b (VLM). The serving engine admits token prompts only, as the
reference's does, so whisper and internvl2 are served through
``models.api.make_prefill_step`` with their stub frontend embeddings.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig

ARCH_IDS = (
    "gemma2_27b",
    "qwen3_1_7b",
    "h2o_danube3_4b",
    "qwen1_5_0_5b",
    "falcon_mamba_7b",
    "whisper_small",
    "recurrentgemma_2b",
    "granite_moe_3b_a800m",
    "moonshot_v1_16b_a3b",
    "internvl2_1b",
    # paper-workload analogues (serverless function classes from Table 1)
    "fnbench_tiny",
)

_ALIASES = {
    "gemma2-27b": "gemma2_27b",
    "qwen3-1.7b": "qwen3_1_7b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "h2o-danube3-4b": "h2o_danube3_4b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "whisper-small": "whisper_small",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "internvl2-1b": "internvl2_1b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    cfg: ArchConfig = mod.CONFIG
    cfg.validate()
    return cfg


def get_reduced(name: str, **overrides) -> ArchConfig:
    return get_config(name).reduced(**overrides)


def list_archs() -> tuple:
    return ARCH_IDS


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
