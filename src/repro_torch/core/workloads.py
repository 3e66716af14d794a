"""FunctionBench-analogue workload suite (port of ``repro.core.workloads``).

Seven serverless function classes with the paper's cost structure:
lightweight functions (helloworld, json_dumps_load, pyaes, chameleon) attach
to the small ``py-base`` runtime image; serving functions (lr/cnn/rnn_serving)
attach to progressively larger model images whose bring-up dominates their
cold start. Handlers are real computations, so execution is measured.

``prefill_logits`` is an eager closure over the port's ``forward``; PyTorch
needs no jit, so the "executables" of an image are plain callables and the
baseline's compile phase becomes the first (warm-up) forward.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.registry import Registry
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.models.config import GLOBAL_ATTN, ArchConfig
from repro_torch.models.transformer import forward, init_params

SERVE_BATCH = 1
SERVE_SEQ = 64


def _model_cfg(name: str, d: int, layers: int, vocab: int, ff_mult: int = 4) -> ArchConfig:
    return ArchConfig(
        name=name, family="dense", n_layers=layers, d_model=d,
        n_heads=max(d // 64, 1), n_kv_heads=max(d // 128, 1), d_ff=ff_mult * d,
        vocab_size=vocab, head_dim=64, attn_pattern=(GLOBAL_ATTN,),
        mlp="swiglu", tie_embeddings=True, max_seq_len=4096)


# The three model images (image id -> arch config)
IMAGE_CONFIGS: Dict[str, ArchConfig] = {
    "model-tiny": _model_cfg("model-tiny", 128, 2, 1024),
    "model-small": _model_cfg("model-small", 256, 4, 4096),
    "model-medium": _model_cfg("model-medium", 512, 8, 8192),
}
PY_BASE_BYTES = 8 << 20   # bare-runtime image blob size (paper: 8.1 MB)


def py_base_builder() -> Dict[str, np.ndarray]:
    """The 'bare Python runtime' image: an opaque pre-initialized blob."""
    rng = np.random.default_rng(0)
    return {"runtime_blob": rng.integers(0, 255, PY_BASE_BYTES, dtype=np.uint8)}


def model_params_builder(image_id: str, seed: int = 0,
                         device: DeviceLike = None) -> Callable[[], Any]:
    """A builder of the image's random bf16 parameters, drawn on ``device``
    (default ``cuda``; raises when there is no card unless ``device="cpu"``)
    from a ``torch.Generator`` seeded with ``seed``."""
    cfg = IMAGE_CONFIGS[image_id]
    dev = resolve_device(device)

    def build():
        gen = torch.Generator(device=dev).manual_seed(seed)
        return init_params(gen, cfg, torch.bfloat16)
    return build


def _param_device(params: Any) -> torch.device:
    return params["embed"]["tok"].device


def make_model_executables(image_id: str) -> Dict[str, Any]:
    """The image's step functions. Fresh closures of the same function are the
    baseline's per-cold-start set-up."""
    cfg = IMAGE_CONFIGS[image_id]

    def prefill_logits(params, tokens):
        return forward(params, tokens, cfg, logits_slice=1)[:, -1]

    return {"prefill_logits": prefill_logits}


def warm_executables(execs: Dict[str, Any], params: Any, image_id: str) -> None:
    """Run each step once at the serving shape and wait for the device (the
    baseline pays this per cold start)."""
    dev = _param_device(params)
    tokens = torch.zeros((SERVE_BATCH, SERVE_SEQ), dtype=torch.int64, device=dev)
    execs["prefill_logits"](params, tokens)
    synchronize(dev)


# ---------------------------------------------------------------------------------
# Handlers (the user code; never part of the shared image)
# ---------------------------------------------------------------------------------

def _head_builder(image_id: Optional[str], n_classes: int = 16, seed: int = 1):
    def build() -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(seed)
        if image_id is None or image_id == "py-base":
            return {"bias": rng.normal(size=(n_classes,)).astype(np.float32)}
        d = IMAGE_CONFIGS[image_id].d_model
        vp = ((IMAGE_CONFIGS[image_id].vocab_size + 511) // 512) * 512
        return {"w": (rng.normal(size=(vp, n_classes)) / np.sqrt(d)).astype(np.float32),
                "bias": np.zeros((n_classes,), np.float32)}
    return build


def handler_helloworld(params, hw, request, execs):
    return "hello world"


def handler_json(params, hw, request, execs):
    doc = {"items": [{"i": i, "v": float(i) * 1.5, "s": "x" * 32} for i in range(2000)]}
    for _ in range(5):
        doc = json.loads(json.dumps(doc))
    return len(json.dumps(doc))


def handler_pyaes(params, hw, request, execs):
    rng = np.random.default_rng(42)
    data = rng.integers(0, 255, 100_000, dtype=np.uint8)
    key = rng.integers(0, 255, 16, dtype=np.uint8)
    for r in range(10):                       # XOR block-cipher rounds (pyaes analogue)
        data = np.bitwise_xor(data, np.roll(np.resize(key, data.shape), r))
        data = np.roll(data, 7)
    return int(data.sum())


def handler_chameleon(params, hw, request, execs):
    rows = ["<tr>" + "".join(f"<td>{i}-{j}</td>" for j in range(10)) + "</tr>"
            for i in range(1500)]
    table = "<table>" + "".join(rows) + "</table>"
    return len(table)


def _handler_serving(params, hw, request, execs):
    dev = _param_device(params)
    tokens = torch.as_tensor(np.asarray(request["tokens"]), dtype=torch.int64, device=dev)
    logits = execs["prefill_logits"](params, tokens)          # (B, Vp) fp32
    w = torch.as_tensor(hw["w"], device=dev)
    bias = torch.as_tensor(hw["bias"], device=dev)
    cls = torch.argmax(logits @ w + bias, dim=-1)
    return cls.cpu().numpy()


@dataclass
class Workload:
    fn_id: str
    image_id: str
    handler_fn: Callable
    handler_builder: Callable
    request_builder: Callable[[], Any]
    # leaves the handler actually touches (LAZY restore transfers only these;
    # None = the whole image, the common case)
    touch_keys: Optional[List[str]] = None


def default_request():
    rng = np.random.default_rng(7)
    return {"tokens": rng.integers(0, 1000, (SERVE_BATCH, SERVE_SEQ), dtype=np.int32)}


#: Name -> :class:`Workload` registry.
WORKLOADS: Registry = Registry("workload")
for _w in (
    Workload("helloworld", "py-base", handler_helloworld,
             _head_builder(None), lambda: {}),
    Workload("json_dumps_load", "py-base", handler_json,
             _head_builder(None), lambda: {}),
    Workload("pyaes", "py-base", handler_pyaes,
             _head_builder(None), lambda: {}),
    Workload("chameleon", "py-base", handler_chameleon,
             _head_builder(None), lambda: {}),
    Workload("lr_serving", "model-tiny", _handler_serving,
             _head_builder("model-tiny"), default_request),
    Workload("cnn_serving", "model-small", _handler_serving,
             _head_builder("model-small"), default_request),
    Workload("rnn_serving", "model-medium", _handler_serving,
             _head_builder("model-medium"), default_request),
):
    WORKLOADS.register(_w.fn_id, _w)
del _w
