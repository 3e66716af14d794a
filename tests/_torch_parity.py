"""Shared helpers for the tests that hold the PyTorch port against the JAX
package: arrays cross between the two as numpy (bf16 as its uint16 bits)."""
from __future__ import annotations

import numpy as np
import torch


def to_torch(a) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor, bit for bit (bf16 included)."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def to_f32(t) -> np.ndarray:
    """A tensor or array as float32 numpy, for tolerance comparisons."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t).astype(np.float32)


def tree_to_torch(tree):
    """JAX pytree (dicts / tuples) -> the same nesting of CPU tensors."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to_torch(v) for v in tree)
    return to_torch(tree)


def pages_to_torch(store) -> torch.Tensor:
    return torch.from_numpy(np.array(store, dtype=np.uint8))


def frontend(cfg, batch: int, rng) -> dict:
    """The stub frontend's part of a batch: whisper's frames, or a VLM's
    patches (fp32, from the numpy generator ``rng``); empty for token-only
    configs."""
    if cfg.frontend == "audio_frames":
        return {"frames": rng.standard_normal(
            (batch, cfg.n_enc_positions, cfg.d_model)).astype(np.float32)}
    if cfg.frontend == "vision_patches":
        return {"patches": rng.standard_normal(
            (batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)}
    return {}
