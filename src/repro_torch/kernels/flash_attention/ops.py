"""Flash attention: blockwise online-softmax attention for prefill.

Replaces the TPU kernel ``src/repro/kernels/flash_attention/kernel.py``
(``flash_attention_pallas``), with the same contract: q ``(B, H, Sq, d)``,
k/v ``(B, Hkv, Sk, d)``, causal / sliding-window / softcap options, GQA by
``h -> h // g``, fp32 accumulation, output in ``q.dtype``.

On the card it is bound by operations at the prefill shapes. The CUDA kernel
(``csrc/flash_attention.cu``) keeps the whole softmax on chip: one block per
(64-row q tile, batch*head) loops over 64-key kv tiles staged in shared
memory, with the running max, denominator and accumulator in fp32 registers,
and skips kv tiles that the causal or window mask hides from the whole q tile.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from repro_torch.kernels.build import check, library

NEG_INF = -2.0e38
HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()


def flash_attention_plain(q, k, v, *, causal=True, window=None, softcap=None,
                          scale=None) -> torch.Tensor:
    """Plain PyTorch version, mirroring ``flash_attention/ref.py``: fp32
    einsum, softcap, finite ``NEG_INF`` mask, softmax, einsum, cast."""
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(B, Hkv, g, Sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= (qi - ki) < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(B, H, Sq, d).to(q.dtype)


def _launch_fn():
    fn = library("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention over q ``(B, H, Sq, d)`` and k/v ``(B, Hkv, Sk, d)``.

    CPU tensors run :func:`flash_attention_plain`; CUDA tensors launch the
    kernel (contiguous fp32 or bf16, d in 32/64/128/256), counted in
    ``flash_attention.launches``.
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,H,Sq,d) and k/v (B,Hkv,Sk,d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != d or Hkv == 0 or H % Hkv:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k {tuple(k.shape)}")
    if Sk == 0:
        raise ValueError("attention over zero keys is undefined")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dim in {HEAD_DIMS}, got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the grid limit 65535")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    fn = _launch_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, H, Hkv, Sq, Sk, d, _DTYPE_CODES[q.dtype], float(scale),
                    int(causal), int(window is not None),
                    int(window) if window is not None else 0,
                    int(softcap is not None),
                    float(softcap) if softcap is not None else 0.0, stream)
    check(status, "flash_attention")
    with _count_lock:
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
