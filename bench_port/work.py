"""The yardstick: the card's published peaks and each kernel's bytes and
operations, computed from shapes.

``HBM_BYTES_PER_S``, ``PEAK_FLOPS``, ``bound_s`` and ``recurrence_work`` are
frozen copies of ``HBM_BYTES_PER_S``, ``PEAK_FLOPS``, ``bound_ms`` and
``recurrence_work`` in ``src/repro_torch/kernels/sweep.py`` (seconds here,
not ms); ``attention_pairs`` and the flash operations are copied from
``flash_attention_pairs``/``flash_attention_flops`` in
``src/repro_torch/kernels/flash_attention/ops.py``. Each counts an input
byte read once and an output byte written once, whatever the kernel reads
again, and the operations the inputs need (the pairs a mask leaves).
Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W.
"""
from __future__ import annotations

from typing import Optional

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
#: dense, per the data sheet: bf16 on the tensor cores, float32 on the CUDA
#: cores
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SSM_CHUNK = 256                # positions per diag_recurrence call (models/ssm.py)


def bound_s(moved: int, ops: int, dtype: str = "bfloat16") -> float:
    """The least time the card could take: the larger of ``moved`` bytes over
    the memory rate and ``ops`` operations over the peak rate for ``dtype``."""
    return max(moved / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])


def gather_work(bytes_out: int) -> int:
    """page_gather: each page read once from the pool and written once."""
    return 2 * bytes_out


def recurrence_work(B: int, S: int, C: int):
    """(bytes, operations) of one diag_recurrence call: a, b and h_all once,
    h0 and h_final once, in fp32."""
    return 3 * B * S * C * 4 + 2 * B * C * 4, 2 * B * S * C


def ssm_prefill_recurrence(L: int, C: int, n_layers: int):
    """(bytes, operations) of every diag_recurrence call of one prompt of L
    tokens through an SSM model: one call per layer and chunk of
    :data:`SSM_CHUNK` positions, B = 1."""
    moved = ops = 0
    for c0 in range(0, L, SSM_CHUNK):
        m, o = recurrence_work(1, min(SSM_CHUNK, L - c0), C)
        moved, ops = moved + m, ops + o
    return n_layers * moved, n_layers * ops


def attention_pairs(Sq: int, Sk: int, causal: bool, window: Optional[int]) -> int:
    """The (query, key) pairs the mask leaves (query i, key j: ``j <= i``
    when causal, ``i - j < window`` with a window)."""
    total = 0
    for i in range(Sq):
        lo = max(i - window + 1, 0) if window is not None else 0
        hi = min(i, Sk - 1) if causal else Sk - 1
        total += max(hi - lo + 1, 0)
    return total


def flash_work(B: int, H: int, Hkv: int, S: int, d: int, window: Optional[int],
               esize: int = 2):
    """(bytes, operations) of one causal flash_attention call: q, k, v read
    once and the output written once; two products of 2 FLOPs a
    multiply-add over the pairs the mask leaves."""
    moved = (2 * B * H * S * d + 2 * B * Hkv * S * d) * esize
    return moved, 4 * B * H * d * attention_pairs(S, S, True, window)
