"""Diagonal linear recurrence and causal depthwise convolution (port of
``repro.models.recurrence``).

Shared by the Mamba-1 selective scan (channels = d_inner x ssm_state) and the
RG-LRU (channels = lru_width). The reference walks the sequence in chunks (an
outer ``lax.scan`` carrying the state, an ``associative_scan`` inside each
chunk); here the recurrence is the ``diag_recurrence`` kernel, which carries
the state through the whole sequence inside one launch.

The convolution stays a library op, as in the reference, which computes it
outside Pallas: ``F.conv1d`` with one group per channel, the product in fp32,
then the cast to the input dtype, then the bias. On the card an fp32
convolution follows ``torch.backends.cudnn.allow_tf32``; a run that holds fp32
results to a reference turns it off (``chip_smoke.py`` and
``launch/serve.py`` do).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.diag_recurrence import diag_recurrence


def chunked_diag_recurrence(
    a: torch.Tensor,          # (B, S, *C) decay per step
    b: torch.Tensor,          # (B, S, *C) input per step
    h0: torch.Tensor,         # (B, *C) initial state
    *,
    recurrence_fn: Callable = diag_recurrence,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h_all (B, S, *C), h_final (B, *C))`` of ``h_t = a_t * h_{t-1} + b_t``.

    The trailing channel dims are flattened to one for ``recurrence_fn`` (the
    kernel wrapper by default, or its plain version) and restored after. The
    reference's ``chunk`` bounds its scan's live memory; the kernel keeps
    only the state live, so the port takes none.
    """
    B, S = a.shape[0], a.shape[1]
    ch = a.shape[2:]
    h_all, h_final = recurrence_fn(a.reshape(B, S, -1), b.reshape(B, S, -1),
                                   h0.reshape(B, -1))
    return h_all.reshape(B, S, *ch), h_final.reshape(B, *ch)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C); w: (C, width)."""
    width = w.shape[1]
    xp = F.pad(x.float().transpose(1, 2), (width - 1, 0))      # (B, C, S + width - 1)
    out = F.conv1d(xp, w.float()[:, None, :], groups=x.shape[-1])
    out = out.transpose(1, 2).to(x.dtype)
    if b is not None:
        out = out + b
    return out


def causal_conv1d_step(
    x_new: torch.Tensor,       # (B, 1, C)
    conv_state: torch.Tensor,  # (B, width-1, C) trailing inputs
    w: torch.Tensor,           # (C, width)
    b: Optional[torch.Tensor] = None,
):
    """Single-token conv step; returns ``(out (B, 1, C), new_state)``."""
    window = torch.cat([conv_state, x_new], dim=1)              # (B, width, C)
    out = torch.einsum("bwc,cw->bc", window.float(), w.float()).to(x_new.dtype)[:, None]
    if b is not None:
        out = out + b
    return out, window[:, 1:]


def conv_tail(x: torch.Tensor, width: int) -> torch.Tensor:
    """The last ``width - 1`` inputs of x (B, S, C), zero-padded in front
    when S is shorter: a new tensor, the conv state a prefill leaves."""
    tail = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    n = min(width - 1, x.shape[1])
    if n:
        tail[:, width - 1 - n:] = x[:, x.shape[1] - n:]
    return tail
