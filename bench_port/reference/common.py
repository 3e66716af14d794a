"""Plain fp32 PyTorch pieces shared by the reference models, and the
function that runs a reference model over a sample of prompts.

The reference imports nothing of the program: it makes the weights again
from the seed (``weights.py``), runs them in fp32 with TF32 off, one layer
at a time over every sampled prompt, and ends in the tenant's 16-class head.
``mm`` is the one matrix product every projection goes through: the plain
fp32 product, or :func:`mm_fp8` for the precision control.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from bench_port.reference import weights

FP8_MAX = 448.0      # the largest finite float8_e4m3fn


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest |value| maps to 448), back in fp32."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def mm_fp8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The control's product: activations rounded to fp8 by row, weights by
    output column, then multiplied in fp32."""
    return fp8(x, -1) @ fp8(w, 0)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm with the (1 + scale) parameterisation."""
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * (1.0 + scale)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (L, H, hd) at positions 0..L-1, in the
    half-split form (the first half of each head rotates with the second)."""
    L, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] * inv
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def class_logits(family, c: dict, seed: int, prompts: Sequence[torch.Tensor],
                 heads: Sequence[Tuple[torch.Tensor, torch.Tensor]], device,
                 product: Callable = mm) -> List[torch.Tensor]:
    """The 16 class logits (fp32) of each prompt: embed, ``family.block``
    layer by layer (each told its index), the final norm at the last
    position, the output head, then the tenant's head ``(W (Vp, 16), b (16,))``."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            tok = weights.top(c, seed, "tok", device, served=False)
            xs = [tok[p.long()] for p in prompts]
            del tok
            for i in range(c["num_hidden_layers"]):
                w = weights.layer(family, c, seed, i, device, served=False)
                xs = [family.block(w, x, c, product, i) for x in xs]
                del w
            norm = weights.top(c, seed, "final_norm", device, served=False)
            head = weights.top(c, seed, "head", device, served=False)
            out = []
            for x, (cw, cb) in zip(xs, heads):
                h = rmsnorm(x[-1:], norm, family.norm_eps(c))
                out.append((product(h, head) @ cw + cb)[0])
            return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """How far one answer lies from the reference's: the largest |difference|
    over the 16 logits, over the reference logits' root mean square."""
    r = reference.double()
    return float((program.double() - r).abs().max() / r.square().mean().sqrt())


def rms_gap(programs: Sequence[torch.Tensor], references: Sequence[torch.Tensor]) -> float:
    """How far a sample of answers lies from the reference's: the root mean
    square of the differences over every answer's 16 logits, over the
    reference logits' root mean square (the number the check compares)."""
    if not references:
        return float("inf")
    p = torch.stack([x.double().cpu() for x in programs])
    r = torch.stack([x.double().cpu() for x in references])
    return float((p - r).square().mean().sqrt() / r.square().mean().sqrt())
