"""Scaled dot-product attention with GQA, as plain torch ops (port of
kjarni_tpu/ops/attention.py, which was XLA einsums and not a Pallas kernel).

Scores and the max-subtract stay f32; probabilities drop to bf16 on bf16
inputs, as in the JAX package. Long prefills go through the hand-written
flash kernel instead (ops/kernels/flash_attention.py).
"""

from __future__ import annotations

from typing import Optional

import torch

# the masks' finite "minus infinity"; the flash kernel keeps its own -1e30
from .masks import NEG_INF  # noqa: F401


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Hq, S, D], k/v [B, Hkv, T, D] -> [B, Hq, S, D] in q's dtype.

    `bias` broadcasts against [B, Hq, S, T]. The G = Hq/Hkv query heads of one
    KV head fold into [B, Hkv, G, S, D], so K/V are never repeated.
    """
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    acc = torch.promote_types(q.dtype, torch.float32)   # f64 stays f64
    prob_dtype = torch.bfloat16 if q.dtype == torch.bfloat16 else acc

    qg = q.reshape(B, Hkv, G * S, D)
    scores = torch.matmul(qg.to(acc), k.to(acc).transpose(-1, -2)) * scale
    scores = scores.reshape(B, Hkv, G, S, -1)
    if bias is not None:
        bias = torch.broadcast_to(bias.to(acc), (B, Hq, S, scores.shape[-1]))
        scores = scores + bias.reshape(B, Hkv, G, S, -1)
    shifted = scores - scores.amax(dim=-1, keepdim=True)
    probs = torch.exp(shifted.to(prob_dtype))
    probs = probs / probs.sum(dim=-1, keepdim=True).to(prob_dtype)
    out = torch.matmul(probs.to(q.dtype).reshape(B, Hkv, G * S, -1), v)
    return out.reshape(B, Hq, S, D)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H*D] -> [B, H, S, D]"""
    B, S, HD = x.shape
    return x.reshape(B, S, num_heads, HD // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] -> [B, S, H*D]"""
    B, H, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, H * D)
