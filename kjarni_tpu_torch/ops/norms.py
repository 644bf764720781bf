"""LayerNorm and RMSNorm, with statistics in float32 (port of
kjarni_tpu/ops/norms.py)."""

from __future__ import annotations

from typing import Optional

import torch


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm over the last axis, stats in f32, cast back to x's dtype.
    A bias of None is allowed."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (Llama-style): x / rms(x) * w, stats in f32 (f64 for f64 x, the
    training step's reference), cast back to x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * weight.to(acc)).to(x.dtype)
