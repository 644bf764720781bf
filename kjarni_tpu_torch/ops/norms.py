"""RMSNorm, with statistics in float32 (port of kjarni_tpu/ops/norms.py)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (Llama-style): x / rms(x) * w, stats in f32, cast back to x's dtype."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * weight.float()).to(x.dtype)
