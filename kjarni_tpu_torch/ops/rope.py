"""Rotary position embeddings with llama3 frequency scaling (port of
kjarni_tpu/ops/rope.py). The frequency tables are numpy, computed once at
load; the rotation is torch."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.metadata import RopeScaling


def base_inv_freq(head_dim: int, theta: float) -> np.ndarray:
    exponents = np.arange(0, head_dim // 2, dtype=np.float64) * 2.0 / head_dim
    return (1.0 / np.power(theta, exponents)).astype(np.float32)


def llama3_inv_freq(head_dim: int, theta: float, scaling: RopeScaling) -> np.ndarray:
    """Llama-3 frequency scaling (cf. rope/mod.rs:31-64 calculate_inv_freq_llama3)."""
    inv_freq = base_inv_freq(head_dim, theta).astype(np.float64)
    orig = float(scaling.original_max_position_embeddings)
    low_wavelen = orig / scaling.low_freq_factor
    high_wavelen = orig / scaling.high_freq_factor
    wavelen = 2.0 * math.pi / inv_freq
    smooth = (orig / wavelen - scaling.low_freq_factor) / (
        scaling.high_freq_factor - scaling.low_freq_factor)
    scaled = np.where(
        wavelen < high_wavelen,
        inv_freq,
        np.where(
            wavelen > low_wavelen,
            inv_freq / scaling.factor,
            inv_freq / ((1.0 - smooth) * scaling.factor + smooth),
        ),
    )
    return scaled.astype(np.float32)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate q/k [B, H, S, D] by tables already gathered at their positions
    ([S, D], shared across the batch)."""
    c = cos.to(q.dtype)
    s = sin.to(q.dtype)
    return q * c + rotate_half(q) * s, k * c + rotate_half(k) * s
