"""Rotary position embeddings with llama3 frequency scaling (port of
kjarni_tpu/ops/rope.py). The frequency tables are numpy, computed once at
load; the rotation is torch."""

from __future__ import annotations

import math
from typing import Optional

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


def rope_tables(head_dim: int, max_seq_len: int, theta: float = 10000.0,
                scaling: Optional[RopeScaling] = None) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) f32 tables [max_seq_len, head_dim], the half-dim frequencies
    duplicated into both halves (the rotate-half convention). Positions are
    f32, as in the JAX package's rope_tables (llama.rope_cache takes f64), so
    the angles round the same way."""
    if scaling is not None and scaling.rope_type == "llama3":
        inv = llama3_inv_freq(head_dim, theta, scaling)
    else:
        inv = base_inv_freq(head_dim, theta)
    pos = np.arange(max_seq_len, dtype=np.float32)
    angles = np.outer(pos, inv)  # [S, D/2]
    cos = np.concatenate([np.cos(angles), np.cos(angles)], axis=-1)
    sin = np.concatenate([np.sin(angles), np.sin(angles)], axis=-1)
    return cos.astype(np.float32), sin.astype(np.float32)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate q/k [B, H, S, D] by tables already gathered at their positions:
    [S, D] shared across the batch, or [B, 1, S, D] per row."""
    c = cos.to(q.dtype)
    s = sin.to(q.dtype)
    return q * c + rotate_half(q) * s, k * c + rotate_half(k) * s
