"""Sentence pooling strategies (port of kjarni_tpu/ops/pooling.py)."""

from __future__ import annotations

import enum
from typing import Optional

import torch


class PoolingStrategy(str, enum.Enum):
    MEAN = "mean"
    CLS = "cls"
    MAX = "max"
    LAST = "last"


def mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the sequence axis. hidden: [B, S, H], mask: [B, S]."""
    m = attention_mask.to(hidden.dtype)[..., None]
    summed = (hidden * m).sum(dim=1)
    counts = m.sum(dim=1).clamp_min(1e-9)
    return summed / counts


def cls_pool(hidden: torch.Tensor,
             attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return hidden[:, 0, :]


def max_pool(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    m = attention_mask.bool()[..., None]
    neg = torch.full_like(hidden, -1e9)
    return torch.where(m, hidden, neg).amax(dim=1)


def last_token_pool(hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    lengths = attention_mask.to(torch.int64).sum(dim=1)
    idx = (lengths - 1).clamp_min(0)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]


def pool(strategy: PoolingStrategy, hidden: torch.Tensor,
         attention_mask: torch.Tensor) -> torch.Tensor:
    if strategy == PoolingStrategy.MEAN:
        return mean_pool(hidden, attention_mask)
    if strategy == PoolingStrategy.CLS:
        return cls_pool(hidden, attention_mask)
    if strategy == PoolingStrategy.MAX:
        return max_pool(hidden, attention_mask)
    if strategy == PoolingStrategy.LAST:
        return last_token_pool(hidden, attention_mask)
    raise ValueError(f"Unknown pooling strategy {strategy}")
