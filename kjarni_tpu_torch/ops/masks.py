"""Attention masks as additive biases (port of kjarni_tpu/ops/masks.py).

0 keeps a position and NEG_INF drops it. NEG_INF is finite, so a row whose
every position is masked softmaxes to uniform instead of NaN.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9  # finite "minus infinity" that survives bf16 softmax without NaNs


def causal_mask(seq_len: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[seq, seq] additive causal bias: 0 on/below the diagonal, NEG_INF above."""
    i = torch.arange(seq_len, device=device)[:, None]
    j = torch.arange(seq_len, device=device)[None, :]
    return torch.where(j <= i, 0.0, NEG_INF).to(dtype)


def causal_mask_with_offset(q_len: int, kv_len: int, offset: int,
                            dtype=torch.float32, device=None) -> torch.Tensor:
    """[q_len, kv_len] causal bias where query i sits at position offset + i."""
    qi = torch.arange(q_len, device=device)[:, None] + offset
    kj = torch.arange(kv_len, device=device)[None, :]
    return torch.where(kj <= qi, 0.0, NEG_INF).to(dtype)


def padding_bias(attention_mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[batch, kv] 0/1 mask -> [batch, 1, 1, kv] additive bias."""
    bias = (1.0 - attention_mask.float()) * NEG_INF
    return bias[:, None, None, :].to(dtype)


def combine(*biases: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Sum additive biases, broadcasting; None entries are skipped."""
    out = None
    for b in biases:
        if b is None:
            continue
        out = b if out is None else out + b
    return out
