"""Operations and bytes of the program's kernels and of a decoder's useful
work, from shapes alone. The kernel families (`roofline/kernels/`) take their
bounds from here.

A kernel's bound is the least time the card could take for one launch: the
larger of its operations over the bf16 tensor-core peak (int4's mma runs in
bf16) and its bytes over the HBM rate. Bytes count each input the launch
needs read once and its output written once, whatever the kernel reads again
(split-K partials, re-read tiles). Attention counts the (query, key) pairs its
masks keep, so a launch is charged for what its inputs need and not for a
full square.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from .. import lookup
from .peaks import BF16_FLOP_PER_S, HBM_BYTES_PER_S


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def int4_cost(M: int, K: int, N: int, G: int, x_bytes: int = 2,
              y_bytes: int = 2) -> tuple[float, float]:
    """x [M, K] @ packed int4 w [K/2, N] bytes with f32 scales [G, N] ->
    y [M, N]: (operations, bytes). 2 M K N operations (a multiply and an
    add per weight and row); bytes: x, the packed weight, its scales, y."""
    return 2.0 * M * K * N, M * K * x_bytes + K * N / 2 + 4 * G * N + M * N * y_bytes


def attended_pairs(S: int, T: int, causal: bool, window: Optional[int],
                   q_offset: int, kv_len: int) -> int:
    """(query, key) pairs one head's masks keep: query s sits at position
    q_offset + s and sees keys below kv_len (and T), up to its own position
    when causal, and within `window` of it when windowed."""
    kv = min(kv_len, T)
    pos = np.arange(q_offset, q_offset + S, dtype=np.int64)
    hi = np.minimum(kv, pos + 1) if causal else np.full(S, kv, dtype=np.int64)
    lo = np.maximum(0, pos - window + 1) if window else 0
    return int(np.maximum(0, hi - lo).sum())


def flash_cost(B: int, H: int, Hkv: int, S: int, T: int, D: int, causal: bool,
               window: Optional[int], q_offset: int, kv_len: Optional[int],
               elem_bytes: int = 2) -> tuple[float, float]:
    """q [B, H, S, D] against k/v [B, Hkv, T, D]: (operations, bytes).
    4 D operations per kept pair (Q K^T and P V); bytes: q, the keys and
    values below kv_len, and the output."""
    kv = T if kv_len is None else min(kv_len, T)
    pairs = attended_pairs(S, T, causal, window, q_offset, kv)
    flops = 4.0 * B * H * pairs * D
    nbytes = elem_bytes * (2 * B * H * S * D + 2 * B * Hkv * kv * D)
    return flops, nbytes


def useful_flops(cfg: dict, prompt: int, new_tokens: int,
                 kroot: Path = lookup.KROOT) -> float:
    """Model operations of one request with no padding, as the architecture
    module of cfg's `model_type` counts them (`kbench/arch/<family>.py`; a
    new architecture is a new file there, with no edit here)."""
    return lookup.architecture(cfg, kroot).useful_flops(cfg, prompt, new_tokens)
