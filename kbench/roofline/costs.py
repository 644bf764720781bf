"""Operations and bytes of the program's kernels and of a decoder's useful
work, from shapes alone.

A kernel's bound is the least time the card could take for one launch: the
larger of its operations over the bf16 tensor-core peak (int4's mma runs in
bf16) and its bytes over the HBM rate. Bytes count each input the launch
needs read once and its output written once, whatever the kernel reads again
(split-K partials, re-read tiles). Attention counts the (query, key) pairs its
masks keep, so a launch is charged for what its inputs need and not for a
full square.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

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


def matmul_params(cfg: dict) -> tuple[int, int]:
    """(weights of every layer's projections, weights of the head) of a
    llama-family config: the multiply-adds one token costs outside
    attention."""
    hid, inter = cfg["hidden_size"], cfg["intermediate_size"]
    H = cfg["num_attention_heads"]
    Hkv = cfg.get("num_key_value_heads", H)
    D = cfg.get("head_dim") or hid // H
    per_layer = hid * (H + 2 * Hkv) * D + H * D * hid + 3 * hid * inter
    return per_layer * cfg["num_hidden_layers"], hid * cfg["vocab_size"]


def useful_flops(cfg: dict, prompt: int, new_tokens: int) -> float:
    """Model operations of one request with no padding: the prompt's
    projections and causal attention, the head once for the first token,
    then each further token over its whole context. A request that returns
    n tokens runs n - 1 decode forwards after its prefill."""
    layers_w, head_w = matmul_params(cfg)
    H = cfg["num_attention_heads"]
    D = cfg.get("head_dim") or cfg["hidden_size"] // H
    L = cfg["num_hidden_layers"]
    attn_per_pair = 4.0 * H * D * L
    flops = 2.0 * layers_w * prompt + attn_per_pair * prompt * (prompt + 1) / 2
    flops += 2.0 * head_w
    for j in range(1, new_tokens):
        ctx = prompt + j               # keys the j-th decode forward attends
        flops += 2.0 * (layers_w + head_w) + attn_per_pair * ctx
    return flops
