"""The plain reference of the benchmark's decoders: float32 PyTorch, TF32 off.

A llama-family forward (llama, mistral and phi3 `config.json`s) written from the
published model code, with no kernel, cache or batching: embedding, then per
layer RMSNorm, q/k/v (Phi-3's fused `qkv_proj` split q, k, v), rotary position
embedding, causal softmax attention with grouped KV heads, o, RMSNorm and the
SwiGLU MLP (Phi-3's fused `gate_up_proj` split gate, up), then the final norm
and the head. Rotary tables follow the published rules: plain RoPE at
`rope_theta`, and Phi-3's LongRoPE as `modeling_phi3.py` and transformers'
`_compute_longrope_parameters` compute it: the long factor list where the
sequence is longer than `original_max_position_embeddings`, else the short one,
and every cos and sin scaled by sqrt(1 + ln(s) / ln(original)) with
s = max_position_embeddings / original_max_position_embeddings.

Weights are drawn again from the seed (`kbench/weights.py`), one kind at a
time; the model runs layer by layer over every sequence, so it fits beside
what the card still holds. `quant="int4"` applies this file's own frozen copy
of the int4 scheme the configuration states: groups of 128 along the input
dimension, scale = absmax / 7 in float32, values rounded half to even and
clamped to [-8, 7], on every projection and the head, not the embedding.

`precision="fp8"` is the control: every linear layer's input rounded to fp8
e4m3 with one scale per row (amax / 448), and, where the weights are not
already int4, the weights to e4m3 with one scale per output channel. It is
the nearest step below bf16, the one a later change might take.

Imports nothing of the program and takes nothing the program made.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..weights import draw, kinds

INT4_GROUP = 128
FP8_MAX = 448.0
ATTN_ROWS = 1024          # query rows per attention block


def _heads(cfg: dict) -> tuple[int, int, int]:
    H = cfg["num_attention_heads"]
    D = cfg.get("head_dim") or cfg["hidden_size"] // H
    return H, cfg.get("num_key_value_heads", H), D


def int4_dequant(w: torch.Tensor) -> torch.Tensor:
    """A [N, K] weight (out, in) quantized to int4 in groups of 128 along K,
    returned dequantized in f32 as [K, N] for x @ w. One scale per column
    where K is not a multiple of two groups."""
    w32 = w.float().t().contiguous()
    K, N = w32.shape
    g = INT4_GROUP if K % (2 * INT4_GROUP) == 0 else K
    wg = w32.reshape(K // g, g, N)
    scale = wg.abs().amax(dim=1).clamp_min(1e-8) / 7.0
    q = torch.clamp(torch.round(wg / scale[:, None, :]), -8, 7)
    return (q * scale[:, None, :]).reshape(K, N)


def _fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 with one scale per row (last dim), back in f32."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _weight(w: torch.Tensor, quant: Optional[str], precision: str) -> torch.Tensor:
    """A [N, K] bf16 weight as the f32 [K, N] the reference multiplies by."""
    if quant == "int4":
        return int4_dequant(w)
    wt = w.float().t().contiguous()
    if precision == "fp8":
        wt = _fp8_rows(wt.t()).t().contiguous()   # one scale per output channel
    return wt


def _linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    return (_fp8_rows(x) if precision == "fp8" else x) @ w


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w.float()


def rope_tables(cfg: dict, length: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 cos / sin [length, D] of one sequence of `length` tokens, from f64
    angles, by the published rule of the config's rope type."""
    _, _, D = _heads(cfg)
    theta = float(cfg.get("rope_theta", 10000.0))
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64) / D)
    scaling = 1.0
    rs = cfg.get("rope_scaling")
    if rs:
        rtype = rs.get("rope_type", rs.get("type"))
        if rtype not in ("longrope", "su"):
            raise NotImplementedError(f"reference rope type {rtype!r}")
        orig = cfg["original_max_position_embeddings"]
        factors = rs["long_factor"] if length > orig else rs["short_factor"]
        inv = inv / torch.tensor(factors, dtype=torch.float64)
        s = cfg["max_position_embeddings"] / orig
        if s > 1.0:
            scaling = math.sqrt(1.0 + math.log(s) / math.log(orig))
    ang = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return ((ang.cos() * scaling).float().to(device),
            (ang.sin() * scaling).float().to(device))


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def _attend(q, k, v, window: Optional[int]) -> torch.Tensor:
    """Causal attention of one sequence: q [H, S, D], k/v [Hkv, S, D] ->
    [S, H * D], in blocks of query rows."""
    H, S, D = q.shape
    G = H // k.shape[0]
    k = k.repeat_interleave(G, dim=0)
    v = v.repeat_interleave(G, dim=0)
    out = torch.empty(S, H, D, dtype=q.dtype, device=q.device)
    kj = torch.arange(S, device=q.device)
    for r0 in range(0, S, ATTN_ROWS):
        r1 = min(S, r0 + ATTN_ROWS)
        scores = (q[:, r0:r1] @ k[:, :r1].transpose(1, 2)) / math.sqrt(D)
        qi = torch.arange(r0, r1, device=q.device)[:, None]
        keep = kj[None, :r1] <= qi
        if window:
            keep = keep & (kj[None, :r1] > qi - window)
        scores = scores.masked_fill(~keep, float("-inf"))
        out[r0:r1] = (torch.softmax(scores, dim=-1) @ v[:, :r1]).transpose(0, 1)
    return out.reshape(S, H * D)


def _layer_weights(stacks: dict, cfg: dict, i: int, quant, precision) -> dict:
    """Layer i's weights in f32, split as the published model code splits
    Phi-3's fused projections."""
    H, Hkv, D = _heads(cfg)
    p = "model.layers.{}."

    def w(name):
        return _weight(stacks[p + name][i], quant, precision)

    if cfg["model_type"] == "phi3":
        qkv = w("self_attn.qkv_proj.weight")          # [hid, (H + 2 Hkv) D]
        gate_up = w("mlp.gate_up_proj.weight")         # [hid, 2 inter]
        inter = cfg["intermediate_size"]
        out = {"q": qkv[:, :H * D], "k": qkv[:, H * D:(H + Hkv) * D],
               "v": qkv[:, (H + Hkv) * D:],
               "gate": gate_up[:, :inter], "up": gate_up[:, inter:]}
    else:
        out = {n: w(f"self_attn.{n}_proj.weight") for n in ("q", "k", "v")}
        out.update({n: w(f"mlp.{n}_proj.weight") for n in ("gate", "up")})
    out["o"] = w("self_attn.o_proj.weight")
    out["down"] = w("mlp.down_proj.weight")
    out["attn_norm"] = stacks[p + "input_layernorm.weight"][i]
    out["ffn_norm"] = stacks[p + "post_attention_layernorm.weight"][i]
    return out


@torch.no_grad()
def logits_at(cfg: dict, seed: int, seqs: list, rows: list, device, *,
              quant: Optional[str] = None, precision: str = "f32") -> list:
    """The reference's f32 logits of each sequence at the given rows.

    seqs: token id lists, each a whole sequence (prompt and served tokens);
    rows: for each, the positions whose next-token logits are wanted.
    Returns one [len(rows_i), V] f32 tensor per sequence."""
    if precision not in ("f32", "fp8"):
        raise ValueError(f"unknown reference precision {precision!r}")
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits_at(cfg, seed, seqs, rows, torch.device(device), quant, precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _logits_at(cfg, seed, seqs, rows, device, quant, precision) -> list:
    H, Hkv, D = _heads(cfg)
    eps = cfg.get("rms_norm_eps", 1e-6)
    window = cfg.get("sliding_window")
    lens = [len(s) for s in seqs]
    starts = [sum(lens[:j]) for j in range(len(seqs))]
    ids = torch.tensor([t for s in seqs for t in s], dtype=torch.long, device=device)
    x = draw(cfg, seed, "model.embed_tokens.weight", device)[ids].float()
    tables = [rope_tables(cfg, n, device) for n in lens]
    stacks = {p: draw(cfg, seed, p, device) for p in kinds(cfg) if "{}" in p}
    for i in range(cfg["num_hidden_layers"]):
        lw = _layer_weights(stacks, cfg, i, quant, precision)
        h = _rms_norm(x, lw["attn_norm"], eps)
        q, k, v = (_linear(h, lw[n], precision) for n in ("q", "k", "v"))
        ctx = torch.empty_like(q)
        for j, (s0, n) in enumerate(zip(starts, lens)):
            cos, sin = tables[j]
            qj = _rotate(q[s0:s0 + n].reshape(n, H, D).transpose(0, 1), cos, sin)
            kj = _rotate(k[s0:s0 + n].reshape(n, Hkv, D).transpose(0, 1), cos, sin)
            vj = v[s0:s0 + n].reshape(n, Hkv, D).transpose(0, 1)
            ctx[s0:s0 + n] = _attend(qj, kj, vj, window)
        x = x + _linear(ctx, lw["o"], precision)
        h = _rms_norm(x, lw["ffn_norm"], eps)
        act = torch.nn.functional.silu(_linear(h, lw["gate"], precision)) * \
            _linear(h, lw["up"], precision)
        x = x + _linear(act, lw["down"], precision)
        del lw, h, q, k, v, ctx, act
    del stacks
    sel = torch.tensor([s0 + r for s0, rr in zip(starts, rows) for r in rr],
                       dtype=torch.long, device=device)
    hn = _rms_norm(x[sel], draw(cfg, seed, "model.norm.weight", device), eps)
    head_name = "model.embed_tokens.weight" if cfg.get("tie_word_embeddings", False) \
        else "lm_head.weight"
    head = _weight(draw(cfg, seed, head_name, device), quant, precision)
    logits = _linear(hn, head, precision)
    out, at = [], 0
    for rr in rows:
        out.append(logits[at:at + len(rr)])
        at += len(rr)
    return out
