"""The llama family: llama, mistral and phi3 `config.json`s. Dense decoders
with grouped KV heads and at most one sliding window, used alike by every
layer.

The reference forward is written from the published model code: embedding,
then per layer RMSNorm, q/k/v (Phi-3's fused `qkv_proj` split q, k, v), rotary
position embedding, causal softmax attention with grouped KV heads, o, RMSNorm
and the SwiGLU MLP (Phi-3's fused `gate_up_proj` split gate, up), then the
final norm and the head. Rotary tables follow the published rules: plain RoPE
at `rope_theta`, and Phi-3's LongRoPE as `modeling_phi3.py` and transformers'
`_compute_longrope_parameters` compute it: the long factor list where the
sequence is longer than `original_max_position_embeddings`, else the short one,
and every cos and sin scaled by sqrt(1 + ln(s) / ln(original)) with
s = max_position_embeddings / original_max_position_embeddings.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from kbench.reference.decoder import linear, rms_norm, weight
from kbench.weights import draw

MODEL_TYPES = ("llama", "mistral", "phi3")
ATTN_ROWS = 1024          # query rows per attention block


def _heads(cfg: dict) -> tuple[int, int, int]:
    H = cfg["num_attention_heads"]
    D = cfg.get("head_dim") or cfg["hidden_size"] // H
    return H, cfg.get("num_key_value_heads", H), D


def kinds(cfg: dict) -> dict[str, tuple[tuple[int, ...], bool]]:
    """Every kind of tensor of a llama-family checkpoint: name pattern ->
    (shape, is_norm). A pattern with `{}` is one tensor per layer, of that
    shape each."""
    hid, inter, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    H, Hkv, D = _heads(cfg)
    p = "model.layers.{}."
    out = {"model.embed_tokens.weight": ((V, hid), False),
           "model.norm.weight": ((hid,), True),
           p + "input_layernorm.weight": ((hid,), True),
           p + "post_attention_layernorm.weight": ((hid,), True),
           p + "self_attn.o_proj.weight": ((hid, H * D), False),
           p + "mlp.down_proj.weight": ((hid, inter), False)}
    if not cfg.get("tie_word_embeddings", False):
        out["lm_head.weight"] = ((V, hid), False)
    if cfg["model_type"] == "phi3":
        out[p + "self_attn.qkv_proj.weight"] = (((H + 2 * Hkv) * D, hid), False)
        out[p + "mlp.gate_up_proj.weight"] = ((2 * inter, hid), False)
    else:
        out[p + "self_attn.q_proj.weight"] = ((H * D, hid), False)
        out[p + "self_attn.k_proj.weight"] = ((Hkv * D, hid), False)
        out[p + "self_attn.v_proj.weight"] = ((Hkv * D, hid), False)
        out[p + "mlp.gate_proj.weight"] = ((inter, hid), False)
        out[p + "mlp.up_proj.weight"] = ((inter, hid), False)
    return out


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
        return weight(stacks[p + name][i], quant, precision)

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


def logits_at(cfg: dict, seed: int, seqs: list, rows: list, device, *,
              quant: Optional[str], precision: str) -> list:
    """The f32 logits of each sequence at the given rows (the contract of
    `kbench/reference/decoder.py::logits_at`)."""
    H, Hkv, D = _heads(cfg)
    eps = cfg.get("rms_norm_eps", 1e-6)
    window = cfg.get("sliding_window")
    layout = kinds(cfg)
    lens = [len(s) for s in seqs]
    starts = [sum(lens[:j]) for j in range(len(seqs))]
    ids = torch.tensor([t for s in seqs for t in s], dtype=torch.long, device=device)
    x = draw(cfg, seed, "model.embed_tokens.weight", device, layout=layout)[ids].float()
    tables = [rope_tables(cfg, n, device) for n in lens]
    stacks = {p: draw(cfg, seed, p, device, layout=layout) for p in layout if "{}" in p}
    for i in range(cfg["num_hidden_layers"]):
        lw = _layer_weights(stacks, cfg, i, quant, precision)
        h = rms_norm(x, lw["attn_norm"], eps)
        q, k, v = (linear(h, lw[n], precision) for n in ("q", "k", "v"))
        ctx = torch.empty_like(q)
        for j, (s0, n) in enumerate(zip(starts, lens)):
            cos, sin = tables[j]
            qj = _rotate(q[s0:s0 + n].reshape(n, H, D).transpose(0, 1), cos, sin)
            kj = _rotate(k[s0:s0 + n].reshape(n, Hkv, D).transpose(0, 1), cos, sin)
            vj = v[s0:s0 + n].reshape(n, Hkv, D).transpose(0, 1)
            ctx[s0:s0 + n] = _attend(qj, kj, vj, window)
        x = x + linear(ctx, lw["o"], precision)
        h = rms_norm(x, lw["ffn_norm"], eps)
        act = torch.nn.functional.silu(linear(h, lw["gate"], precision)) * \
            linear(h, lw["up"], precision)
        x = x + linear(act, lw["down"], precision)
        del lw, h, q, k, v, ctx, act
    del stacks
    sel = torch.tensor([s0 + r for s0, rr in zip(starts, rows) for r in rr],
                       dtype=torch.long, device=device)
    hn = rms_norm(x[sel], draw(cfg, seed, "model.norm.weight", device, layout=layout), eps)
    head_name = "model.embed_tokens.weight" if cfg.get("tie_word_embeddings", False) \
        else "lm_head.weight"
    head = weight(draw(cfg, seed, head_name, device, layout=layout), quant, precision)
    logits = linear(hn, head, precision)
    out, at = [], 0
    for rr in rows:
        out.append(logits[at:at + len(rr)])
        at += len(rr)
    return out


def matmul_params(cfg: dict) -> tuple[int, int]:
    """(weights of every layer's projections, weights of the head): the
    multiply-adds one token costs outside attention."""
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
