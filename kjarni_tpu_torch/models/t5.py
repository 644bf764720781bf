"""T5 / FLAN-T5 encoder-decoder (port of kjarni_tpu/models/t5.py).

RMS norms without bias (statistics in f32), no attention scaling (scale=1),
the relative-position bucket bias of layer 0 of each stack (bidirectional in
the encoder, causal in the decoder), relu or gated-gelu FFN, and the tied
head's d_model ** -0.5 rescale. Decode runs over a fixed self-KV cache
written in place at `pos_start` and per-layer cross-K/V precomputed once.
Attention is the plain `ops/attention.py`: the relative-position bias keeps
this path off the flash kernel, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..ops.activations import get_activation
from ..ops.attention import attention, merge_heads
from ..ops.masks import causal_mask_with_offset, padding_bias
from ..ops.norms import rms_norm
from ..parallel import tensor as tpx
from ..weights.convert import params_from_jax
from ..weights.safetensors_loader import ModelWeights
from .bart import heads, layer


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int
    d_model: int
    d_kv: int
    d_ff: int
    num_layers: int
    num_decoder_layers: int
    num_heads: int
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    gated_act: bool = False
    activation: str = "relu"
    tie_word_embeddings: bool = True
    decoder_start_token_id: int = 0
    eos_token_id: int = 1
    pad_token_id: int = 0
    arch: str = "t5"

    @staticmethod
    def from_hf(cfg: dict) -> "T5Config":
        ff_proj = cfg.get("feed_forward_proj", "relu")
        gated = ff_proj.startswith("gated-")
        act = ff_proj.replace("gated-", "")
        if act == "gelu":
            act = "gelu_new"  # HF T5 "gelu" means gelu_new in the FF block
        return T5Config(
            vocab_size=cfg["vocab_size"],
            d_model=cfg["d_model"],
            d_kv=cfg["d_kv"],
            d_ff=cfg["d_ff"],
            num_layers=cfg["num_layers"],
            num_decoder_layers=cfg.get("num_decoder_layers", cfg["num_layers"]),
            num_heads=cfg["num_heads"],
            relative_attention_num_buckets=cfg.get("relative_attention_num_buckets", 32),
            relative_attention_max_distance=cfg.get("relative_attention_max_distance", 128),
            layer_norm_eps=cfg.get("layer_norm_epsilon", 1e-6),
            gated_act=gated,
            activation=act,
            tie_word_embeddings=cfg.get("tie_word_embeddings", True),
            decoder_start_token_id=cfg.get("decoder_start_token_id", 0),
            eos_token_id=cfg.get("eos_token_id", 1),
            pad_token_id=cfg.get("pad_token_id", 0),
        )


def _load_f32(ws: ModelWeights, cfg: T5Config) -> dict:
    """HF T5 names -> stacked numpy f32 (encoder + decoder)."""
    def stack(fmt, L, transpose=True):
        return np.stack([ws.get_f32(fmt.format(i)).T if transpose
                         else ws.get_f32(fmt.format(i)) for i in range(L)])

    Le, Ld = cfg.num_layers, cfg.num_decoder_layers
    e = "encoder.block.{}.layer."
    d = "decoder.block.{}.layer."
    enc = {
        "q": stack(e + "0.SelfAttention.q.weight", Le),
        "k": stack(e + "0.SelfAttention.k.weight", Le),
        "v": stack(e + "0.SelfAttention.v.weight", Le),
        "o": stack(e + "0.SelfAttention.o.weight", Le),
        "attn_norm": stack(e + "0.layer_norm.weight", Le, False),
        "ffn_norm": stack(e + "1.layer_norm.weight", Le, False),
        "wo": stack(e + "1.DenseReluDense.wo.weight", Le),
    }
    dec = {
        "q": stack(d + "0.SelfAttention.q.weight", Ld),
        "k": stack(d + "0.SelfAttention.k.weight", Ld),
        "v": stack(d + "0.SelfAttention.v.weight", Ld),
        "o": stack(d + "0.SelfAttention.o.weight", Ld),
        "self_norm": stack(d + "0.layer_norm.weight", Ld, False),
        "cross_q": stack(d + "1.EncDecAttention.q.weight", Ld),
        "cross_k": stack(d + "1.EncDecAttention.k.weight", Ld),
        "cross_v": stack(d + "1.EncDecAttention.v.weight", Ld),
        "cross_o": stack(d + "1.EncDecAttention.o.weight", Ld),
        "cross_norm": stack(d + "1.layer_norm.weight", Ld, False),
        "ffn_norm": stack(d + "2.layer_norm.weight", Ld, False),
        "wo": stack(d + "2.DenseReluDense.wo.weight", Ld),
    }
    for tree, fmt, L in ((enc, e + "1.DenseReluDense.", Le), (dec, d + "2.DenseReluDense.", Ld)):
        if cfg.gated_act:
            tree["wi0"] = stack(fmt + "wi_0.weight", L)
            tree["wi1"] = stack(fmt + "wi_1.weight", L)
        else:
            tree["wi"] = stack(fmt + "wi.weight", L)
    shared = ws.get_f32("shared.weight")
    if cfg.tie_word_embeddings or "lm_head.weight" not in ws:
        lm_head = shared.T
    else:
        lm_head = ws.get_f32("lm_head.weight").T
    return {
        "shared": shared,
        "enc": enc,
        "dec": dec,
        "enc_rel_bias": ws.get_f32(
            "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
        "dec_rel_bias": ws.get_f32(
            "decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
        "enc_final_norm": ws.get_f32("encoder.final_layer_norm.weight"),
        "dec_final_norm": ws.get_f32("decoder.final_layer_norm.weight"),
        "lm_head": lm_head,
    }


def load_params(ws: ModelWeights, cfg: T5Config, dtype=torch.float32,
                device: torch.device | str = "cpu") -> dict:
    """HF checkpoint -> the JAX package's param layout, as `dtype` tensors on
    `device` (the bias tables [num_buckets, H] too)."""
    return params_from_jax(_load_f32(ws, cfg), device, dtype)


# ---------------------------------------------------------------------------
# Relative position bias
# ---------------------------------------------------------------------------

def _bucket(relative_position: torch.Tensor, bidirectional: bool,
            num_buckets: int, max_distance: int) -> torch.Tensor:
    ret = torch.zeros_like(relative_position)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (relative_position > 0).to(ret.dtype) * num_buckets
        n = relative_position.abs()
    else:
        n = -torch.clamp(relative_position, max=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    # the divisor rounded to f32 first, as the JAX package's f32 arithmetic does
    div = float(np.float32(math.log(max_distance / max_exact)))
    val_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-9) / div * (num_buckets - max_exact)
    ).to(ret.dtype)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


@functools.lru_cache(maxsize=8)
def _bucket_row(n: int, bidirectional: bool, num_buckets: int, max_distance: int,
                device: torch.device) -> torch.Tensor:
    """The bucket of every key - query distance in [1 - n, n - 1], at index
    distance + n - 1, on `device`.

    They are computed on the host and moved once: at the distances where the
    f32 log lands on a whole bucket (16, 32 and 64 in a 32-bucket encoder),
    a log one ulp apart truncates to the next bucket down, and the card's
    log need not round as the CPU's does. So the card takes the CPU's
    buckets, without a copy per decode step.
    """
    return _bucket(torch.arange(1 - n, n), bidirectional, num_buckets,
                   max_distance).to(device)


def position_bias(table: torch.Tensor, q_start: int, q_len: int, k_len: int,
                  bidirectional: bool, num_buckets: int, max_distance: int) -> torch.Tensor:
    """[1, H, q_len, k_len] additive bias from the [num_buckets, H] table for
    queries at q_start + arange(q_len) and keys at arange(k_len)."""
    # a row of the next power of two serves every shorter length
    n = max(64, 1 << (max(q_start + q_len, k_len) - 1).bit_length())
    row = _bucket_row(n, bidirectional, num_buckets, max_distance, table.device)
    dev = table.device
    rel = torch.arange(k_len, device=dev)[None, :] - \
        torch.arange(q_start, q_start + q_len, device=dev)[:, None]   # memory - query
    bias = table[row[rel + (n - 1)]]  # [Sq, Sk, H]
    return bias.permute(2, 0, 1)[None]


def _ffn(h: torch.Tensor, lp: dict, cfg: T5Config, tp=None) -> torch.Tensor:
    act = get_activation(cfg.activation)
    if cfg.gated_act:
        return tpx.row(act(h @ lp["wi0"]) * (h @ lp["wi1"]), lp["wo"], None, tp, cfg.d_ff)
    return tpx.row(act(h @ lp["wi"]), lp["wo"], None, tp, cfg.d_ff)


def encode(params: dict, cfg: T5Config, ids: torch.Tensor,
           mask: torch.Tensor, tp=None) -> torch.Tensor:
    """Encoder forward: [B, S] -> [B, S, d_model]. `tp`: the tensor-parallel
    group's Comm when params are this rank's shard under
    `t5_param_sharding` (parallel/tensor.py)."""
    B, S = ids.shape
    D, inner = cfg.d_kv, cfg.num_heads * cfg.d_kv
    H = tpx.local_heads(params["enc"]["q"].shape[-1], D)
    x = params["shared"][ids]
    bias = position_bias(params["enc_rel_bias"], 0, S, S, True,
                         cfg.relative_attention_num_buckets,
                         cfg.relative_attention_max_distance)
    bias = tpx.own_heads(bias, H, tp) + padding_bias(mask)
    for i in range(cfg.num_layers):
        lp = layer(params["enc"], i)
        hn = rms_norm(x, lp["attn_norm"], cfg.layer_norm_eps)
        q = heads(hn @ lp["q"], B, S, H, D)
        k = heads(hn @ lp["k"], B, S, H, D)
        v = heads(hn @ lp["v"], B, S, H, D)
        ctx = merge_heads(attention(q, k, v, bias, scale=1.0))
        x = x + tpx.row(ctx, lp["o"], None, tp, inner)
        hn = rms_norm(x, lp["ffn_norm"], cfg.layer_norm_eps)
        x = x + _ffn(hn, lp, cfg, tp)
    return rms_norm(x, params["enc_final_norm"], cfg.layer_norm_eps)


def precompute_cross_kv(params: dict, cfg: T5Config, enc_hidden: torch.Tensor,
                        tp=None):
    """Per-layer cross-attention K/V from the encoder output: [L, B, H, S_enc, D]
    (this rank's heads under tp; no collective)."""
    B, S, _ = enc_hidden.shape
    D = cfg.d_kv
    H = tpx.local_heads(params["dec"]["cross_k"].shape[-1], D)
    dec = params["dec"]
    L = cfg.num_decoder_layers
    return (torch.stack([heads(enc_hidden @ dec["cross_k"][i], B, S, H, D) for i in range(L)]),
            torch.stack([heads(enc_hidden @ dec["cross_v"][i], B, S, H, D) for i in range(L)]))


def init_self_cache(cfg: T5Config, batch: int, max_len: int, dtype=torch.float32,
                    device: torch.device | str = "cpu"):
    shape = (cfg.num_decoder_layers, batch, cfg.num_heads, max_len, cfg.d_kv)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def decode_step(params: dict, cfg: T5Config, ids: torch.Tensor,
                self_k: torch.Tensor, self_v: torch.Tensor,
                cross_k: torch.Tensor, cross_v: torch.Tensor,
                enc_mask: torch.Tensor, pos_start: int, tp=None):
    """Decoder forward for S new tokens at positions pos_start+arange(S) ->
    (logits [B, S, V], self_k, self_v); the caches are written in place.
    Under tp the caches hold this rank's heads and the logits are gathered."""
    B, S = ids.shape
    T = self_k.shape[3]
    D, inner = cfg.d_kv, cfg.num_heads * cfg.d_kv
    H = tpx.local_heads(params["dec"]["q"].shape[-1], D)
    x = params["shared"][ids]
    bias = position_bias(params["dec_rel_bias"], pos_start, S, T, False,
                         cfg.relative_attention_num_buckets,
                         cfg.relative_attention_max_distance)
    self_bias = tpx.own_heads(bias, H, tp) + causal_mask_with_offset(S, T, pos_start, device=ids.device)[None, None]
    cross_bias = padding_bias(enc_mask)
    for i in range(cfg.num_decoder_layers):
        lp = layer(params["dec"], i)
        hn = rms_norm(x, lp["self_norm"], cfg.layer_norm_eps)
        q = heads(hn @ lp["q"], B, S, H, D)
        self_k[i, :, :, pos_start:pos_start + S] = heads(hn @ lp["k"], B, S, H, D)
        self_v[i, :, :, pos_start:pos_start + S] = heads(hn @ lp["v"], B, S, H, D)
        ctx = merge_heads(attention(q, self_k[i], self_v[i], self_bias, scale=1.0))
        x = x + tpx.row(ctx, lp["o"], None, tp, inner)
        # cross attention over the precomputed encoder K/V
        hn = rms_norm(x, lp["cross_norm"], cfg.layer_norm_eps)
        cq = heads(hn @ lp["cross_q"], B, S, H, D)
        cctx = merge_heads(attention(cq, cross_k[i], cross_v[i], cross_bias, scale=1.0))
        x = x + tpx.row(cctx, lp["cross_o"], None, tp, inner)
        hn = rms_norm(x, lp["ffn_norm"], cfg.layer_norm_eps)
        x = x + _ffn(hn, lp, cfg, tp)
    x = rms_norm(x, params["dec_final_norm"], cfg.layer_norm_eps)
    if cfg.tie_word_embeddings:
        x = x * (cfg.d_model ** -0.5)
    return tpx.gather_cols(x @ params["lm_head"], tp, cfg.vocab_size), self_k, self_v
