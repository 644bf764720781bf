"""BART / DistilBART encoder-decoder (port of kjarni_tpu/models/bart.py).

Learned positions with the +2 offset on both tables, the embedding
LayerNorms, post-norm blocks, `final_logits_bias`, and the padding bias on
encoder self-attention and on cross-attention. Decode runs over a fixed
self-KV cache [L, B, H, T, D], written in place at `pos_start`, and per-layer
cross-K/V precomputed once from the encoder output. Projections are torch
matmuls and attention is the plain `ops/attention.py`, as the JAX package
runs XLA ones: the additive padding bias keeps this path off the flash
kernel, there as here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.activations import get_activation
from ..ops.attention import attention, merge_heads
from ..ops.masks import causal_mask_with_offset, padding_bias
from ..ops.norms import layer_norm
from ..parallel import tensor as tpx
from ..weights.convert import params_from_jax
from ..weights.safetensors_loader import ModelWeights

POSITION_OFFSET = 2  # BartLearnedPositionalEmbedding offset


@dataclasses.dataclass(frozen=True)
class BartConfig:
    vocab_size: int
    d_model: int
    encoder_layers: int
    decoder_layers: int
    encoder_heads: int
    decoder_heads: int
    encoder_ffn_dim: int
    decoder_ffn_dim: int
    max_position_embeddings: int
    activation: str = "gelu"
    layer_norm_eps: float = 1e-5
    scale_embedding: bool = False
    decoder_start_token_id: int = 2
    forced_bos_token_id: int | None = 0
    forced_eos_token_id: int | None = 2
    eos_token_id: int = 2
    bos_token_id: int = 0
    pad_token_id: int = 1
    arch: str = "bart"

    @staticmethod
    def from_hf(cfg: dict) -> "BartConfig":
        return BartConfig(
            vocab_size=cfg["vocab_size"],
            d_model=cfg["d_model"],
            encoder_layers=cfg["encoder_layers"],
            decoder_layers=cfg["decoder_layers"],
            encoder_heads=cfg["encoder_attention_heads"],
            decoder_heads=cfg["decoder_attention_heads"],
            encoder_ffn_dim=cfg["encoder_ffn_dim"],
            decoder_ffn_dim=cfg["decoder_ffn_dim"],
            max_position_embeddings=cfg["max_position_embeddings"],
            activation=cfg.get("activation_function", "gelu"),
            scale_embedding=cfg.get("scale_embedding", False),
            decoder_start_token_id=cfg.get("decoder_start_token_id", 2),
            forced_bos_token_id=cfg.get("forced_bos_token_id"),
            forced_eos_token_id=cfg.get("forced_eos_token_id"),
            eos_token_id=cfg.get("eos_token_id", 2),
            bos_token_id=cfg.get("bos_token_id", 0),
            pad_token_id=cfg.get("pad_token_id", 1),
        )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_heads


# ---------------------------------------------------------------------------
# Weights: HF names -> stacked numpy f32 (the JAX package's layout) -> torch
# ---------------------------------------------------------------------------

def lin(ws: ModelWeights, name: str) -> dict:
    """One HF linear as {"w": [in, out], "b": [out]} (b only when stored)."""
    p = {"w": ws.get_f32(f"{name}.weight").T}
    if f"{name}.bias" in ws:
        p["b"] = ws.get_f32(f"{name}.bias")
    return p


def stack_lin(ws: ModelWeights, fmt: str, L: int) -> dict:
    ps = [lin(ws, fmt.format(i)) for i in range(L)]
    return {key: np.stack([p[key] for p in ps]) for key in ps[0]}


def stack_norm(ws: ModelWeights, fmt: str, L: int) -> dict:
    return {part: np.stack([ws.get_f32(fmt.format(i) + f".{part}") for i in range(L)])
            for part in ("weight", "bias")}


def norm(ws: ModelWeights, name: str) -> dict:
    return {"weight": ws.get_f32(f"{name}.weight"), "bias": ws.get_f32(f"{name}.bias")}


def layer(tree: dict, i: int) -> dict:
    """Layer i of a dict of [L, ...] stacks."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _load_f32(ws: ModelWeights, cfg: BartConfig) -> dict:
    pre = "model." if "model.shared.weight" in ws else ""
    e = pre + "encoder.layers.{}."
    d = pre + "decoder.layers.{}."
    Le, Ld = cfg.encoder_layers, cfg.decoder_layers
    shared = ws.get_f32(pre + "shared.weight")
    enc = {
        "q": stack_lin(ws, e + "self_attn.q_proj", Le),
        "k": stack_lin(ws, e + "self_attn.k_proj", Le),
        "v": stack_lin(ws, e + "self_attn.v_proj", Le),
        "o": stack_lin(ws, e + "self_attn.out_proj", Le),
        "attn_norm": stack_norm(ws, e + "self_attn_layer_norm", Le),
        "fc1": stack_lin(ws, e + "fc1", Le),
        "fc2": stack_lin(ws, e + "fc2", Le),
        "ffn_norm": stack_norm(ws, e + "final_layer_norm", Le),
    }
    dec = {
        "q": stack_lin(ws, d + "self_attn.q_proj", Ld),
        "k": stack_lin(ws, d + "self_attn.k_proj", Ld),
        "v": stack_lin(ws, d + "self_attn.v_proj", Ld),
        "o": stack_lin(ws, d + "self_attn.out_proj", Ld),
        "self_norm": stack_norm(ws, d + "self_attn_layer_norm", Ld),
        "cross_q": stack_lin(ws, d + "encoder_attn.q_proj", Ld),
        "cross_k": stack_lin(ws, d + "encoder_attn.k_proj", Ld),
        "cross_v": stack_lin(ws, d + "encoder_attn.v_proj", Ld),
        "cross_o": stack_lin(ws, d + "encoder_attn.out_proj", Ld),
        "cross_norm": stack_norm(ws, d + "encoder_attn_layer_norm", Ld),
        "fc1": stack_lin(ws, d + "fc1", Ld),
        "fc2": stack_lin(ws, d + "fc2", Ld),
        "ffn_norm": stack_norm(ws, d + "final_layer_norm", Ld),
    }
    final_bias = (ws.get_f32("final_logits_bias").reshape(-1)
                  if "final_logits_bias" in ws else np.zeros(cfg.vocab_size, np.float32))
    return {
        "shared": shared,
        "enc_pos": ws.get_f32(pre + "encoder.embed_positions.weight"),
        "dec_pos": ws.get_f32(pre + "decoder.embed_positions.weight"),
        "enc_emb_norm": norm(ws, pre + "encoder.layernorm_embedding"),
        "dec_emb_norm": norm(ws, pre + "decoder.layernorm_embedding"),
        "enc": enc,
        "dec": dec,
        "lm_head": shared.T,
        "final_logits_bias": final_bias,
    }


def load_params(ws: ModelWeights, cfg: BartConfig, dtype=torch.float32,
                device: torch.device | str = "cpu") -> dict:
    """HF checkpoint -> the JAX package's param layout, as `dtype` tensors on
    `device` ([in, out] for x @ w, layers stacked on a leading axis)."""
    return params_from_jax(_load_f32(ws, cfg), device, dtype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def heads(x: torch.Tensor, B: int, S: int, H: int, D: int) -> torch.Tensor:
    return x.reshape(B, S, H, D).transpose(1, 2)


def apply(x: torch.Tensor, p: dict) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def row(x: torch.Tensor, p: dict, tp, full_k: int) -> torch.Tensor:
    """A row-parallel linear (o, cross_o, fc2) over a {"w", "b"} dict."""
    return tpx.row(x, p["w"], p.get("b"), tp, full_k)


def encode(params: dict, cfg: BartConfig, ids: torch.Tensor,
           mask: torch.Tensor, tp=None) -> torch.Tensor:
    """Encoder forward: [B, S] -> [B, S, d_model]. `tp`: the tensor-parallel
    group's Comm when params are this rank's shard under
    `bart_param_sharding` (parallel/tensor.py)."""
    B, S = ids.shape
    D = cfg.head_dim
    H = tpx.local_heads(params["enc"]["q"]["w"].shape[-1], D)
    scale = (cfg.d_model ** 0.5) if cfg.scale_embedding else 1.0
    x = params["shared"][ids] * scale
    x = x + params["enc_pos"][POSITION_OFFSET:POSITION_OFFSET + S][None]
    x = layer_norm(x, params["enc_emb_norm"]["weight"],
                   params["enc_emb_norm"]["bias"], cfg.layer_norm_eps)
    bias = padding_bias(mask)
    act = get_activation(cfg.activation)
    for i in range(cfg.encoder_layers):
        lp = layer(params["enc"], i)
        q = heads(apply(x, lp["q"]), B, S, H, D)
        k = heads(apply(x, lp["k"]), B, S, H, D)
        v = heads(apply(x, lp["v"]), B, S, H, D)
        ctx = merge_heads(attention(q, k, v, bias))
        x = layer_norm(x + row(ctx, lp["o"], tp, cfg.encoder_heads * D),
                       lp["attn_norm"]["weight"], lp["attn_norm"]["bias"],
                       cfg.layer_norm_eps)
        ffn = row(act(apply(x, lp["fc1"])), lp["fc2"], tp, cfg.encoder_ffn_dim)
        x = layer_norm(x + ffn, lp["ffn_norm"]["weight"], lp["ffn_norm"]["bias"],
                       cfg.layer_norm_eps)
    return x


def precompute_cross_kv(params: dict, cfg: BartConfig, enc_hidden: torch.Tensor,
                        tp=None):
    """Per-layer cross-attention K/V from the encoder output: [L, B, H, S, D]
    (this rank's heads under tp; no collective)."""
    B, S, _ = enc_hidden.shape
    D = cfg.head_dim
    H = tpx.local_heads(params["dec"]["cross_k"]["w"].shape[-1], D)
    dec = params["dec"]
    ks = [heads(apply(enc_hidden, layer(dec["cross_k"], i)), B, S, H, D)
          for i in range(cfg.decoder_layers)]
    vs = [heads(apply(enc_hidden, layer(dec["cross_v"], i)), B, S, H, D)
          for i in range(cfg.decoder_layers)]
    return torch.stack(ks), torch.stack(vs)


def init_self_cache(cfg: BartConfig, batch: int, max_len: int, dtype=torch.float32,
                    device: torch.device | str = "cpu"):
    shape = (cfg.decoder_layers, batch, cfg.decoder_heads, max_len, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def decode_step(params: dict, cfg: BartConfig, ids: torch.Tensor,
                self_k: torch.Tensor, self_v: torch.Tensor,
                cross_k: torch.Tensor, cross_v: torch.Tensor,
                enc_mask: torch.Tensor, pos_start: int, tp=None):
    """Decoder forward for S tokens at pos_start+arange(S) -> (logits
    [B, S, V], self_k, self_v). The new K/V are written into the caches in
    place (the JAX package returns updated copies). Under tp the caches hold
    this rank's heads and the logits are gathered."""
    B, S = ids.shape
    T = self_k.shape[3]
    D = cfg.head_dim
    H = tpx.local_heads(params["dec"]["q"]["w"].shape[-1], D)
    inner = cfg.decoder_heads * D
    scale = (cfg.d_model ** 0.5) if cfg.scale_embedding else 1.0
    positions = pos_start + torch.arange(S, device=ids.device)
    x = params["shared"][ids] * scale
    x = x + params["dec_pos"][positions + POSITION_OFFSET][None]
    x = layer_norm(x, params["dec_emb_norm"]["weight"],
                   params["dec_emb_norm"]["bias"], cfg.layer_norm_eps)
    self_bias = causal_mask_with_offset(S, T, pos_start, device=ids.device)[None, None]
    cross_bias = padding_bias(enc_mask)
    act = get_activation(cfg.activation)
    for i in range(cfg.decoder_layers):
        lp = layer(params["dec"], i)
        q = heads(apply(x, lp["q"]), B, S, H, D)
        self_k[i, :, :, pos_start:pos_start + S] = heads(apply(x, lp["k"]), B, S, H, D)
        self_v[i, :, :, pos_start:pos_start + S] = heads(apply(x, lp["v"]), B, S, H, D)
        ctx = merge_heads(attention(q, self_k[i], self_v[i], self_bias))
        x = layer_norm(x + row(ctx, lp["o"], tp, inner), lp["self_norm"]["weight"],
                       lp["self_norm"]["bias"], cfg.layer_norm_eps)
        cq = heads(apply(x, lp["cross_q"]), B, S, H, D)
        cctx = merge_heads(attention(cq, cross_k[i], cross_v[i], cross_bias))
        x = layer_norm(x + row(cctx, lp["cross_o"], tp, inner), lp["cross_norm"]["weight"],
                       lp["cross_norm"]["bias"], cfg.layer_norm_eps)
        ffn = row(act(apply(x, lp["fc1"])), lp["fc2"], tp, cfg.decoder_ffn_dim)
        x = layer_norm(x + ffn, lp["ffn_norm"]["weight"], lp["ffn_norm"]["bias"],
                       cfg.layer_norm_eps)
    logits = x @ params["lm_head"] + params["final_logits_bias"]
    return tpx.gather_cols(logits, tp, cfg.vocab_size), self_k, self_v
