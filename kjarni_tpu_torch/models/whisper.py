"""Whisper encoder-decoder for speech-to-text (port of
kjarni_tpu/models/whisper.py; cf. kjarni-models/src/models/whisper/model.rs).

Pre-norm transformer on both sides; the conv frontend (conv1 s=1 + conv2
s=2, both GELU, padding 1) runs as two `F.conv1d`. k_proj has no bias.
`encode(use_flash=True)` sends the encoder's non-causal self-attention
through the hand-written flash kernel (ops/kernels/flash_attention.py), as
the JAX package sends it through its Pallas kernel; the kernel takes bf16,
so with f32 tensors on the card it raises, and nothing falls back. The
decoder's attention and the cross-attention are the plain
`ops/attention.py`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops.activations import gelu
from ..ops.attention import attention, merge_heads
from ..ops.kernels.flash_attention import flash_attention
from ..ops.masks import causal_mask_with_offset
from ..ops.norms import layer_norm
from ..weights.convert import params_from_jax
from ..weights.safetensors_loader import ModelWeights
from ..parallel import tensor as tpx
from .bart import apply, heads, layer, norm, row, stack_lin, stack_norm


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int
    d_model: int
    encoder_layers: int
    decoder_layers: int
    encoder_heads: int
    decoder_heads: int
    encoder_ffn_dim: int
    decoder_ffn_dim: int
    num_mel_bins: int
    max_source_positions: int   # 1500
    max_target_positions: int   # 448
    eos_token_id: int = 50257
    decoder_start_token_id: int = 50258
    pad_token_id: int = 50257
    arch: str = "whisper"

    @staticmethod
    def from_hf(cfg: dict) -> "WhisperConfig":
        return WhisperConfig(
            vocab_size=cfg["vocab_size"],
            d_model=cfg["d_model"],
            encoder_layers=cfg["encoder_layers"],
            decoder_layers=cfg["decoder_layers"],
            encoder_heads=cfg["encoder_attention_heads"],
            decoder_heads=cfg["decoder_attention_heads"],
            encoder_ffn_dim=cfg["encoder_ffn_dim"],
            decoder_ffn_dim=cfg["decoder_ffn_dim"],
            num_mel_bins=cfg["num_mel_bins"],
            max_source_positions=cfg["max_source_positions"],
            max_target_positions=cfg["max_target_positions"],
            eos_token_id=cfg.get("eos_token_id", 50257),
            decoder_start_token_id=cfg.get("decoder_start_token_id", 50258),
            pad_token_id=cfg.get("pad_token_id", 50257),
        )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_heads


def _load_f32(ws: ModelWeights, cfg: WhisperConfig) -> dict:
    pre = "model." if "model.encoder.conv1.weight" in ws else ""
    e = pre + "encoder.layers.{}."
    d = pre + "decoder.layers.{}."
    Le, Ld = cfg.encoder_layers, cfg.decoder_layers

    def g(name):
        return ws.get_f32(pre + name)

    enc = {
        "q": stack_lin(ws, e + "self_attn.q_proj", Le),
        "k": stack_lin(ws, e + "self_attn.k_proj", Le),  # no bias
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
    embed = g("decoder.embed_tokens.weight")
    return {
        "conv1_w": g("encoder.conv1.weight"),  # [out, in, k]
        "conv1_b": g("encoder.conv1.bias"),
        "conv2_w": g("encoder.conv2.weight"),
        "conv2_b": g("encoder.conv2.bias"),
        "enc_pos": g("encoder.embed_positions.weight"),  # sinusoidal, stored
        "enc": enc,
        "enc_final_norm": norm(ws, pre + "encoder.layer_norm"),
        "embed": embed,
        "dec_pos": g("decoder.embed_positions.weight"),
        "dec": dec,
        "dec_final_norm": norm(ws, pre + "decoder.layer_norm"),
        "lm_head": embed.T,
    }


def load_params(ws: ModelWeights, cfg: WhisperConfig, dtype=torch.float32,
                device: torch.device | str = "cpu") -> dict:
    """HF checkpoint -> the JAX package's param layout, as `dtype` tensors on
    `device` (conv weights [C_out, C_in, K] as stored)."""
    return params_from_jax(_load_f32(ws, cfg), device, dtype)


def encode(params: dict, cfg: WhisperConfig, mel: torch.Tensor,
           use_flash: bool = False, tp=None) -> torch.Tensor:
    """mel [B, n_mels, 3000] -> hidden [B, 1500, d_model].

    Conv frontend then the pre-norm encoder stack. `use_flash` sends
    self-attention through the flash kernel (non-causal): 12 launches per
    call at whisper-small's depth. `tp`: the tensor-parallel group's Comm
    when params are this rank's shard under `whisper_param_sharding`
    (parallel/tensor.py); flash then runs at this rank's heads.
    """
    B = mel.shape[0]
    D = cfg.head_dim
    H = tpx.local_heads(params["enc"]["q"]["w"].shape[-1], D)
    x = gelu(F.conv1d(mel, params["conv1_w"], params["conv1_b"], stride=1, padding=1))
    x = gelu(F.conv1d(x, params["conv2_w"], params["conv2_b"], stride=2, padding=1))
    x = x.transpose(1, 2)  # [B, T, d_model]
    S = x.shape[1]
    x = x + params["enc_pos"][:S][None]
    for i in range(cfg.encoder_layers):
        lp = layer(params["enc"], i)
        hn = layer_norm(x, lp["attn_norm"]["weight"], lp["attn_norm"]["bias"])
        q = heads(apply(hn, lp["q"]), B, S, H, D)
        k = heads(apply(hn, lp["k"]), B, S, H, D)
        v = heads(apply(hn, lp["v"]), B, S, H, D)
        if use_flash:
            ctx = merge_heads(flash_attention(q, k, v, causal=False))
        else:
            ctx = merge_heads(attention(q, k, v))
        x = x + row(ctx, lp["o"], tp, cfg.encoder_heads * D)
        hn = layer_norm(x, lp["ffn_norm"]["weight"], lp["ffn_norm"]["bias"])
        x = x + row(gelu(apply(hn, lp["fc1"])), lp["fc2"], tp, cfg.encoder_ffn_dim)
    return layer_norm(x, params["enc_final_norm"]["weight"],
                      params["enc_final_norm"]["bias"])


def precompute_cross_kv(params: dict, cfg: WhisperConfig, enc_hidden: torch.Tensor,
                        tp=None):
    """Cross-attention K/V once per chunk: [L, B, H, 1500, D] (this rank's
    heads under tp; no collective)."""
    B, S, _ = enc_hidden.shape
    D = cfg.head_dim
    H = tpx.local_heads(params["dec"]["cross_k"]["w"].shape[-1], D)
    dec = params["dec"]
    L = cfg.decoder_layers
    return (torch.stack([heads(apply(enc_hidden, layer(dec["cross_k"], i)), B, S, H, D)
                         for i in range(L)]),
            torch.stack([heads(apply(enc_hidden, layer(dec["cross_v"], i)), B, S, H, D)
                         for i in range(L)]))


def init_self_cache(cfg: WhisperConfig, batch: int, max_len: int,
                    dtype=torch.float32, device: torch.device | str = "cpu"):
    shape = (cfg.decoder_layers, batch, cfg.decoder_heads, max_len, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def decode_step(params: dict, cfg: WhisperConfig, ids: torch.Tensor,
                self_k: torch.Tensor, self_v: torch.Tensor,
                cross_k: torch.Tensor, cross_v: torch.Tensor,
                enc_mask: torch.Tensor | None, pos_start: int, tp=None):
    """Pre-norm decoder for S tokens at pos_start+arange(S) -> (logits
    [B, S, V], self_k, self_v); the caches are written in place. enc_mask is
    taken for the common signature and not read: every one of the 1,500
    encoder positions is real. Under tp the caches hold this rank's heads
    and the logits are gathered."""
    B, S = ids.shape
    T = self_k.shape[3]
    D = cfg.head_dim
    H = tpx.local_heads(params["dec"]["q"]["w"].shape[-1], D)
    inner = cfg.decoder_heads * D
    positions = pos_start + torch.arange(S, device=ids.device)
    x = params["embed"][ids] + params["dec_pos"][positions][None]
    self_bias = causal_mask_with_offset(S, T, pos_start, device=ids.device)[None, None]
    for i in range(cfg.decoder_layers):
        lp = layer(params["dec"], i)
        hn = layer_norm(x, lp["self_norm"]["weight"], lp["self_norm"]["bias"])
        q = heads(apply(hn, lp["q"]), B, S, H, D)
        self_k[i, :, :, pos_start:pos_start + S] = heads(apply(hn, lp["k"]), B, S, H, D)
        self_v[i, :, :, pos_start:pos_start + S] = heads(apply(hn, lp["v"]), B, S, H, D)
        ctx = merge_heads(attention(q, self_k[i], self_v[i], self_bias))
        x = x + row(ctx, lp["o"], tp, inner)
        hn = layer_norm(x, lp["cross_norm"]["weight"], lp["cross_norm"]["bias"])
        cq = heads(apply(hn, lp["cross_q"]), B, S, H, D)
        x = x + row(merge_heads(attention(cq, cross_k[i], cross_v[i])), lp["cross_o"], tp,
                    inner)
        hn = layer_norm(x, lp["ffn_norm"]["weight"], lp["ffn_norm"]["bias"])
        x = x + row(gelu(apply(hn, lp["fc1"])), lp["fc2"], tp, cfg.decoder_ffn_dim)
    x = layer_norm(x, params["dec_final_norm"]["weight"],
                   params["dec_final_norm"]["bias"])
    return tpx.gather_cols(x @ params["lm_head"], tp, cfg.vocab_size), self_k, self_v
