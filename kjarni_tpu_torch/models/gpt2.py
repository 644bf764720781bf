"""GPT-2 / DistilGPT-2 decoder (port of kjarni_tpu/models/gpt2.py).

Pre-norm blocks with learned positions (`wpe`), LayerNorm, a fused c_attn
and the tanh GELU. HF stores Conv1D weights as [in, out], the port's x @ w
layout, so nothing is transposed. Same cache discipline and forward
signature as models/llama.py, so DecoderLM drives both families. No
hand-written kernel runs here: DecoderLM takes flash for the llama family
only, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.errors import GenerationError
from ..ops.activations import gelu_new
from ..ops.attention import NEG_INF, attention, merge_heads
from ..ops.norms import layer_norm
from ..weights.safetensors_loader import ModelWeights
from .llama import _cache_write, _get, _stack, causal_bias


@dataclasses.dataclass(frozen=True)
class Gpt2Config:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    max_seq_len: int
    layer_norm_eps: float = 1e-5
    bos_token_id: Optional[int] = 50256
    eos_token_ids: tuple[int, ...] = (50256,)
    arch: str = "gpt2"

    @property
    def num_kv_heads(self) -> int:
        return self.num_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def from_hf(cfg: dict) -> "Gpt2Config":
        eos = cfg.get("eos_token_id", 50256)
        return Gpt2Config(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["n_embd"],
            num_layers=cfg["n_layer"],
            num_heads=cfg["n_head"],
            max_seq_len=cfg.get("n_positions", 1024),
            layer_norm_eps=cfg.get("layer_norm_epsilon", 1e-5),
            bos_token_id=cfg.get("bos_token_id", 50256),
            eos_token_ids=(int(eos),) if not isinstance(eos, list)
            else tuple(int(e) for e in eos),
        )


def load_params(ws: ModelWeights, cfg: Gpt2Config, dtype=torch.float32,
                device: torch.device | str = "cpu") -> dict:
    """HF GPT-2 checkpoints (with or without the `transformer.` prefix) into
    the stacked param dict; the lm_head is wte, tied."""
    L = cfg.num_layers
    pre = "transformer." if "transformer.wte.weight" in ws else ""

    def one(name):
        return _get(ws, pre + name).to(device=device, dtype=dtype)

    def stack(fmt):
        return _stack(ws, pre + fmt, range(L), dtype, device, transpose=False)

    embed = one("wte.weight")
    layers = {
        "ln1_w": stack("h.{}.ln_1.weight"), "ln1_b": stack("h.{}.ln_1.bias"),
        "ln2_w": stack("h.{}.ln_2.weight"), "ln2_b": stack("h.{}.ln_2.bias"),
        "c_attn_w": stack("h.{}.attn.c_attn.weight"),
        "c_attn_b": stack("h.{}.attn.c_attn.bias"),
        "c_proj_w": stack("h.{}.attn.c_proj.weight"),
        "c_proj_b": stack("h.{}.attn.c_proj.bias"),
        "fc_w": stack("h.{}.mlp.c_fc.weight"), "fc_b": stack("h.{}.mlp.c_fc.bias"),
        "mlp_proj_w": stack("h.{}.mlp.c_proj.weight"),
        "mlp_proj_b": stack("h.{}.mlp.c_proj.bias"),
    }
    return {
        "embed": embed,
        "wpe": one("wpe.weight"),
        "layers": layers,
        "lnf_w": one("ln_f.weight"), "lnf_b": one("ln_f.bias"),
        "lm_head": embed.t(),   # a view: GPT-2 ties the head to wte
    }


def init_cache(cfg: Gpt2Config, batch: int, max_len: int, dtype=torch.float32,
               device: torch.device | str = "cpu"):
    shape = (cfg.num_layers, batch, cfg.num_heads, max_len, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _run_stack(params: dict, cfg: Gpt2Config, ids: torch.Tensor,
               cache_k: torch.Tensor, cache_v: torch.Tensor, pos_start: int,
               use_flash: bool = False, positions: Optional[torch.Tensor] = None,
               pad_mask: Optional[torch.Tensor] = None,
               kv_bucket: Optional[int] = None) -> torch.Tensor:
    """Embed -> layer loop -> final norm, with llama._run_stack's batched
    contract (`positions` [B, S] under left padding, `pad_mask` [B, T]) and
    its per-row decode (pos_start a [B] tensor, S = 1: `wpe` and the cache
    slot at each row's own position).
    `use_flash` and `kv_bucket` are accepted for the shared signature and
    ignored: attention is the plain op over the cache."""
    del use_flash, kv_bucket
    B, S = ids.shape
    T = cache_k.shape[3]
    H, D = cfg.num_heads, cfg.head_dim
    per_row = torch.is_tensor(pos_start)
    if per_row and (S != 1 or pos_start.shape != (B,)):
        raise GenerationError("a per-row decode position takes one token per row")
    pos_start = pos_start if per_row else int(pos_start)
    if per_row:
        pos_emb = params["wpe"][pos_start][:, None]
    elif positions is None:
        pos_emb = params["wpe"][pos_start:pos_start + S][None]
    else:
        pos_emb = params["wpe"][positions]
    x = F.embedding(ids, params["embed"]) + pos_emb
    bias = causal_bias(pos_start, S, T, ids.device)
    if pad_mask is not None:
        bias = bias + torch.where(pad_mask.bool(), 0.0, NEG_INF)[:, None, None, :]

    lp_all = params["layers"]
    for i in range(cfg.num_layers):
        lp = {n: t[i] for n, t in lp_all.items()}
        kc, vc = cache_k[i], cache_v[i]
        hn = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.layer_norm_eps)
        qkv = hn @ lp["c_attn_w"] + lp["c_attn_b"]
        q, k, v = (t.reshape(B, S, H, D).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        _cache_write(kc, k, pos_start)
        _cache_write(vc, v, pos_start)
        ctx = merge_heads(attention(q, kc, vc, bias))
        x = x + ctx @ lp["c_proj_w"] + lp["c_proj_b"]
        hn = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.layer_norm_eps)
        x = x + gelu_new(hn @ lp["fc_w"] + lp["fc_b"]) @ lp["mlp_proj_w"] \
            + lp["mlp_proj_b"]
    return layer_norm(x, params["lnf_w"], params["lnf_b"], cfg.layer_norm_eps)


def forward(params: dict, cfg: Gpt2Config, ids: torch.Tensor,
            cache_k: torch.Tensor, cache_v: torch.Tensor, pos_start: int,
            last_idx: Optional[int] = None, use_flash: bool = False,
            positions: Optional[torch.Tensor] = None,
            pad_mask: Optional[torch.Tensor] = None,
            kv_bucket: Optional[int] = None):
    """One pass (llama.forward's contract): logits [B, V] at `last_idx`."""
    x = _run_stack(params, cfg, ids, cache_k, cache_v, pos_start, use_flash,
                   positions, pad_mask, kv_bucket)
    if last_idx is None:
        last_idx = ids.shape[1] - 1
    return x[:, int(last_idx)] @ params["lm_head"], cache_k, cache_v


def forward_all_logits(params: dict, cfg: Gpt2Config, ids: torch.Tensor,
                       cache_k: torch.Tensor, cache_v: torch.Tensor, pos_start: int):
    """Like forward() but returns logits at every position."""
    x = _run_stack(params, cfg, ids, cache_k, cache_v, pos_start)
    return x @ params["lm_head"], cache_k, cache_v


def forward_hidden(params: dict, cfg: Gpt2Config, ids: torch.Tensor,
                   cache_k: torch.Tensor, cache_v: torch.Tensor, pos_start,
                   use_flash: bool = False, positions: Optional[torch.Tensor] = None,
                   pad_mask: Optional[torch.Tensor] = None,
                   kv_bucket: Optional[int] = None) -> torch.Tensor:
    """The stack without the lm-head (cf. llama.forward_hidden)."""
    return _run_stack(params, cfg, ids, cache_k, cache_v, pos_start, use_flash,
                      positions, pad_mask, kv_bucket)


def head_logits(params: dict, cfg: Gpt2Config, x: torch.Tensor) -> torch.Tensor:
    """lm-head projection of gathered hidden rows."""
    return x @ params["lm_head"]
