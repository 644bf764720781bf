"""BERT-family encoder: BERT / DistilBERT / RoBERTa / XLM-R / MPNet / NomicBERT
(port of kjarni_tpu/models/bert.py).

One frozen `BertConfig`, a param dict whose layer weights are stacked along a
leading layer axis ([L, in, out] for x @ w), and a pure `encode()` that runs
the stack as a Python loop over the layer index. Projections are torch
matmuls and attention is the plain `ops/attention.py::attention`, as in the
JAX package: no hand-written kernel sits on this path (the flash kernel
computes causal attention without an additive mask, which a padded
bidirectional encoder needs).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.errors import InvalidConfigError
from ..ops.activations import get_activation
from ..ops.attention import attention, merge_heads, split_heads
from ..ops.masks import padding_bias
from ..ops.norms import layer_norm
from ..ops.rope import apply_rope, rope_tables
from ..parallel import tensor as tpx
from ..weights.convert import params_from_jax
from ..weights.safetensors_loader import ModelWeights


@dataclasses.dataclass(frozen=True)
class BertConfig:
    flavor: str  # "bert" | "distilbert" | "roberta" | "mpnet" | "nomic"
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int
    max_position_embeddings: int
    type_vocab_size: int = 0
    pad_token_id: int = 0
    layer_norm_eps: float = 1e-12
    activation: str = "gelu"
    # roberta/mpnet: positions start at pad_token_id + 1 and skip padding
    position_offset: int = 0
    # mpnet relative attention bias
    relative_attention_num_buckets: int = 0
    relative_attention_max_distance: int = 128
    # nomic-bert: rotary embeddings + swiglu ffn, fused Wqkv without bias
    rotary_emb_base: float = 0.0   # >0 enables rotary (no position embeddings)
    swiglu: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def from_hf(cfg: dict) -> "BertConfig":
        """Parse an HF config.json for any supported encoder flavor."""
        mt = cfg.get("model_type", "bert")
        if mt == "distilbert":
            return BertConfig(
                flavor="distilbert",
                vocab_size=cfg["vocab_size"],
                hidden_size=cfg["dim"],
                num_layers=cfg["n_layers"],
                num_heads=cfg["n_heads"],
                intermediate_size=cfg["hidden_dim"],
                max_position_embeddings=cfg["max_position_embeddings"],
                type_vocab_size=0,
                pad_token_id=cfg.get("pad_token_id", 0),
                layer_norm_eps=1e-12,
                activation=cfg.get("activation", "gelu"),
            )
        if mt in ("roberta", "xlm-roberta", "camembert"):
            pad = cfg.get("pad_token_id", 1)
            return BertConfig(
                flavor="roberta",
                vocab_size=cfg["vocab_size"],
                hidden_size=cfg["hidden_size"],
                num_layers=cfg["num_hidden_layers"],
                num_heads=cfg["num_attention_heads"],
                intermediate_size=cfg["intermediate_size"],
                max_position_embeddings=cfg["max_position_embeddings"],
                type_vocab_size=cfg.get("type_vocab_size", 0),
                pad_token_id=pad,
                layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
                activation=cfg.get("hidden_act", "gelu"),
                position_offset=pad + 1,
            )
        if mt == "mpnet":
            pad = cfg.get("pad_token_id", 1)
            return BertConfig(
                flavor="mpnet",
                vocab_size=cfg["vocab_size"],
                hidden_size=cfg["hidden_size"],
                num_layers=cfg["num_hidden_layers"],
                num_heads=cfg["num_attention_heads"],
                intermediate_size=cfg["intermediate_size"],
                max_position_embeddings=cfg["max_position_embeddings"],
                type_vocab_size=0,
                pad_token_id=pad,
                layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
                activation=cfg.get("hidden_act", "gelu"),
                position_offset=pad + 1,
                relative_attention_num_buckets=cfg.get("relative_attention_num_buckets", 32),
            )
        if mt in ("nomic_bert", "nomic-bert"):
            return BertConfig(
                flavor="nomic",
                vocab_size=cfg["vocab_size"],
                hidden_size=cfg["n_embd"],
                num_layers=cfg["n_layer"],
                num_heads=cfg["n_head"],
                intermediate_size=cfg.get("n_inner") or 4 * cfg["n_embd"],
                max_position_embeddings=cfg.get("n_positions", 8192) or 8192,
                type_vocab_size=cfg.get("type_vocab_size", 2),
                pad_token_id=cfg.get("pad_token_id", 0),
                layer_norm_eps=cfg.get("layer_norm_epsilon", 1e-12),
                activation="silu",
                rotary_emb_base=cfg.get("rotary_emb_base", 1000.0),
                swiglu=cfg.get("activation_function", "swiglu") == "swiglu",
            )
        if mt == "bert":
            return BertConfig(
                flavor="bert",
                vocab_size=cfg["vocab_size"],
                hidden_size=cfg["hidden_size"],
                num_layers=cfg["num_hidden_layers"],
                num_heads=cfg["num_attention_heads"],
                intermediate_size=cfg["intermediate_size"],
                max_position_embeddings=cfg["max_position_embeddings"],
                type_vocab_size=cfg.get("type_vocab_size", 2),
                pad_token_id=cfg.get("pad_token_id", 0),
                layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
                activation=cfg.get("hidden_act", "gelu"),
            )
        raise InvalidConfigError(f"unsupported encoder model_type '{mt}'")


# ---------------------------------------------------------------------------
# Weight loading: HF safetensors names -> stacked param dict
# ---------------------------------------------------------------------------

def _stack_linear(ws: ModelWeights, names: list[str]) -> dict:
    """Stack per-layer torch [out,in] weights into {"w": [L,in,out], "b": [L,out]}."""
    p = {"w": np.stack([ws.get_f32(f"{n}.weight").T for n in names])}
    if f"{names[0]}.bias" in ws:
        p["b"] = np.stack([ws.get_f32(f"{n}.bias") for n in names])
    return p


def _stack_norm(ws: ModelWeights, names: list[str]) -> dict:
    return {"weight": np.stack([ws.get_f32(f"{n}.weight") for n in names]),
            "bias": np.stack([ws.get_f32(f"{n}.bias") for n in names])}


def _detect_prefix(ws: ModelWeights, candidates: list[str], probe: str) -> str:
    for p in candidates:
        if f"{p}{probe}" in ws:
            return p
    raise InvalidConfigError(
        f"could not find '{probe}' under any of prefixes {candidates}")


def _load_f32(ws: ModelWeights, cfg: BertConfig) -> dict:
    """The stacked param dict as host f32 numpy arrays, in the JAX package's
    layout and names (its load_params at dtype f32)."""
    L = cfg.num_layers
    if cfg.flavor == "distilbert":
        pre = _detect_prefix(ws, ["distilbert.", ""], "embeddings.word_embeddings.weight")
        layer = [f"{pre}transformer.layer.{i}" for i in range(L)]
        emb = {
            "word": ws.get_f32(f"{pre}embeddings.word_embeddings.weight"),
            "position": ws.get_f32(f"{pre}embeddings.position_embeddings.weight"),
            "token_type": None,
            "norm": {
                "weight": ws.get_f32(f"{pre}embeddings.LayerNorm.weight"),
                "bias": ws.get_f32(f"{pre}embeddings.LayerNorm.bias"),
            },
        }
        layers = {
            "q": _stack_linear(ws, [f"{n}.attention.q_lin" for n in layer]),
            "k": _stack_linear(ws, [f"{n}.attention.k_lin" for n in layer]),
            "v": _stack_linear(ws, [f"{n}.attention.v_lin" for n in layer]),
            "o": _stack_linear(ws, [f"{n}.attention.out_lin" for n in layer]),
            "attn_norm": _stack_norm(ws, [f"{n}.sa_layer_norm" for n in layer]),
            "fc1": _stack_linear(ws, [f"{n}.ffn.lin1" for n in layer]),
            "fc2": _stack_linear(ws, [f"{n}.ffn.lin2" for n in layer]),
            "ffn_norm": _stack_norm(ws, [f"{n}.output_layer_norm" for n in layer]),
        }
        return {"embeddings": emb, "layers": layers, "pooler": None, "rel_bias": None}

    if cfg.flavor == "mpnet":
        pre = _detect_prefix(ws, ["mpnet.", ""], "embeddings.word_embeddings.weight")
        layer = [f"{pre}encoder.layer.{i}" for i in range(L)]
        emb = {
            "word": ws.get_f32(f"{pre}embeddings.word_embeddings.weight"),
            "position": ws.get_f32(f"{pre}embeddings.position_embeddings.weight"),
            "token_type": None,
            "norm": {
                "weight": ws.get_f32(f"{pre}embeddings.LayerNorm.weight"),
                "bias": ws.get_f32(f"{pre}embeddings.LayerNorm.bias"),
            },
        }
        layers = {
            "q": _stack_linear(ws, [f"{n}.attention.attn.q" for n in layer]),
            "k": _stack_linear(ws, [f"{n}.attention.attn.k" for n in layer]),
            "v": _stack_linear(ws, [f"{n}.attention.attn.v" for n in layer]),
            "o": _stack_linear(ws, [f"{n}.attention.attn.o" for n in layer]),
            "attn_norm": _stack_norm(ws, [f"{n}.attention.LayerNorm" for n in layer]),
            "fc1": _stack_linear(ws, [f"{n}.intermediate.dense" for n in layer]),
            "fc2": _stack_linear(ws, [f"{n}.output.dense" for n in layer]),
            "ffn_norm": _stack_norm(ws, [f"{n}.output.LayerNorm" for n in layer]),
        }
        rel = ws.get_f32(f"{pre}encoder.relative_attention_bias.weight")
        return {"embeddings": emb, "layers": layers, "pooler": None, "rel_bias": rel}

    if cfg.flavor == "nomic":
        # NomicBERT: fused Wqkv without bias, out_proj, norm1/norm2, mlp
        # fc11 (gate) / fc12 (up) / fc2
        layer = [f"encoder.layers.{i}" for i in range(L)]
        H = cfg.hidden_size

        def stack_t(suffix):
            return np.stack([ws.get_f32(f"{n}.{suffix}").T for n in layer])

        wqkv = stack_t("attn.Wqkv.weight")  # [L, H, 3H]
        emb = {
            "word": ws.get_f32("embeddings.word_embeddings.weight"),
            "position": None,
            "token_type": (
                ws.get_f32("embeddings.token_type_embeddings.weight")
                if "embeddings.token_type_embeddings.weight" in ws else None),
            "norm": {
                "weight": ws.get_f32("emb_ln.weight"),
                "bias": ws.get_f32("emb_ln.bias"),
            },
        }
        layers = {
            "q": {"w": wqkv[:, :, :H]},
            "k": {"w": wqkv[:, :, H:2 * H]},
            "v": {"w": wqkv[:, :, 2 * H:]},
            "o": {"w": stack_t("attn.out_proj.weight")},
            "attn_norm": _stack_norm(ws, [f"{n}.norm1" for n in layer]),
            "gate": {"w": stack_t("mlp.fc11.weight")},
            "up": {"w": stack_t("mlp.fc12.weight")},
            "fc2": {"w": stack_t("mlp.fc2.weight")},
            "ffn_norm": _stack_norm(ws, [f"{n}.norm2" for n in layer]),
        }
        cos, sin = rope_tables(cfg.head_dim, cfg.max_position_embeddings,
                               theta=cfg.rotary_emb_base)
        return {"embeddings": emb, "layers": layers, "pooler": None,
                "rel_bias": None, "rope_cos": cos, "rope_sin": sin}

    # bert / roberta / xlm-roberta share the HF "encoder.layer" layout
    pre = _detect_prefix(
        ws, ["", "bert.", "roberta.", "xlm-roberta.", "model."],
        "embeddings.word_embeddings.weight")
    layer = [f"{pre}encoder.layer.{i}" for i in range(L)]
    emb = {
        "word": ws.get_f32(f"{pre}embeddings.word_embeddings.weight"),
        "position": ws.get_f32(f"{pre}embeddings.position_embeddings.weight"),
        "token_type": (
            ws.get_f32(f"{pre}embeddings.token_type_embeddings.weight")
            if f"{pre}embeddings.token_type_embeddings.weight" in ws else None),
        "norm": {
            "weight": ws.get_f32(f"{pre}embeddings.LayerNorm.weight"),
            "bias": ws.get_f32(f"{pre}embeddings.LayerNorm.bias"),
        },
    }
    layers = {
        "q": _stack_linear(ws, [f"{n}.attention.self.query" for n in layer]),
        "k": _stack_linear(ws, [f"{n}.attention.self.key" for n in layer]),
        "v": _stack_linear(ws, [f"{n}.attention.self.value" for n in layer]),
        "o": _stack_linear(ws, [f"{n}.attention.output.dense" for n in layer]),
        "attn_norm": _stack_norm(ws, [f"{n}.attention.output.LayerNorm" for n in layer]),
        "fc1": _stack_linear(ws, [f"{n}.intermediate.dense" for n in layer]),
        "fc2": _stack_linear(ws, [f"{n}.output.dense" for n in layer]),
        "ffn_norm": _stack_norm(ws, [f"{n}.output.LayerNorm" for n in layer]),
    }
    pooler = None
    if f"{pre}pooler.dense.weight" in ws:
        pooler = {"w": ws.get_f32(f"{pre}pooler.dense.weight").T,
                  "b": ws.get_f32(f"{pre}pooler.dense.bias")}
    return {"embeddings": emb, "layers": layers, "pooler": pooler, "rel_bias": None}


def load_params(ws: ModelWeights, cfg: BertConfig, dtype=torch.float32,
                device: torch.device | str = "cpu") -> dict:
    """Map HF checkpoint tensor names into the stacked param dict on `device`.

    Name layouts per flavor follow the reference's AttentionLayout /
    FeedForwardLayout conventions (traits.rs:84,99). Weights become `dtype`;
    Nomic's rotary tables stay f32; absent parts are None.
    """
    return params_from_jax(_load_f32(ws, cfg), device, dtype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _mpnet_relative_position_bucket(relative_position: torch.Tensor,
                                    num_buckets: int = 32,
                                    max_distance: int = 128) -> torch.Tensor:
    """HF MPNet bucket scheme (bidirectional T5-style), in f32 and int32 as
    the JAX package computes it; the cast truncates toward zero."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-9)
        / float(np.log(max_distance / max_exact)) * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = torch.clamp_max(val_if_large, num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val_if_large)


def _mpnet_position_bias(rel_bias: torch.Tensor, seq_len: int,
                         cfg: BertConfig) -> torch.Tensor:
    pos = torch.arange(seq_len, device=rel_bias.device)
    rel = pos[None, :] - pos[:, None]  # memory - query
    buckets = _mpnet_relative_position_bucket(
        rel, cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance)
    bias = rel_bias[buckets.long()]  # [S, S, H]
    return bias.permute(2, 0, 1)[None]  # [1, H, S, S]


def _abs_positions(cfg: BertConfig, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor) -> Optional[torch.Tensor]:
    """Per-row absolute position ids (None for rotary models)."""
    if cfg.rotary_emb_base > 0:
        return None  # rotary models have no absolute position embeddings
    if cfg.position_offset > 0:
        # roberta/mpnet position ids: cumsum over the mask, pads pinned to pad idx
        mask_i = attention_mask.to(torch.int64)
        return torch.cumsum(mask_i, dim=1) * mask_i + cfg.pad_token_id
    positions = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
    return positions.expand(input_ids.shape)


def encode(params: dict, cfg: BertConfig, input_ids: torch.Tensor,
           attention_mask: torch.Tensor,
           token_type_ids: Optional[torch.Tensor] = None, tp=None) -> torch.Tensor:
    """Full encoder forward: [B, S] ids -> [B, S, H] hidden states. `tp`: the
    tensor-parallel group's Comm when params are this rank's shard under
    `encoder_param_sharding` (parallel/tensor.py)."""
    S = input_ids.shape[1]
    bias = padding_bias(attention_mask)
    if params.get("rel_bias") is not None:
        bias = bias + _mpnet_position_bias(params["rel_bias"], S, cfg)
    return _encode_core(params, cfg, input_ids,
                        _abs_positions(cfg, input_ids, attention_mask),
                        token_type_ids, bias,
                        torch.arange(S, device=input_ids.device), tp)


def encode_packed_n(params: dict, cfg: BertConfig, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor,
                    token_type_ids: Optional[torch.Tensor] = None,
                    n: int = 2) -> torch.Tensor:
    """encode() with n sequences packed per row.

    [B, S] rows (B divisible by n) run as [B/n, nS] with block-diagonal
    attention, per-lane positions and per-lane relative/rotary patterns: the
    same hidden states (to f32 roundoff), returned at [B, S, H]. Fewer, fuller
    attention rows against an (nS)^2 score matrix instead of n * S^2.
    """
    B, S = input_ids.shape
    dev = input_ids.device
    positions = _abs_positions(cfg, input_ids, attention_mask)
    idsn = input_ids.reshape(B // n, n * S)
    maskn = attention_mask.reshape(B // n, n * S)
    posn = None if positions is None else positions.reshape(B // n, n * S)
    ttn = None if token_type_ids is None else token_type_ids.reshape(B // n, n * S)

    bias = padding_bias(maskn)
    # mask cross-lane attention
    lane = torch.arange(n * S, device=dev) // S
    block = torch.where(lane[:, None] == lane[None, :], 0.0, -1e30)
    bias = bias + block[None, None]
    if params.get("rel_bias") is not None:
        rb = _mpnet_position_bias(params["rel_bias"], S, cfg)  # [1, H, S, S]
        rbn = torch.zeros(rb.shape[:2] + (n * S, n * S), dtype=rb.dtype, device=dev)
        for i in range(n):
            rbn[:, :, i * S:(i + 1) * S, i * S:(i + 1) * S] = rb
        bias = bias + rbn
    rope_pos = torch.arange(S, device=dev).repeat(n)
    hidden = _encode_core(params, cfg, idsn, posn, ttn, bias, rope_pos)
    return hidden.reshape(B, S, cfg.hidden_size)


def encode_packed_pairs(params: dict, cfg: BertConfig, input_ids: torch.Tensor,
                        attention_mask: torch.Tensor,
                        token_type_ids: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Two sequences per row (encode_packed_n at n = 2)."""
    return encode_packed_n(params, cfg, input_ids, attention_mask,
                           token_type_ids, n=2)


def _pack_plan(B: int, S: int) -> tuple[int, int]:
    """Packing choice for encode_auto: (n, pad_rows).

    Candidates carry their measured gain over the plain path; ragged batches
    pad up to a full group with inert rows when the gain still covers the
    dummy compute: effective speedup = gain * B / (B + pad), and the plan
    with the best effective speedup wins (plain = 1.0).

    Gains measured on an NVIDIA H100 80GB HBM3 (700 W) by chip_smoke.py's
    embed phase (MiniLM-L6 width, B256, bf16, device ms of one forward):
    pack-2 at S = 64 is 0.82x plain (8.91 against 7.31 ms); at S = 32
    pack-2 is 0.95x (3.58 against 3.42) and pack-4 0.75x (4.55). The GEMMs
    are the same either way and the plain attention's memory-bound score
    ops grow n-fold, so packing never wins on the card and the plan is
    always plain (n = 1).
    """
    cands = [(1, 0, 1.0)]
    if S <= 64 and B >= 2:
        cands.append((2, (-B) % 2, 0.95 if S <= 32 else 0.82))
        if S <= 32:
            cands.append((4, (-B) % 4, 0.75))
    n, pad, _ = max(cands, key=lambda c: c[2] * B / (B + c[1]))
    return n, pad


def encode_auto(params: dict, cfg: BertConfig, input_ids: torch.Tensor,
                attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """encode() with packing for short rows where `_pack_plan` says it pays.

    Batches that don't divide the pack width are padded with inert rows (pad
    ids, zero mask; their uniform self-attention stays inside their own
    lane) and sliced back.
    """
    B, S = input_ids.shape
    n, pad = _pack_plan(B, S)
    if n == 1:
        return encode(params, cfg, input_ids, attention_mask, token_type_ids)
    if pad:
        input_ids = torch.cat(
            [input_ids, input_ids.new_full((pad, S), cfg.pad_token_id)])
        attention_mask = torch.cat([attention_mask, attention_mask.new_zeros((pad, S))])
        if token_type_ids is not None:
            token_type_ids = torch.cat(
                [token_type_ids, token_type_ids.new_zeros((pad, S))])
    out = encode_packed_n(params, cfg, input_ids, attention_mask,
                          token_type_ids, n=n)
    return out[:B] if pad else out


def _encode_core(params: dict, cfg: BertConfig, input_ids: torch.Tensor,
                 positions: Optional[torch.Tensor],
                 token_type_ids: Optional[torch.Tensor],
                 bias: torch.Tensor, rope_positions: torch.Tensor,
                 tp=None) -> torch.Tensor:
    emb = params["embeddings"]
    x = F.embedding(input_ids, emb["word"])
    if positions is not None:
        x = x + F.embedding(positions, emb["position"])

    if emb.get("token_type") is not None:
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = x + F.embedding(token_type_ids, emb["token_type"])

    x = layer_norm(x, emb["norm"]["weight"], emb["norm"]["bias"], cfg.layer_norm_eps)

    act = get_activation(cfg.activation)
    H = tpx.local_heads(params["layers"]["q"]["w"].shape[-1], cfg.head_dim)
    bias = tpx.own_heads(bias, H, tp)
    rotary = cfg.rotary_emb_base > 0
    if rotary:
        cos = params["rope_cos"][rope_positions]
        sin = params["rope_sin"][rope_positions]

    for i in range(cfg.num_layers):
        lp = {name: {k: t[i] for k, t in e.items()}
              for name, e in params["layers"].items()}
        q = x @ lp["q"]["w"]
        k = x @ lp["k"]["w"]
        v = x @ lp["v"]["w"]
        if "b" in lp["q"]:
            q = q + lp["q"]["b"]
            k = k + lp["k"]["b"]
            v = v + lp["v"]["b"]
        q, k, v = split_heads(q, H), split_heads(k, H), split_heads(v, H)
        if rotary:
            q, k = apply_rope(q, k, cos, sin)
        ctx = merge_heads(attention(q, k, v, bias))
        attn_out = tpx.row(ctx, lp["o"]["w"], lp["o"].get("b"), tp,
                           cfg.num_heads * cfg.head_dim)
        x = layer_norm(x + attn_out, lp["attn_norm"]["weight"], lp["attn_norm"]["bias"],
                       cfg.layer_norm_eps)
        if cfg.swiglu:
            h = act(x @ lp["gate"]["w"]) * (x @ lp["up"]["w"])
        else:
            h = act(x @ lp["fc1"]["w"] + lp["fc1"]["b"])
        ffn = tpx.row(h, lp["fc2"]["w"], None if cfg.swiglu else lp["fc2"]["b"], tp,
                      cfg.intermediate_size)
        x = layer_norm(x + ffn, lp["ffn_norm"]["weight"], lp["ffn_norm"]["bias"],
                       cfg.layer_norm_eps)
    return x


def pooler_forward(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """BERT pooler: tanh(dense(CLS)) (cf. cpu/encoder/pooler.rs:9)."""
    cls = hidden[:, 0, :]
    return torch.tanh(cls @ params["w"] + params["b"])
