"""DeepSeek-V2: multi-head latent attention over a latent cache, YaRN rope,
and routed and shared experts after leading dense layers (model_type
"deepseek_v2", as the published `modeling_deepseek.py` of DeepSeek-V2-Lite
computes it).

Per layer, over x [B, S, hidden], with H heads, dn = qk_nope_head_dim,
dr = qk_rope_head_dim, dv = v_head_dim, R = kv_lora_rank:

    h = RMSNorm(x)
    q = h W_q                      per head [q_nope (dn) | q_pe (dr)]
    [c_kv | k_pe] = h W_kv_a       c_kv (R); k_pe (dr), one for all heads
    c_kv = RMSNorm(c_kv)           (kv_a_layernorm)
    [k_nope | v] = c_kv W_kv_b     per head, dn + dv
    q_pe, k_pe = rope(q_pe), rope(k_pe)
    a = softmax(causal(q_nope . k_nope + q_pe . k_pe) * s)
        s = (dn + dr)^-0.5 * m^2,  m = 0.1 * mscale_all_dim * ln(factor) + 1
    x = x + (a v) W_o
    x = x + MLP(RMSNorm(x))

MLP: a SwiGLU of `intermediate_size` in the first `first_k_dense_replace`
layers. In the others: p = softmax(h W_router), logits in f32; (w, e) = the
greedy top-k of p (renormalised only under norm_topk_prob, else times
routed_scaling_factor); y = sum_j w_j SwiGLU_{e_j}(h), weighted and summed in
f32 and cast to h's dtype, plus the shared experts, n_shared_experts
SwiGLUs of moe_intermediate_size that act as one of n_shared times that.

Rope (rope_scaling type "yarn"): inv_freq blends 1/theta^(2i/dr) and
1/(factor theta^(2i/dr)) by the linear ramp between the correction dims of
beta_fast and beta_slow at original_max_position_embeddings; cos and sin are
scaled by mscale(factor, mscale) / mscale(factor, mscale_all_dim). The
published code applies rotate-half to each dr-vector after an interleave
(viewed as (dr/2, 2) and transposed: even dims, then odd ones).

Cache: the normalised latent c_kv [L, B, 1, T, R] and the roped k_pe
[L, B, 1, T, dr], shared by every head: the llama family's [L, B, H, T, D]
form with H = 1, so that the engine's admission scatter, prefix copy and
working slices take it unchanged.

Attention routes. A forward of one query row per sequence (decode) runs the
absorbed form: W_UK, the k_nope rows of W_kv_b, is folded into the query, so
each head scores [q_nope W_UK | q_pe] against [c_kv | k_pe] over R + dr dims,
and W_UV is applied to the weighted sum of c_kv. A forward of several rows
(prefill, the engine's admission waves) runs the expanded form: k_nope and v
are decompressed from the latent of every slot it attends, and the plain
attention runs at D = dn + dr, Dv = dv. Both are exact rewritings of the
equations. The flash kernel takes neither (D <= 128).

The routed experts run as one grouped GEMM per projection over rows sorted
by expert on the device (ops/moe.py): a forward makes no host sync.

Departures from the published code, none of which changes a result beyond
rounding:
- the interleave is folded into the weights at load: the rope columns of
  W_q and W_kv_a are permuted (even dims, then odd), so the forward applies
  rotate-half directly; q_pe and k_pe meet only in their dot product, so
  the common permutation changes nothing;
- rope angles are computed in f64 (the published code: f32), as
  llama.rope_cache computes them;
- W_q and W_kv_a are applied as one fused product, and so are gate and up,
  in the dense layer, the shared experts and the routed experts alike.

RMSNorm is torch's `rms_norm` (statistics in f32, cast back, then the
weight, the published code's order).

While a torch profiler runs, each attention call records a `kjarni.mla`
span (counts q_rows, kv_len, absorbed) and each MoE layer a `kjarni.moe`
span (counts tokens, rows), both under `kjarni.forward`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import profiling
from ..core.errors import GenerationError, InvalidConfigError
from ..ops import moe
from ..ops.attention import NEG_INF, attention, merge_heads
from ..ops.rope import apply_rope
from ..weights.safetensors_loader import ModelWeights
from .llama import _cache_write, _get, _mm, _stack, cache_slots, causal_bias, layer_params

ARCH = "deepseek_v2"
# the continuous engine's admission memory gate counts a wave's own lanes for
# this family, which has no JAX engine whose S-lane count it must match
ADMIT_WAVE_LANES = True


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    intermediate_size: int          # the dense layers' SwiGLU
    moe_intermediate_size: int      # one expert's
    n_routed_experts: int
    n_shared_experts: int
    num_experts_per_tok: int
    first_k_dense_replace: int
    max_seq_len: int
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # YaRN; factor None: plain rope
    rope_factor: Optional[float] = None
    rope_original_max: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 0.0
    tie_word_embeddings: bool = False
    bos_token_id: Optional[int] = None
    eos_token_ids: tuple[int, ...] = ()
    arch: str = ARCH

    @property
    def softmax_scale(self) -> float:
        s = (self.qk_nope_head_dim + self.qk_rope_head_dim) ** -0.5
        if self.rope_factor is not None and self.rope_mscale_all_dim:
            s *= yarn_mscale(self.rope_factor, self.rope_mscale_all_dim) ** 2
        return s

    @staticmethod
    def from_hf(cfg: dict) -> "DeepseekV2Config":
        """The config of a published `config.json`; raises
        InvalidConfigError for what this module does not compute."""
        unsupported = {
            "q_lora_rank": cfg.get("q_lora_rank") is not None,
            "attention_bias": bool(cfg.get("attention_bias", False)),
            "topk_method": cfg.get("topk_method", "greedy") != "greedy",
            "scoring_func": cfg.get("scoring_func", "softmax") != "softmax",
            "moe_layer_freq": cfg.get("moe_layer_freq", 1) != 1,
            "n_routed_experts": cfg.get("n_routed_experts") is None,
            "n_shared_experts": not cfg.get("n_shared_experts"),
            "hidden_act": cfg.get("hidden_act", "silu") != "silu",
        }
        rs = cfg.get("rope_scaling") or {}
        rtype = rs.get("type", rs.get("rope_type"))
        unsupported["rope_scaling"] = bool(rs) and rtype != "yarn"
        bad = sorted(k for k, v in unsupported.items() if v)
        if bad:
            raise InvalidConfigError(f"{ARCH} does not take " + ", ".join(
                f"{k}={cfg.get(k)!r}" for k in bad))
        eos = cfg.get("eos_token_id")
        eos_ids = () if eos is None else tuple(eos) if isinstance(eos, list) else (int(eos),)
        return DeepseekV2Config(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            kv_lora_rank=cfg["kv_lora_rank"],
            qk_nope_head_dim=cfg["qk_nope_head_dim"],
            qk_rope_head_dim=cfg["qk_rope_head_dim"],
            v_head_dim=cfg["v_head_dim"],
            intermediate_size=cfg["intermediate_size"],
            moe_intermediate_size=cfg["moe_intermediate_size"],
            n_routed_experts=cfg["n_routed_experts"],
            n_shared_experts=cfg["n_shared_experts"],
            num_experts_per_tok=cfg["num_experts_per_tok"],
            first_k_dense_replace=cfg.get("first_k_dense_replace", 0),
            max_seq_len=cfg["max_position_embeddings"],
            norm_topk_prob=bool(cfg.get("norm_topk_prob", False)),
            routed_scaling_factor=float(cfg.get("routed_scaling_factor", 1.0)),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
            rope_theta=float(cfg.get("rope_theta", 10000.0)),
            rope_factor=float(rs["factor"]) if rs else None,
            rope_original_max=int(rs.get("original_max_position_embeddings", 4096)),
            rope_beta_fast=float(rs.get("beta_fast", 32)),
            rope_beta_slow=float(rs.get("beta_slow", 1)),
            rope_mscale=float(rs.get("mscale", 1)),
            rope_mscale_all_dim=float(rs.get("mscale_all_dim", 0)),
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            bos_token_id=cfg.get("bos_token_id"),
            eos_token_ids=eos_ids,
        )


# ---------------------------------------------------------------------------
# YaRN
# ---------------------------------------------------------------------------

def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(cfg: DeepseekV2Config) -> np.ndarray:
    """[dr / 2] f64 inverse frequencies: plain rope without scaling, else
    YaRN's blend of the extrapolated and interpolated frequencies."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    extra = 1.0 / base ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
    if cfg.rope_factor is None:
        return extra

    def correction_dim(rotations):
        return (dim * math.log(cfg.rope_original_max / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(correction_dim(cfg.rope_beta_fast)), 0)
    high = min(math.ceil(correction_dim(cfg.rope_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = np.clip((np.arange(dim // 2, dtype=np.float64) - low) / (high - low), 0, 1)
    keep = 1.0 - ramp                   # the published inv_freq_mask
    return extra / cfg.rope_factor * (1 - keep) + extra * keep


def rope_cache(cfg: DeepseekV2Config, length: int) -> tuple[np.ndarray, np.ndarray]:
    """f32 cos / sin [length, dr], the half-dim frequencies in both halves
    (rotate-half), scaled by YaRN's mscale ratio."""
    scale = 1.0
    if cfg.rope_factor is not None:
        scale = (yarn_mscale(cfg.rope_factor, cfg.rope_mscale)
                 / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim))
    ang = np.outer(np.arange(length, dtype=np.float64), yarn_inv_freq(cfg))
    ang = np.concatenate([ang, ang], axis=-1)
    return ((np.cos(ang) * scale).astype(np.float32),
            (np.sin(ang) * scale).astype(np.float32))


def rope_permutation(dr: int) -> torch.Tensor:
    """The published interleave as an index: new[c * dr/2 + i] = old[2i + c]."""
    return torch.arange(dr).view(dr // 2, 2).t().reshape(-1)


# ---------------------------------------------------------------------------
# Weight loading
# ---------------------------------------------------------------------------

def _stack_experts(ws: ModelWeights, fmts: tuple, layers: range, experts: int,
                   dtype, device) -> torch.Tensor:
    """[len(layers), E, sum of rows, in] of per-expert checkpoint tensors
    [out, in] in their own layout, the tensors of fmts joined along out
    (gate, then up). Each fmt is read over every layer and expert before
    the next, one kind of tensor at a time."""
    out, row = None, 0
    for fmt in fmts:
        n = None
        for j, i in enumerate(layers):
            for e in range(experts):
                t = _get(ws, fmt.format(i, e))
                if out is None:
                    rows = t.shape[0] * len(fmts)
                    out = torch.empty((len(layers), experts, rows, t.shape[1]),
                                      dtype=dtype, device=device)
                n = t.shape[0]
                out[j, e, row:row + n].copy_(t.to(device))
        row += n
    return out


def load_params(ws: ModelWeights, cfg: DeepseekV2Config, dtype=torch.float32,
                rope_cache_len: Optional[int] = None,
                device: torch.device | str = "cpu") -> dict:
    """The published checkpoint's tensors as stacked params: "layers"
    (attention and norms, every layer), "dense" (the first
    first_k_dense_replace layers' MLPs), "moe" (the others': router [hid, E]
    f32, experts' gate_up [E, 2I, hid] and down [E, hid, I] in the
    checkpoint's [out, in] layout, the shared experts' gate_up and down).
    Linear weights are [in, out] for x @ w: "qkv_a" is W_q and W_kv_a side
    by side; the absorbed attention's "uk" [H, dn, R] and "uv" [H, R, dv]
    are split from kv_b. "views" holds each layer's views of them
    (layer_views)."""
    L, H = cfg.num_layers, cfg.num_heads
    dn, dr, dv, R = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    k0 = cfg.first_k_dense_replace
    p = "model.layers.{}."
    every, dense, sparse = range(L), range(k0), range(k0, L)

    def stack(name, layers=every, transpose=True):
        return _stack(ws, p + name, layers, dtype, device, transpose)

    def one(name):
        return _get(ws, name).to(device=device, dtype=dtype)

    perm = rope_permutation(dr).to(device)
    q = stack("self_attn.q_proj.weight").view(L, cfg.hidden_size, H, dn + dr)
    q[..., dn:] = q[..., dn:][..., perm].clone()
    kv_a = stack("self_attn.kv_a_proj_with_mqa.weight")
    kv_a[..., R:] = kv_a[..., R:][..., perm].clone()
    qkv_a = torch.cat([q.view(L, cfg.hidden_size, -1), kv_a], dim=-1)
    del q, kv_a
    kv_b = stack("self_attn.kv_b_proj.weight")                  # [L, R, H (dn + dv)]
    heads = kv_b.view(L, R, H, dn + dv)
    layers = {
        "attn_norm": stack("input_layernorm.weight", transpose=False),
        "ffn_norm": stack("post_attention_layernorm.weight", transpose=False),
        "qkv_a": {"w": qkv_a},                                   # [L, hid, H (dn + dr) + R + dr]
        "kv_norm": stack("self_attn.kv_a_layernorm.weight", transpose=False),
        "kv_b": {"w": kv_b},
        "uk": heads[..., :dn].permute(0, 2, 3, 1).contiguous(),  # [L, H, dn, R]
        "uv": heads[..., dn:].permute(0, 2, 1, 3).contiguous(),  # [L, H, R, dv]
        "o": {"w": stack("self_attn.o_proj.weight")},
    }

    def swiglu(prefix, rng):
        gate_up = torch.cat([stack(prefix + "gate_proj.weight", rng),
                             stack(prefix + "up_proj.weight", rng)], dim=-1)
        return {"gate_up": {"w": gate_up}, "down": {"w": stack(prefix + "down_proj.weight", rng)}}

    params = {
        "embed": one("model.embed_tokens.weight"),
        "layers": layers,
        "dense": swiglu("mlp.", dense) if k0 else {},
        "final_norm": one("model.norm.weight"),
    }
    if len(sparse):
        shared = swiglu("mlp.shared_experts.", sparse)
        ex = p + "mlp.experts.{}."
        params["moe"] = {
            "router": _stack(ws, p + "mlp.gate.weight", sparse, torch.float32, device),
            "experts_gate_up": _stack_experts(ws, (ex + "gate_proj.weight", ex + "up_proj.weight"),
                                              sparse, cfg.n_routed_experts, dtype, device),
            "experts_down": _stack_experts(ws, (ex + "down_proj.weight",), sparse,
                                           cfg.n_routed_experts, dtype, device),
            "shared_gate_up": shared["gate_up"], "shared_down": shared["down"],
        }
    if cfg.tie_word_embeddings or "lm_head.weight" not in ws:
        params["lm_head"] = params["embed"].t()
    else:
        params["lm_head"] = one("lm_head.weight").t().contiguous()
    cos, sin = rope_cache(cfg, rope_cache_len or cfg.max_seq_len)
    params["rope_cos"] = torch.from_numpy(cos).to(device)
    params["rope_sin"] = torch.from_numpy(sin).to(device)
    params["views"] = layer_views(params, cfg)
    return params


def layer_views(params: dict, cfg: DeepseekV2Config) -> list[dict]:
    """Each layer's views of the stacked params, made once: its attention
    and norms, and under "mlp" its dense SwiGLU or its MoE layer."""
    k0 = cfg.first_k_dense_replace
    out = []
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        lp["mlp"] = layer_params(params["dense"], i) if i < k0 else \
            layer_params(params["moe"], i - k0)
        out.append(lp)
    return out


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def init_cache(cfg: DeepseekV2Config, batch: int, max_len: int, dtype=torch.float32,
               device: torch.device | str = "cpu", quantized: bool = False):
    """(c_kv [L, B, 1, T, R], k_pe [L, B, 1, T, dr]), zeroed, written in
    place."""
    if quantized:
        raise InvalidConfigError(f"{ARCH} takes no int8 cache")
    lead = (cfg.num_layers, batch, 1, max_len)
    return (torch.zeros((*lead, cfg.kv_lora_rank), dtype=dtype, device=device),
            torch.zeros((*lead, cfg.qk_rope_head_dim), dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _scores(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [B, M, K] @ b [B, K, N] in f32: on the card, bf16 operands with f32
    products and output, so the latent cache is read once in its own type."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _absorbed(lp: dict, cfg: DeepseekV2Config, q_nope, q_pe, c_kv, k_pe, bias):
    """Attention of q [B, H, S, dn | dr] over the latent c_kv [B, n, R] and
    k_pe [B, n, dr] with W_UK folded into the query and W_UV applied after
    the weighted sum -> [B, S, H dv]."""
    B, H, S, _ = q_nope.shape
    n, R = c_kv.shape[1], c_kv.shape[2]
    q_lat = torch.einsum("bhsd,hdr->bhsr", q_nope, lp["uk"]).reshape(B, H * S, R)
    scores = _scores(q_lat, c_kv.transpose(1, 2)) + \
        _scores(q_pe.reshape(B, H * S, -1), k_pe.transpose(1, 2))
    scores = scores.view(B, H, S, n) * cfg.softmax_scale
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(c_kv.dtype)
    ctx = torch.bmm(probs.view(B, H * S, n), c_kv).view(B, H, S, R)
    return torch.einsum("bhsr,hrv->bshv", ctx, lp["uv"]).reshape(B, S, H * cfg.v_head_dim)


def _expanded(lp: dict, cfg: DeepseekV2Config, q_nope, q_pe, c_kv, k_pe, bias):
    """The published attention: k_nope and v decompressed from c_kv
    [B, n, R] for every head, k_pe [B, n, dr] shared -> [B, S, H dv]."""
    B, H, S, dn = q_nope.shape
    n = c_kv.shape[1]
    kv = _mm(c_kv, lp["kv_b"]).view(B, n, H, dn + cfg.v_head_dim).transpose(1, 2)
    k = torch.cat([kv[..., :dn], k_pe[:, None].expand(B, H, n, k_pe.shape[-1])], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    return merge_heads(attention(q, k, kv[..., dn:], bias, scale=cfg.softmax_scale))


def mla(lp: dict, cfg: DeepseekV2Config, h: torch.Tensor, cos, sin, caches, pos_start,
        bias, n_kv: int, absorbed: bool) -> torch.Tensor:
    """One attention call over h [B, S, hidden] -> [B, S, hidden]: the
    latent and roped key of its rows written into `caches` (one layer's
    (c_kv, k_pe), or None: attend the fresh rows alone) at pos_start, then
    attention over the first n_kv slots by the absorbed or expanded form."""
    B, S, _ = h.shape
    H, dn, R = cfg.num_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    with profiling.annotate("kjarni.mla", q_rows=B * S, kv_len=n_kv,
                            absorbed=int(absorbed)):
        qkv = _mm(h, lp["qkv_a"])
        q = qkv[..., :H * (dn + cfg.qk_rope_head_dim)].view(B, S, H, -1).transpose(1, 2)
        kv = qkv[..., H * (dn + cfg.qk_rope_head_dim):]
        c_kv = _norm(kv[..., :R], lp["kv_norm"], cfg.rms_norm_eps)[:, None]
        q_pe, k_pe = apply_rope(q[..., dn:], kv[..., R:][:, None], cos, sin)
        if caches is not None:
            _cache_write(caches[0], c_kv, pos_start)
            _cache_write(caches[1], k_pe, pos_start)
            c_kv, k_pe = caches[0][:, :, :n_kv], caches[1][:, :, :n_kv]
        attend = _absorbed if absorbed else _expanded
        ctx = attend(lp, cfg, q[..., :dn], q_pe, c_kv[:, 0], k_pe[:, 0], bias)
        return _mm(ctx, lp["o"])


def _norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return F.rms_norm(x, (x.shape[-1],), w, eps)


def _swiglu(h: torch.Tensor, gate_up: dict, down: dict) -> torch.Tensor:
    gu = _mm(h, gate_up)
    inter = gu.shape[-1] // 2
    return _mm(F.silu(gu[..., :inter]) * gu[..., inter:], down)


def moe_block(mp: dict, cfg: DeepseekV2Config, h: torch.Tensor) -> torch.Tensor:
    """One MoE layer's MLP over h [B, S, hidden]: routed experts through the
    grouped route, plus the shared experts."""
    shape = h.shape
    x = h.reshape(-1, shape[-1])
    k = cfg.num_experts_per_tok
    with profiling.annotate("kjarni.moe", tokens=x.shape[0], rows=x.shape[0] * k):
        w, e = moe.route(x, mp["router"], k, cfg.norm_topk_prob, cfg.routed_scaling_factor)
        y = moe.experts_forward(x, w, e, mp["experts_gate_up"], mp["experts_down"])
        y = y + _swiglu(x, mp["shared_gate_up"], mp["shared_down"])
    return y.view(shape)


def _run_stack(params: dict, cfg: DeepseekV2Config, ids: torch.Tensor, cache_k, cache_v,
               pos_start, use_flash: bool = False,
               positions: Optional[torch.Tensor] = None,
               pad_mask: Optional[torch.Tensor] = None,
               kv_bucket: Optional[int] = None, tp=None) -> torch.Tensor:
    """Embed -> layers -> final norm, with llama._run_stack's conventions:
    ids [B, S] at cache slots pos_start + arange(S) (an int; or a [B] tensor
    with S = 1, each row at its own slot of its own cache row); `positions`
    [B, S] per-row rope positions and `pad_mask` [B, T] under left padding;
    no cache: attend the fresh rows. A prefill attends slots
    [0, pos_start + S), the only ones its causal mask keeps; a per-row
    decode the whole (working) cache. One row per sequence (S = 1) runs the
    absorbed attention, more the expanded."""
    if use_flash or tp is not None:
        raise InvalidConfigError(f"{ARCH} takes neither the flash kernel nor tensor "
                                 f"parallelism")
    B, S = ids.shape
    per_row = torch.is_tensor(pos_start)
    if per_row and (S != 1 or pos_start.shape != (B,)):
        raise GenerationError("a per-row decode position takes one token per row")
    pos_start = pos_start if per_row else int(pos_start)
    if cache_k is None:
        n_kv = S
    elif per_row:
        n_kv = cache_slots(cache_k)
    else:
        n_kv = pos_start + S
        if pos_start < 0 or n_kv > cache_slots(cache_k):
            raise GenerationError(f"cache write of {S} positions at {pos_start} exceeds "
                                  f"its {cache_slots(cache_k)} slots")
    absorbed = S == 1
    eps = cfg.rms_norm_eps
    with profiling.annotate("kjarni.forward"):
        x = F.embedding(ids, params["embed"])
        if per_row:
            cos = params["rope_cos"][pos_start][:, None, None]
            sin = params["rope_sin"][pos_start][:, None, None]
        elif positions is None:
            cos = params["rope_cos"][pos_start:pos_start + S]
            sin = params["rope_sin"][pos_start:pos_start + S]
        else:
            cos = params["rope_cos"][positions][:, None]
            sin = params["rope_sin"][positions][:, None]
        cos, sin = cos.to(x.dtype), sin.to(x.dtype)
        bias = causal_bias(pos_start, S, n_kv, ids.device)
        if pad_mask is not None:
            bias = bias + torch.where(pad_mask[:, :n_kv].bool(), 0.0,
                                      NEG_INF)[:, None, None, :]
        for i, lp in enumerate(params["views"]):
            caches = None if cache_k is None else (cache_k[i], cache_v[i])
            x = x + mla(lp, cfg, _norm(x, lp["attn_norm"], eps), cos, sin, caches,
                        pos_start, bias, n_kv, absorbed)
            h = _norm(x, lp["ffn_norm"], eps)
            if i < cfg.first_k_dense_replace:
                x = x + _swiglu(h, lp["mlp"]["gate_up"], lp["mlp"]["down"])
            else:
                x = x + moe_block(lp["mlp"], cfg, h)
        return _norm(x, params["final_norm"], eps)


def head_logits(params: dict, cfg: DeepseekV2Config, x: torch.Tensor,
                tp=None) -> torch.Tensor:
    """lm-head projection of gathered hidden rows."""
    return x @ params["lm_head"]


def forward(params: dict, cfg: DeepseekV2Config, ids: torch.Tensor, cache_k, cache_v,
            pos_start, last_idx: Optional[int] = None, use_flash: bool = False,
            positions: Optional[torch.Tensor] = None,
            pad_mask: Optional[torch.Tensor] = None,
            kv_bucket: Optional[int] = None, tp=None):
    """One pass, as llama.forward: (logits [B, V] at last_idx (default
    S - 1), cache_k, cache_v), the caches written in place."""
    x = _run_stack(params, cfg, ids, cache_k, cache_v, pos_start, use_flash, positions,
                   pad_mask, kv_bucket, tp)
    last_idx = ids.shape[1] - 1 if last_idx is None else int(last_idx)
    return head_logits(params, cfg, x[:, last_idx]), cache_k, cache_v


def forward_all_logits(params: dict, cfg: DeepseekV2Config, ids: torch.Tensor, cache_k,
                       cache_v, pos_start: int, tp=None):
    """Like forward() but returns logits at every position."""
    x = _run_stack(params, cfg, ids, cache_k, cache_v, pos_start, tp=tp)
    return head_logits(params, cfg, x), cache_k, cache_v


def forward_hidden(params: dict, cfg: DeepseekV2Config, ids: torch.Tensor, cache_k,
                   cache_v, pos_start, use_flash: bool = False,
                   positions: Optional[torch.Tensor] = None,
                   pad_mask: Optional[torch.Tensor] = None,
                   kv_bucket: Optional[int] = None, tp=None) -> torch.Tensor:
    """The stack without the head: final-norm hidden states [B, S, H]."""
    return _run_stack(params, cfg, ids, cache_k, cache_v, pos_start, use_flash,
                      positions, pad_mask, kv_bucket, tp)
