"""Unified GQA+RoPE+RMSNorm+SwiGLU decoder: Llama / Qwen2 / Mistral / Phi-3
(port of kjarni_tpu/models/llama.py).

Params keep the JAX package's layout: a dict whose per-layer weights are
stacked [L, ...], linear weights [K, N] for x @ w, int4 weights as
{"w4": [.., K/2, N] int8, "scale": [.., G, N] f32}, int8 weights as
{"w": [.., K, N] int8, "scale": [.., N] f32}. The layer loop is a Python
loop over views of the stacked tensors. The KV cache [L, B, Hkv, T, D] is
written in place; a write past T is refused, not clamped. The int8 cache is
{"q": int8 [L, B, Hkv, T, D], "s": f32 [L, B, Hkv, T]}, and attention
dequantizes only the slots it reads.

Tensor parallelism (SPMD, one process per rank; parallel/mesh.py): params
hold this rank's Megatron shards, and the forward functions take the tp
group's `Comm` as `tp`. A layer takes its head counts from the shards'
widths, attends over its own heads (flash included) with a cache of its own
KV heads, and sums o's and down's partial products over the group; the head
gathers a column-parallel head's logits. With tp=None none of this runs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import profiling
from ..core.errors import GenerationError, InvalidConfigError
from ..core.metadata import RopeScaling
from ..core.placement import host_gather, host_matmul
from ..ops.attention import NEG_INF, attention, merge_heads
from ..ops.kernels.flash_attention import flash_attention
from ..ops.kernels.int4_matvec import int4_matvec
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, base_inv_freq, llama3_inv_freq
from ..weights.safetensors_loader import ModelWeights


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    arch: str  # "llama" | "qwen2" | "mistral" | "phi3"
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    max_seq_len: int
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: Optional[RopeScaling] = None
    longrope_short_factor: Optional[tuple[float, ...]] = None
    longrope_long_factor: Optional[tuple[float, ...]] = None
    original_max_seq_len: Optional[int] = None
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    tie_word_embeddings: bool = False
    bos_token_id: Optional[int] = None
    eos_token_ids: tuple[int, ...] = ()
    # per-stage host offload (ExecutionPlan, execution/plan.rs:4): when set,
    # the table lives in host memory and its lookup or matmul runs there
    # (core/placement.py)
    embed_on_host: bool = False
    lm_head_on_host: bool = False

    @staticmethod
    def from_hf(cfg: dict) -> "DecoderConfig":
        mt = cfg.get("model_type", "llama")
        archs = {"llama": "llama", "qwen2": "qwen2", "mistral": "mistral",
                 "phi3": "phi3"}
        if mt not in archs:
            raise InvalidConfigError(f"unsupported decoder model_type '{mt}'")
        head_dim = cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]
        rope_scaling = None
        short = long = None
        orig = None
        rs = cfg.get("rope_scaling")
        if rs:
            rtype = rs.get("rope_type", rs.get("type", ""))
            if rtype == "llama3":
                rope_scaling = RopeScaling(
                    rope_type="llama3",
                    factor=rs.get("factor", 32.0),
                    low_freq_factor=rs.get("low_freq_factor", 1.0),
                    high_freq_factor=rs.get("high_freq_factor", 4.0),
                    original_max_position_embeddings=rs.get(
                        "original_max_position_embeddings", 8192),
                )
            elif rtype in ("longrope", "su"):
                short = tuple(float(x) for x in rs["short_factor"])
                long = tuple(float(x) for x in rs["long_factor"])
                orig = cfg.get("original_max_position_embeddings",
                               cfg["max_position_embeddings"])
        eos = cfg.get("eos_token_id")
        if eos is None:
            eos_ids: tuple[int, ...] = ()
        elif isinstance(eos, list):
            eos_ids = tuple(int(e) for e in eos)
        else:
            eos_ids = (int(eos),)
        return DecoderConfig(
            arch=archs[mt],
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            num_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            head_dim=head_dim,
            intermediate_size=cfg["intermediate_size"],
            max_seq_len=cfg["max_position_embeddings"],
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rope_scaling=rope_scaling,
            longrope_short_factor=short,
            longrope_long_factor=long,
            original_max_seq_len=orig,
            qkv_bias=mt == "qwen2",
            sliding_window=(cfg.get("sliding_window")
                            if cfg.get("use_sliding_window", mt == "mistral") else None),
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            bos_token_id=cfg.get("bos_token_id"),
            eos_token_ids=eos_ids,
        )


# ---------------------------------------------------------------------------
# Weight loading
# ---------------------------------------------------------------------------

def _get(ws: ModelWeights, name: str) -> torch.Tensor:
    """One checkpoint tensor as a torch tensor: `ModelWeights` gives torch
    views, `GgufWeights` (weights/gguf.py) dequantized numpy arrays."""
    t = ws.get(name)
    return torch.from_numpy(t) if isinstance(t, np.ndarray) else t


def _stack(ws: ModelWeights, fmt: str, L: int, dtype, device,
           transpose: bool = True) -> torch.Tensor:
    """Stack L checkpoint tensors on `device`. Each layer goes to the device
    in its stored dtype and is transposed and cast there, so the host holds
    no converted copy of the model."""
    out = None
    for i in range(L):
        t = _get(ws, fmt.format(i)).to(device)
        t = t.t() if transpose else t
        if out is None:
            out = torch.empty((L, *t.shape), dtype=dtype, device=device)
        out[i].copy_(t)
    return out


def load_params(ws: ModelWeights, cfg: DecoderConfig, dtype=torch.float32,
                rope_cache_len: Optional[int] = None,
                device: torch.device | str = "cpu") -> dict:
    """Map HF llama-layout checkpoints (safetensors, or GGUF through
    weights/gguf.py's HF names) into the stacked param dict.

    Phi-3's fused qkv_proj / gate_up_proj are split here so one forward serves
    every arch.
    """
    L = cfg.num_layers
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = "model."

    def stack(fmt, transpose=True):
        return _stack(ws, fmt, L, dtype, device, transpose)

    def lin_stack(names_fmt, bias_fmt=None):
        out = {"w": stack(names_fmt)}
        if bias_fmt and bias_fmt.format(0) in ws:
            out["b"] = stack(bias_fmt, transpose=False)
        return out

    def one(name):
        return _get(ws, name).to(device=device, dtype=dtype)

    if cfg.arch == "phi3":
        qkv = stack(p + "layers.{}.self_attn.qkv_proj.weight")
        q_dim, kv_dim = H * D, Hkv * D
        q = {"w": qkv[:, :, :q_dim]}
        k = {"w": qkv[:, :, q_dim:q_dim + kv_dim]}
        v = {"w": qkv[:, :, q_dim + kv_dim:]}
        gate_up = stack(p + "layers.{}.mlp.gate_up_proj.weight")
        gate = {"w": gate_up[:, :, :cfg.intermediate_size]}
        up = {"w": gate_up[:, :, cfg.intermediate_size:]}
    else:
        q = lin_stack(p + "layers.{}.self_attn.q_proj.weight",
                      p + "layers.{}.self_attn.q_proj.bias")
        k = lin_stack(p + "layers.{}.self_attn.k_proj.weight",
                      p + "layers.{}.self_attn.k_proj.bias")
        v = lin_stack(p + "layers.{}.self_attn.v_proj.weight",
                      p + "layers.{}.self_attn.v_proj.bias")
        gate = lin_stack(p + "layers.{}.mlp.gate_proj.weight")
        up = lin_stack(p + "layers.{}.mlp.up_proj.weight")

    layers = {
        "q": q, "k": k, "v": v,
        "o": lin_stack(p + "layers.{}.self_attn.o_proj.weight"),
        "gate": gate, "up": up,
        "down": lin_stack(p + "layers.{}.mlp.down_proj.weight"),
        "attn_norm": stack(p + "layers.{}.input_layernorm.weight", transpose=False),
        "ffn_norm": stack(p + "layers.{}.post_attention_layernorm.weight",
                          transpose=False),
    }
    embed = one(p + "embed_tokens.weight")
    if cfg.tie_word_embeddings or "lm_head.weight" not in ws:
        lm_head = embed.t()    # a view: the tied head shares the table
    else:
        lm_head = one("lm_head.weight").t().contiguous()
    cos, sin = rope_cache(cfg, rope_cache_len)
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": one(p + "norm.weight"),
        "lm_head": lm_head,
        "rope_cos": torch.from_numpy(cos).to(device),
        "rope_sin": torch.from_numpy(sin).to(device),
    }


def rope_cache(cfg: DecoderConfig, length: Optional[int] = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """Precompute f32 cos/sin tables [length, D], honoring llama3 and
    phi3-longrope scaling (numpy, as in the JAX package)."""
    length = length or cfg.max_seq_len
    D = cfg.head_dim
    attn_factor = 1.0
    if cfg.longrope_short_factor is not None:
        orig = cfg.original_max_seq_len or cfg.max_seq_len
        factors = np.asarray(
            cfg.longrope_long_factor if length > orig else cfg.longrope_short_factor,
            dtype=np.float64)
        inv = base_inv_freq(D, cfg.rope_theta).astype(np.float64) / factors
        scale = length / orig if orig else 1.0
        if scale > 1.0:
            attn_factor = float(np.sqrt(1.0 + np.log(scale) / np.log(orig)))
    elif cfg.rope_scaling is not None:
        inv = llama3_inv_freq(D, cfg.rope_theta, cfg.rope_scaling).astype(np.float64)
    else:
        inv = base_inv_freq(D, cfg.rope_theta).astype(np.float64)
    pos = np.arange(length, dtype=np.float64)
    angles = np.outer(pos, inv)
    cos = np.concatenate([np.cos(angles), np.cos(angles)], axis=-1) * attn_factor
    sin = np.concatenate([np.sin(angles), np.sin(angles)], axis=-1) * attn_factor
    return cos.astype(np.float32), sin.astype(np.float32)


# ---------------------------------------------------------------------------
# int4 weights
# ---------------------------------------------------------------------------

def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[..., K, N] int8 in [-8, 7] -> [..., K/2, N] int8, two nibbles per byte.

    HALF-SPLIT: row k in the low nibble, row k + K/2 in the high nibble, as in
    the JAX package (ops/kernels/int4_matvec.py unpacks it). K must be even.
    """
    K2 = q.shape[-2] // 2
    lo = (q[..., :K2, :] & 0xF).to(torch.uint8)
    hi = (q[..., K2:, :] & 0xF).to(torch.uint8)
    return ((hi << 4) | lo).view(torch.int8)


def _quant_int4(w: torch.Tensor, group_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    # row-major f32: a transposed view (the tied head is embed.t()) would pass
    # its layout on to w4, which the kernel reads row by row
    w32 = w.float().contiguous()
    K, N = w32.shape[-2], w32.shape[-1]
    # half-split packing needs an even group count (each half scales with
    # its own contiguous groups); otherwise one scale per column
    g = group_size if K % (2 * group_size) == 0 else K
    G = K // g
    wg = w32.reshape(*w32.shape[:-2], G, g, N)
    absmax = wg.abs().amax(dim=-2).clamp_min(1e-8)          # [..., G, N]
    scale = absmax / 7.0
    q = torch.clamp(torch.round(wg / scale[..., None, :]), -8, 7)
    return pack_int4(q.reshape(w32.shape).to(torch.int8)), scale


def _quantize_params(params: dict, quant, key: str) -> dict:
    """Every projection and the lm_head as {key: quantized, "scale": f32} by
    `quant(w) -> (quantized, scale)`, on the params' own device, one layer
    at a time."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        entry = dict(layers[name])
        w = entry.pop("w")
        parts = [quant(w[i]) for i in range(w.shape[0])]
        entry[key] = torch.stack([p[0] for p in parts])
        entry["scale"] = torch.stack([p[1] for p in parts])
        layers[name] = entry
    out["layers"] = layers
    w, scale = quant(params["lm_head"])
    out["lm_head"] = {key: w, "scale": scale}
    return out


def quantize_params_int4(params: dict, group_size: int = 128) -> dict:
    """Group-wise int4 weight-only quantization of every projection and the
    lm_head ({"w4": [.., K/2, N] int8, "scale": [.., K/g, N] f32}). Same
    arithmetic as the JAX package's quantize_params_int4, so both give the
    same w4 and scales."""
    return _quantize_params(params, lambda w: _quant_int4(w, group_size), "w4")


def _quant_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., K, N] -> (int8 [..., K, N], f32 scale [..., N]): per output
    channel absmax / 127, rounded half to even, as the JAX package's
    quantize_params_int8."""
    w32 = w.float().contiguous()
    scale = w32.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(-2)


def quantize_params_int8(params: dict) -> dict:
    """Per-output-channel int8 weight-only quantization of every projection
    and the lm_head ({"w": int8 [.., K, N], "scale": [.., N] f32});
    embeddings and norms keep their dtype."""
    return _quantize_params(params, _quant_int8, "w")


def _mm(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Linear apply over a param dict. The "w4" branch is the int4 kernel
    (ops/kernels/int4_matvec.py) for decode and prefill alike. An int8 "w"
    is converted to x's dtype and the product scaled per column, as the JAX
    package computes it (plain XLA there, no Pallas kernel): torch writes
    the converted weight out on every call, where XLA fuses the convert."""
    if "w4" in p:
        lead = x.shape[:-1]
        y = int4_matvec(x.reshape(-1, x.shape[-1]), p["w4"], p["scale"])
        y = y.reshape(*lead, y.shape[-1])
    elif p["w"].dtype == torch.int8:
        y = (x @ p["w"].to(x.dtype)) * p["scale"].to(x.dtype)
    else:
        y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def _row_mm(x: torch.Tensor, p: dict, tp) -> torch.Tensor:
    """A row-parallel linear (o, down): each rank's partial product over its
    slice of K, summed over the tp group (parallel/comm.py), its bias added
    once after the sum. With no group, _mm."""
    if tp is None:
        return _mm(x, p)
    y = tp.reduce_out(_mm(x, {k: v for k, v in p.items() if k != "b"}))
    return y + p["b"] if "b" in p else y


def _width(p) -> int:
    """The output width of a linear: a [K, N] tensor or a param dict."""
    if not isinstance(p, dict):
        return p.shape[-1]
    return (p["w4"] if "w4" in p else p["w"]).shape[-1]


def _head_mm(x: torch.Tensor, head, cfg: DecoderConfig, tp=None) -> torch.Tensor:
    """lm-head projection, on the host when the plan offloads it. A
    column-parallel head's logits are gathered over the tp group; a head
    replicated there (a vocabulary that does not divide tp) needs none."""
    sharded = tp is not None and _width(head) != cfg.vocab_size
    if sharded:
        x = tp.copy_in(x)
    if isinstance(head, dict):
        y = _mm(x, head)
    else:
        y = host_matmul(x, head) if cfg.lm_head_on_host else x @ head
    return tp.gather_out(y, dim=-1) if sharded else y


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: DecoderConfig, batch: int, max_len: int,
               dtype=torch.float32, device: torch.device | str = "cpu",
               quantized: bool = False):
    """Fixed-shape KV cache [L, B, Hkv, T, D], written in place. quantized:
    int8 K/V with one f32 scale per (head, position), {"q", "s"} dicts."""
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    if not quantized:
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))
    return tuple({"q": torch.zeros(shape, dtype=torch.int8, device=device),
                  "s": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
                 for _ in range(2))


def cache_slots(cache) -> int:
    """T of a cache [L, B, H, T, D] or of one layer's [B, H, T, D], in
    either form."""
    c = cache["q"] if isinstance(cache, dict) else cache
    return c.shape[-2]


def _cache_write(cache, new: torch.Tensor, pos_start) -> None:
    """Write [B, H, S, D] into one layer's cache [B, H, T, D] at pos_start.
    XLA's dynamic_update_slice would clamp the start so the update fits; a
    write past T here is a caller error and is refused. The int8 cache takes
    absmax / 127 per (head, position), computed in new's dtype, as the JAX
    package's _cache_write.

    pos_start may be a [B] tensor when S = 1: row b writes its slot
    pos_start[b] of its own row (per-row decode). Checking that range would
    cost a device sync per layer, so the caller keeps it in [0, T)."""
    if isinstance(cache, dict):
        scale = new.abs().amax(dim=-1).clamp_min(1e-6) / 127.0
        q = torch.clamp(torch.round(new / scale[..., None]), -127, 127)
        leaves = ((cache["q"], q), (cache["s"], scale))
    else:
        leaves = ((cache, new),)
    if torch.is_tensor(pos_start):
        rows = torch.arange(new.shape[0], device=new.device)
        for c, v in leaves:
            c[rows, :, pos_start] = v[:, :, 0].to(c.dtype)
        return
    S, T = new.shape[2], cache_slots(cache)
    if pos_start < 0 or pos_start + S > T:
        raise GenerationError(
            f"KV cache write of {S} positions at {pos_start} exceeds its "
            f"{T} slots")
    for c, v in leaves:
        c[:, :, pos_start:pos_start + S].copy_(v)


def _cache_read(cache, n: int, dtype: torch.dtype) -> torch.Tensor:
    """One layer's first n slots [B, H, n, D] in `dtype`: a view of the plain
    cache, or the int8 cache dequantized (q * s, both cast to dtype first)."""
    if not isinstance(cache, dict):
        return cache[:, :, :n]
    return cache["q"][:, :, :n].to(dtype) * cache["s"][:, :, :n, None].to(dtype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def causal_bias(pos_start, S: int, T: int, device,
                window: Optional[int] = None) -> torch.Tensor:
    """Additive causal bias over T cache slots: query slot i sees kv slots
    j <= i (and j > i - window under a sliding window). [1, 1, S, T] for an
    int pos_start; [B, 1, 1, T] for a per-row [B] tensor (S = 1)."""
    kj = torch.arange(T, device=device)[None, :]
    if torch.is_tensor(pos_start):
        qi = pos_start.to(device)[:, None]                        # [B, 1]
    else:
        qi = pos_start + torch.arange(S, device=device)[:, None]  # [S, 1]
    keep = kj <= qi
    if window:
        keep = keep & (kj > qi - window)
    bias = torch.where(keep, 0.0, NEG_INF)
    return bias[:, None, None] if torch.is_tensor(pos_start) else bias[None, None]


def layer_params(layers: dict, i: int) -> dict:
    """Layer i's views of the stacked layer params."""
    return {n: ({k: t[i] for k, t in e.items()} if isinstance(e, dict) else e[i])
            for n, e in layers.items()}


def decoder_layer(lp: dict, cfg: DecoderConfig, x: torch.Tensor, cos, sin,
                  attend, tp=None) -> torch.Tensor:
    """One pre-norm layer over x [B, S, hidden]: q, k, v [B, heads, S, D]
    with RoPE from (cos, sin), `attend(q, k, v) -> ctx [B, H, S, D]` (which
    writes and reads the caller's cache, or changes layout around the
    attention), o, then the SwiGLU MLP. The head counts are the projections'
    widths: this rank's heads under tensor parallelism, whose tp group sums
    o's and down's partial products (under autograd, the gradients of
    the normed inputs of q, k, v, gate and up too)."""
    B, S, _ = x.shape
    D = cfg.head_dim
    hn = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
    if tp is not None:
        hn = tp.copy_in(hn)
    q, k, v = (_mm(hn, lp[n]).reshape(B, S, -1, D).transpose(1, 2)
               for n in ("q", "k", "v"))
    q, k = apply_rope(q, k, cos, sin)
    x = x + _row_mm(merge_heads(attend(q, k, v)), lp["o"], tp)
    hn = rms_norm(x, lp["ffn_norm"], cfg.rms_norm_eps)
    if tp is not None:
        hn = tp.copy_in(hn)
    return x + _row_mm(F.silu(_mm(hn, lp["gate"])) * _mm(hn, lp["up"]), lp["down"], tp)


def _run_stack(params: dict, cfg: DecoderConfig, ids: torch.Tensor,
               cache_k, cache_v, pos_start: int, use_flash: bool = False,
               positions: Optional[torch.Tensor] = None,
               pad_mask: Optional[torch.Tensor] = None,
               kv_bucket: Optional[int] = None, tp=None) -> torch.Tensor:
    """Embed -> layer loop -> final norm, shared by prefill and decode.

    `use_flash` routes attention through the flash kernel: from-zero
    prefills attend the fresh K/V block, cache-reuse prefills (pos_start > 0)
    the first `kv_bucket` cache slots at q_offset = pos_start (dequantized
    into act dtype first when the cache is int8).

    Batched generation over ragged prompts passes `positions` [B, S] (each
    row's RoPE positions under left padding; cache slots stay shared) and
    `pad_mask` [B, T] (1 = a real kv slot), added to the causal bias.

    Per-row decode (the continuous engine's slots, each at its own position)
    passes pos_start as a [B] tensor with S = 1: row b takes RoPE at
    pos_start[b], writes its K/V at that slot of its own cache row and
    attends kv slots j <= pos_start[b]. This is the JAX engine's vmap of the
    B = 1 forward over the slot axis, as one batched forward.

    `tp`: the tensor-parallel group's Comm, when params are this rank's shard.

    With no cache (cache_k None, pos_start 0) each layer attends its own
    fresh K/V under the causal bias: the same numbers as a cache of S slots
    written from 0, with no in-place write, so autograd can run through it
    (the training step, parallel/train.py).
    """
    B, S = ids.shape
    T = S if cache_k is None else cache_slots(cache_k)
    per_row = torch.is_tensor(pos_start)
    if per_row and (S != 1 or use_flash or pos_start.shape != (B,)):
        raise GenerationError("a per-row decode position takes one token per row "
                              "and the plain attention")
    pos_start = pos_start if per_row else int(pos_start)
    with profiling.annotate("kjarni.forward"):
        x = (host_gather(params["embed"], ids) if cfg.embed_on_host
             else F.embedding(ids, params["embed"]))
        if per_row:     # per-row tables [B, 1, 1, D]
            cos = params["rope_cos"][pos_start][:, None, None]
            sin = params["rope_sin"][pos_start][:, None, None]
        elif positions is None:
            cos = params["rope_cos"][pos_start:pos_start + S]
            sin = params["rope_sin"][pos_start:pos_start + S]
        else:   # per-row tables [B, 1, S, D]
            cos = params["rope_cos"][positions][:, None]
            sin = params["rope_sin"][positions][:, None]
        if tp is not None:  # the tables are used inside each rank's heads
            cos, sin = tp.copy_in(cos), tp.copy_in(sin)

        bias = None
        if not use_flash:
            bias = causal_bias(pos_start, S, T, ids.device, cfg.sliding_window)
            if pad_mask is not None:
                bias = bias + torch.where(pad_mask.bool(), 0.0,
                                          NEG_INF)[:, None, None, :]   # [B, 1, S, T]

        def layer(cache, i):
            if cache is None:
                return None
            return ({n: t[i] for n, t in cache.items()} if isinstance(cache, dict)
                    else cache[i])

        def attend(kc, vc, q, k, v):
            if kc is None:
                return attention(q, k, v, bias)
            _cache_write(kc, k, pos_start)
            _cache_write(vc, v, pos_start)
            if not use_flash:
                return attention(q, _cache_read(kc, T, x.dtype), _cache_read(vc, T, x.dtype),
                                 bias)
            kb = kv_bucket if kv_bucket is not None else S
            if kb <= S:
                # from-zero prefill: the fresh block is the whole valid cache
                return flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
            return flash_attention(q, _cache_read(kc, kb, x.dtype),
                                   _cache_read(vc, kb, x.dtype), causal=True,
                                   window=cfg.sliding_window, q_offset=pos_start,
                                   kv_len=pos_start + S)

        for i in range(cfg.num_layers):
            x = decoder_layer(layer_params(params["layers"], i), cfg, x, cos, sin,
                              functools.partial(attend, layer(cache_k, i), layer(cache_v, i)),
                              tp)
        return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def forward(params: dict, cfg: DecoderConfig, ids: torch.Tensor,
            cache_k, cache_v, pos_start: int,
            last_idx: Optional[int] = None, use_flash: bool = False,
            positions: Optional[torch.Tensor] = None,
            pad_mask: Optional[torch.Tensor] = None,
            kv_bucket: Optional[int] = None, tp=None):
    """One decoder pass, shared by prefill and decode.

    ids: [B, S] tokens at cache slots pos_start + arange(S). Their K/V
    are written into the cache in place; queries attend causally over
    cache[0 .. pos_start+S). Returns (logits [B, V] at `last_idx` (default
    S-1), cache_k, cache_v), the caches being the same objects that were
    passed. `tp`: the tensor-parallel group's Comm (module docstring).
    """
    x = _run_stack(params, cfg, ids, cache_k, cache_v, pos_start, use_flash,
                   positions, pad_mask, kv_bucket, tp)
    if last_idx is None:
        last_idx = ids.shape[1] - 1
    logits = _head_mm(x[:, int(last_idx)], params["lm_head"], cfg, tp)
    return logits, cache_k, cache_v


def forward_all_logits(params: dict, cfg: DecoderConfig, ids: torch.Tensor,
                       cache_k: torch.Tensor, cache_v: torch.Tensor, pos_start: int,
                       tp=None):
    """Like forward() but returns logits at every position."""
    x = _run_stack(params, cfg, ids, cache_k, cache_v, pos_start, tp=tp)
    return _head_mm(x, params["lm_head"], cfg, tp), cache_k, cache_v


def forward_hidden(params: dict, cfg: DecoderConfig, ids: torch.Tensor,
                   cache_k, cache_v, pos_start, use_flash: bool = False,
                   positions: Optional[torch.Tensor] = None,
                   pad_mask: Optional[torch.Tensor] = None,
                   kv_bucket: Optional[int] = None, tp=None) -> torch.Tensor:
    """The stack without the lm-head: final-norm hidden states [B, S, H] at
    every position, so a caller projects only the rows it needs (batched
    admission takes one hidden row per lane before head_logits)."""
    return _run_stack(params, cfg, ids, cache_k, cache_v, pos_start, use_flash,
                      positions, pad_mask, kv_bucket, tp)


def head_logits(params: dict, cfg: DecoderConfig, x: torch.Tensor,
                tp=None) -> torch.Tensor:
    """lm-head projection of gathered hidden rows."""
    return _head_mm(x, params["lm_head"], cfg, tp)
