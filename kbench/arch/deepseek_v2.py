"""DeepSeek-V2 (`deepseek_v2` `config.json`s; DeepSeek-V2-Lite's published
`modeling_deepseek.py`): multi-head latent attention, YaRN rope, a leading
dense SwiGLU layer, then routed and shared experts.

The reference forward, written from the published model code in its
expanded (published) form, with no cache or batching:

- per layer, RMSNorm, then attention: q = h W_q split per head into q_nope
  and q_pe; [c_kv | k_pe] = h W_kv_a, c_kv normed (kv_a_layernorm);
  [k_nope | v] = c_kv W_kv_b per head; q_pe and the one k_pe shared by all
  heads rotated after the published interleave (each vector viewed as
  (d/2, 2) and transposed, then rotate-half); causal softmax of
  [q_nope | q_pe] . [k_nope | k_pe] scaled by (dn + dr)^-0.5 m^2,
  m = 0.1 mscale_all_dim ln(factor) + 1; o_proj;
- RMSNorm, then the MLP: a SwiGLU of `intermediate_size` in the first
  `first_k_dense_replace` layers; after them the router's f32 softmax over
  the experts, its greedy top-k (renormalised only under norm_topk_prob,
  else times routed_scaling_factor), each chosen expert's SwiGLU weighted
  and summed, plus the shared experts' SwiGLU (n_shared_experts x
  moe_intermediate_size wide);
- the final norm and the head.

YaRN as `DeepseekV2YarnRotaryEmbedding`: inv_freq blends 1/theta^(2i/d) and
1/(factor theta^(2i/d)) by the linear ramp between the correction dims of
beta_fast and beta_slow at original_max_position_embeddings; cos and sin
scaled by mscale(factor, mscale) / mscale(factor, mscale_all_dim). Angles
in f64 (the published code: f32), as the llama reference computes them.

Departures: attention runs per sequence in blocks of query rows and the
experts in a loop over the experts, each over the rows routed to it; the
bf16 weights are drawn once and turned to f32 one layer at a time, so the
whole model never lies in f32 (63 GB for DeepSeek-V2-Lite). The router's
product is f32 under the fp8 control too, as the published model computes it
in f32 whatever the precision of the rest.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from kbench.reference.decoder import linear, rms_norm, weight
from kbench.weights import Kind, draw

MODEL_TYPES = ("deepseek_v2",)
ATTN_ROWS = 1024          # query rows per attention block
PROJ = ("gate_proj", "up_proj", "down_proj")


def _dims(cfg: dict) -> tuple[int, int, int, int, int]:
    """(H, dn, dr, dv, R)."""
    return (cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
            cfg["v_head_dim"], cfg["kv_lora_rank"])


def _swiglu_shapes(hid: int, inter: int) -> dict:
    return {"gate_proj": (inter, hid), "up_proj": (inter, hid), "down_proj": (hid, inter)}


def kinds(cfg: dict) -> dict:
    """Every kind of tensor of the published checkpoint: the attention and
    norms in every layer, the dense MLP in layers (0, first_k_dense_replace),
    the router, shared experts and n_routed_experts experts in the others."""
    hid, V, L = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    H, dn, dr, dv, R = _dims(cfg)
    k0, E, inter = cfg["first_k_dense_replace"], cfg["n_routed_experts"], \
        cfg["moe_intermediate_size"]
    p, dense, sparse = "model.layers.{}.", (0, k0), (k0, L)
    out = {"model.embed_tokens.weight": Kind((V, hid), False),
           "model.norm.weight": Kind((hid,), True),
           p + "input_layernorm.weight": Kind((hid,), True),
           p + "post_attention_layernorm.weight": Kind((hid,), True),
           p + "self_attn.q_proj.weight": Kind((H * (dn + dr), hid), False),
           p + "self_attn.kv_a_proj_with_mqa.weight": Kind((R + dr, hid), False),
           p + "self_attn.kv_a_layernorm.weight": Kind((R,), True),
           p + "self_attn.kv_b_proj.weight": Kind((H * (dn + dv), R), False),
           p + "self_attn.o_proj.weight": Kind((hid, H * dv), False)}
    if not cfg.get("tie_word_embeddings", False):
        out["lm_head.weight"] = Kind((V, hid), False)
    if k0:
        for n, shape in _swiglu_shapes(hid, cfg["intermediate_size"]).items():
            out[p + f"mlp.{n}.weight"] = Kind(shape, False, dense)
    if k0 < L:
        out[p + "mlp.gate.weight"] = Kind((E, hid), False, sparse)
        shared = _swiglu_shapes(hid, inter * cfg["n_shared_experts"])
        for n, shape in _swiglu_shapes(hid, inter).items():
            out[p + f"mlp.shared_experts.{n}.weight"] = Kind(shared[n], False, sparse)
            out[p + f"mlp.experts.{{}}.{n}.weight"] = Kind(shape, False, sparse, E)
    return out


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def inv_freq(cfg: dict) -> torch.Tensor:
    """[dr / 2] f64: `yarn_find_correction_range`, `yarn_linear_ramp_mask`
    and the blend of the published YaRN embedding; plain rope without
    rope_scaling."""
    d, base = cfg["qk_rope_head_dim"], float(cfg.get("rope_theta", 10000.0))
    extra = 1.0 / base ** (torch.arange(0, d, 2, dtype=torch.float64) / d)
    rs = cfg.get("rope_scaling")
    if not rs:
        return extra
    if rs.get("type", rs.get("rope_type")) != "yarn":
        raise NotImplementedError(f"reference rope type {rs!r}")
    orig = rs["original_max_position_embeddings"]

    def dim_of(rotations):
        return d * math.log(orig / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(dim_of(rs["beta_fast"])), 0)
    high = min(math.ceil(dim_of(rs["beta_slow"])), d - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float64) - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return extra / rs["factor"] * (1 - mask) + extra * mask


def rope_tables(cfg: dict, length: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 cos / sin [length, dr] of one sequence."""
    rs = cfg.get("rope_scaling") or {}
    scale = 1.0
    if rs:
        scale = yarn_mscale(rs["factor"], rs["mscale"]) / \
            yarn_mscale(rs["factor"], rs["mscale_all_dim"])
    ang = torch.arange(length, dtype=torch.float64)[:, None] * inv_freq(cfg)[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return (ang.cos() * scale).float().to(device), (ang.sin() * scale).float().to(device)


def softmax_scale(cfg: dict) -> float:
    s = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling") or {}
    if rs.get("mscale_all_dim"):
        s *= yarn_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return s


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The published `apply_rotary_pos_emb` of x [..., S, d]: interleave,
    then rotate-half."""
    d = x.shape[-1]
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal attention of one sequence: q, k [H, S, dn + dr], v [H, S, dv]
    -> [S, H dv], in blocks of query rows."""
    H, S, _ = q.shape
    out = torch.empty(S, H, v.shape[-1], dtype=q.dtype, device=q.device)
    kj = torch.arange(S, device=q.device)
    for r0 in range(0, S, ATTN_ROWS):
        r1 = min(S, r0 + ATTN_ROWS)
        scores = (q[:, r0:r1] @ k[:, :r1].transpose(1, 2)) * scale
        keep = kj[None, :r1] <= torch.arange(r0, r1, device=q.device)[:, None]
        scores = scores.masked_fill(~keep, float("-inf"))
        out[r0:r1] = (torch.softmax(scores, dim=-1) @ v[:, :r1]).transpose(0, 1)
    return out.reshape(S, -1)


def _swiglu(h, w, precision):
    act = torch.nn.functional.silu(linear(h, w["gate_proj"], precision)) * \
        linear(h, w["up_proj"], precision)
    return linear(act, w["down_proj"], precision)


def _moe(h: torch.Tensor, cfg: dict, router: torch.Tensor, experts: dict, shared: dict,
         quant, precision) -> torch.Tensor:
    """The published DeepseekV2MoE over h [n, hid]: the router in f32, its
    greedy top-k, each expert over its rows, plus the shared experts."""
    k = cfg["num_experts_per_tok"]
    scores = torch.softmax(h @ router.float().t(), dim=-1)
    top, chosen = torch.topk(scores, k, dim=-1)
    if k > 1 and cfg.get("norm_topk_prob", False):
        top = top / (top.sum(dim=-1, keepdim=True) + 1e-20)
    else:
        top = top * cfg.get("routed_scaling_factor", 1.0)
    out = torch.zeros_like(h)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (chosen == e).nonzero(as_tuple=True)
        if len(tok):
            w = {n: weight(experts[n][e], quant, precision) for n in PROJ}
            out.index_add_(0, tok, _swiglu(h[tok], w, precision) * top[tok, slot, None])
    return out + _swiglu(h, shared, precision)


def logits_at(cfg: dict, seed: int, seqs: list, rows: list, device, *,
              quant: Optional[str], precision: str) -> list:
    """The f32 logits of each sequence at the given rows (the contract of
    `kbench/reference/decoder.py::logits_at`)."""
    H, dn, dr, dv, R = _dims(cfg)
    eps = cfg.get("rms_norm_eps", 1e-6)
    k0 = cfg["first_k_dense_replace"]
    scale = softmax_scale(cfg)
    layout = kinds(cfg)
    lens = [len(s) for s in seqs]
    starts = [sum(lens[:j]) for j in range(len(seqs))]
    ids = torch.tensor([t for s in seqs for t in s], dtype=torch.long, device=device)
    x = draw(cfg, seed, "model.embed_tokens.weight", device, layout=layout)[ids].float()
    tables = [rope_tables(cfg, n, device) for n in lens]
    stacks = {p: draw(cfg, seed, p, device, layout=layout) for p in layout if "{}" in p}
    p = "model.layers.{}."

    def w(name, i):
        return weight(stacks[p + name][i], quant, precision)

    for i in range(cfg["num_hidden_layers"]):
        h = rms_norm(x, stacks[p + "input_layernorm.weight"][i], eps)
        q = linear(h, w("self_attn.q_proj.weight", i), precision)
        ckv = linear(h, w("self_attn.kv_a_proj_with_mqa.weight", i), precision)
        c = rms_norm(ckv[:, :R], stacks[p + "self_attn.kv_a_layernorm.weight"][i], eps)
        kv = linear(c, w("self_attn.kv_b_proj.weight", i), precision)
        ctx = torch.empty(x.shape[0], H * dv, dtype=x.dtype, device=device)
        for j, (s0, n) in enumerate(zip(starts, lens)):
            cos, sin = tables[j]
            qj = q[s0:s0 + n].reshape(n, H, dn + dr).transpose(0, 1)
            kvj = kv[s0:s0 + n].reshape(n, H, dn + dv).transpose(0, 1)
            k_pe = _rope(ckv[s0:s0 + n, R:][None], cos, sin).expand(H, n, dr)
            qs = torch.cat([qj[..., :dn], _rope(qj[..., dn:], cos, sin)], dim=-1)
            ks = torch.cat([kvj[..., :dn], k_pe], dim=-1)
            ctx[s0:s0 + n] = _attend(qs, ks, kvj[..., dn:], scale)
        x = x + linear(ctx, w("self_attn.o_proj.weight", i), precision)
        h = rms_norm(x, stacks[p + "post_attention_layernorm.weight"][i], eps)
        if i < k0:
            dense = {n: w(f"mlp.{n}.weight", i) for n in PROJ}
            x = x + _swiglu(h, dense, precision)
        else:
            j = i - k0
            experts = {n: stacks[p + f"mlp.experts.{{}}.{n}.weight"][j] for n in PROJ}
            shared = {n: w(f"mlp.shared_experts.{n}.weight", j) for n in PROJ}
            x = x + _moe(h, cfg, stacks[p + "mlp.gate.weight"][j], experts, shared,
                         quant, precision)
        del h, q, ckv, c, kv, ctx
    del stacks
    sel = torch.tensor([s0 + r for s0, rr in zip(starts, rows) for r in rr],
                       dtype=torch.long, device=device)
    hn = rms_norm(x[sel], draw(cfg, seed, "model.norm.weight", device, layout=layout), eps)
    head_name = "model.embed_tokens.weight" if cfg.get("tie_word_embeddings", False) \
        else "lm_head.weight"
    head = weight(draw(cfg, seed, head_name, device, layout=layout), quant, precision)
    return list(linear(hn, head, precision).split([len(rr) for rr in rows]))


def useful_flops(cfg: dict, prompt: int, new_tokens: int) -> float:
    """Model operations of one request with no padding, of the published
    (expanded) model whatever route the program takes: each token's
    projections (q, kv_a, kv_b, o; the dense MLP, or the router, its k
    experts and the shared experts), each (query, key) pair's H (dn + dr)
    scores and H dv weighted values, and the head where a token is sampled
    (once for the prompt, then once a decoded token). A request that returns
    n tokens runs n - 1 decode forwards after its prefill."""
    hid, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, dn, dr, dv, R = _dims(cfg)
    k0, E, k = cfg["first_k_dense_replace"], cfg["n_routed_experts"], \
        cfg["num_experts_per_tok"]
    inter = cfg["moe_intermediate_size"]
    attn_w = hid * H * (dn + dr) + hid * (R + dr) + R * H * (dn + dv) + H * dv * hid
    dense_w = 3 * hid * cfg["intermediate_size"]
    moe_w = hid * E + k * 3 * hid * inter + 3 * hid * inter * cfg["n_shared_experts"]
    layers_w = L * attn_w + k0 * dense_w + (L - k0) * moe_w
    head_w = hid * cfg["vocab_size"]
    per_pair = 2.0 * H * (dn + dr + dv) * L
    flops = 2.0 * layers_w * prompt + per_pair * prompt * (prompt + 1) / 2 + 2.0 * head_w
    for j in range(1, new_tokens):
        flops += 2.0 * (layers_w + head_w) + per_pair * (prompt + j)
    return flops
