"""A toy mixture-of-experts architecture, for the CPU tests of the lookup by
`model_type`: an architecture added as one file in a scratch harness root.

Layer 0 is a dense SwiGLU; each later layer routes every token to the top
`num_experts_per_tok` of `n_routed_experts` SwiGLU experts by a softmax
router, and sums their outputs weighted by the router's scores. There is no
attention, so a position's logits depend on its token alone.
"""

from __future__ import annotations

import torch

from kbench.reference.decoder import linear, rms_norm, weight
from kbench.weights import Kind, draw

MODEL_TYPES = ("toy_moe",)


def kinds(cfg: dict) -> dict:
    hid, inter, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    E, L = cfg["n_routed_experts"], cfg["num_hidden_layers"]
    p, dense, moe = "model.layers.{}.", (0, 1), (1, L)
    out = {"model.embed_tokens.weight": Kind((V, hid), False),
           "model.norm.weight": Kind((hid,), True),
           "lm_head.weight": Kind((V, hid), False),
           p + "post_attention_layernorm.weight": Kind((hid,), True),
           p + "mlp.gate.weight": Kind((E, hid), False, moe)}
    for name, shape in (("gate_proj", (inter, hid)), ("up_proj", (inter, hid)),
                        ("down_proj", (hid, inter))):
        out[p + f"mlp.{name}.weight"] = Kind(shape, False, dense)
        out[p + f"mlp.experts.{{}}.{name}.weight"] = Kind(shape, False, moe, E)
    return out


def _swiglu(h, gate, up, down, quant, precision):
    def w(t):
        return weight(t, quant, precision)
    act = torch.nn.functional.silu(linear(h, w(gate), precision)) * linear(h, w(up), precision)
    return linear(act, w(down), precision)


def logits_at(cfg: dict, seed: int, seqs: list, rows: list, device, *, quant, precision):
    layout = kinds(cfg)

    def get(pattern):
        return draw(cfg, seed, pattern, device, layout=layout)

    p, eps, k = "model.layers.{}.", cfg["rms_norm_eps"], cfg["num_experts_per_tok"]
    ids = torch.tensor([s[r] for s, rr in zip(seqs, rows) for r in rr], device=device)
    x = get("model.embed_tokens.weight")[ids].float()
    norms = get(p + "post_attention_layernorm.weight")
    mlp = {n: get(p + f"mlp.{n}.weight") for n in ("gate_proj", "up_proj", "down_proj")}
    experts = {n: get(p + f"mlp.experts.{{}}.{n}.weight")
               for n in ("gate_proj", "up_proj", "down_proj")}
    router = get(p + "mlp.gate.weight")
    for i in range(cfg["num_hidden_layers"]):
        h = rms_norm(x, norms[i], eps)
        if i == 0:
            x = x + _swiglu(h, *(mlp[n][0] for n in mlp), quant, precision)
            continue
        scores = torch.softmax(linear(h, weight(router[i - 1], None, precision), precision), -1)
        top, chosen = scores.topk(k, dim=-1)
        out = torch.zeros_like(x)
        for e in range(cfg["n_routed_experts"]):
            tok, slot = (chosen == e).nonzero(as_tuple=True)
            if len(tok):
                y = _swiglu(h[tok], *(experts[n][i - 1, e] for n in experts), quant, precision)
                out.index_add_(0, tok, y * top[tok, slot, None])
        x = x + out
    logits = linear(rms_norm(x, get("model.norm.weight"), eps),
                    weight(get("lm_head.weight"), quant, precision), precision)
    return list(logits.split([len(rr) for rr in rows]))


def useful_flops(cfg: dict, prompt: int, new_tokens: int) -> float:
    hid, inter, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    L, E, k = cfg["num_hidden_layers"], cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    per_token = 3 * hid * inter + (L - 1) * (hid * E + k * 3 * hid * inter)
    return 2.0 * (per_token * (prompt + new_tokens - 1) + hid * V * new_tokens)
