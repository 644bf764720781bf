"""Seeded weights for the benchmark's models, made on the device.

Every tensor has the name and shape of the published Hugging Face checkpoint.
The tensors of one kind over every layer (`model.layers.{}.mlp.gate_proj.weight`
for all L layers) are drawn together, in one call of a `torch.Generator` on the
device seeded from (the run's seed, the kind's name pattern), in bf16, the type
they are served in. So a model is a dozen large draws, and the reference
(`kbench/reference/`) draws any kind again by itself from the seed alone.

Projections and embeddings are N(0, 0.02) (the published `initializer_range`);
RMSNorm weights are 1 + N(0, 0.1), so that a norm the program dropped or
misapplied shows in its outputs.

`SeededWeights` is the one seam between the harness and the program: it stands
in for `weights/safetensors_loader.ModelWeights` while `DecoderLM` is built,
with the same `__contains__`, `get`, `get_f32` and `has_any`.
"""

from __future__ import annotations

import hashlib
import re

import torch

PROJ_STD = 0.02
NORM_STD = 0.1
_LAYER = re.compile(r"^model\.layers\.(\d+)\.(.+)$")


def kind_seed(seed: int, pattern: str) -> int:
    """A 63-bit generator seed for one kind of tensor of one run."""
    digest = hashlib.sha256(f"{int(seed)}:{pattern}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


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
    elif cfg["model_type"] in ("llama", "mistral"):
        out[p + "self_attn.q_proj.weight"] = ((H * D, hid), False)
        out[p + "self_attn.k_proj.weight"] = ((Hkv * D, hid), False)
        out[p + "self_attn.v_proj.weight"] = ((Hkv * D, hid), False)
        out[p + "mlp.gate_proj.weight"] = ((inter, hid), False)
        out[p + "mlp.up_proj.weight"] = ((inter, hid), False)
    else:
        raise ValueError(f"no weight layout for model_type {cfg['model_type']!r}")
    return out


def draw(cfg: dict, seed: int, pattern: str, device) -> torch.Tensor:
    """One kind of tensor in bf16 on `device`: [L, *shape] for a per-layer
    pattern, else [*shape]. The same (cfg, seed, pattern, device type) gives
    the same bits."""
    shape, is_norm = kinds(cfg)[pattern]
    if "{}" in pattern:
        shape = (cfg["num_hidden_layers"], *shape)
    g = torch.Generator(device=device).manual_seed(kind_seed(seed, pattern))
    t = torch.randn(shape, generator=g, device=device, dtype=torch.bfloat16)
    return t.mul_(NORM_STD).add_(1.0) if is_norm else t.mul_(PROJ_STD)


def split_name(name: str) -> tuple[str, int | None]:
    """A tensor name -> (its kind's pattern, its layer or None)."""
    m = _LAYER.match(name)
    if m is None:
        return name, None
    return "model.layers.{}." + m.group(2), int(m.group(1))


class SeededWeights:
    """An in-memory checkpoint drawn from the seed on `device`.

    Reading a tensor draws its whole kind once and keeps it until a tensor
    of another kind is read; the port's loader reads one kind over every
    layer at a time, so only one extra kind is ever held. Nothing is written
    to disk."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self._kinds = kinds(cfg)
        self._held: tuple[str, torch.Tensor] | None = None
        self.draws = 0

    def __contains__(self, name: str) -> bool:
        pattern, layer = split_name(name)
        return pattern in self._kinds and \
            (layer is None) == ("{}" not in pattern) and \
            (layer is None or layer < self.cfg["num_hidden_layers"])

    def get(self, name: str) -> torch.Tensor:
        if name not in self:
            raise KeyError(f"no tensor {name!r} in the seeded checkpoint")
        pattern, layer = split_name(name)
        if self._held is None or self._held[0] != pattern:
            self._held = None          # free the last kind before drawing
            self._held = (pattern, draw(self.cfg, self.seed, pattern, self.device))
            self.draws += 1
        t = self._held[1]
        return t if layer is None else t[layer]

    def get_f32(self, name: str):
        return self.get(name).float().cpu().numpy()

    def has_any(self, *names: str) -> bool:
        return any(n in self for n in names)

    def release(self) -> None:
        self._held = None
