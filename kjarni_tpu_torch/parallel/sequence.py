"""Sequence parallelism (sp): the Ulysses long-context prefill (port of
kjarni_tpu/parallel/sequence.py).

Each rank holds S/sp positions of every sequence: the embedding, norms,
projections and MLP run on its own positions. For attention the layout
switches to head-sharded (each rank holds whole sequences for H/sp heads)
by one all-to-all, and back after it by another: the DeepSpeed-Ulysses
pattern, where the JAX package declares the two layouts and GSPMD inserts
the same all-to-alls. Attention is the plain one, as there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models import llama as kllama
from ..models.llama import DecoderConfig
from ..ops.attention import attention
from ..ops.norms import rms_norm
from .comm import Comm
from .mesh import Mesh


def make_sp_mesh(sp: int) -> Mesh:
    """An ("sp",) mesh over the default process group of sp ranks."""
    return Mesh({"sp": sp})


def _to_heads(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """[B, S/sp, H, D] (this rank's positions, every head) -> [B, H/sp, S, D]
    (every position, this rank's heads)."""
    B, s, H, D = x.shape
    n = comm.size
    parts = x.reshape(B, s, n, H // n, D).permute(2, 0, 1, 3, 4)   # [n, B, s, H/n, D]
    got = comm.all_to_all(parts.contiguous())                     # chunk i: rank i's positions
    return got.permute(1, 3, 0, 2, 4).reshape(B, H // n, n * s, D)


def _to_positions(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """The inverse: [B, H/sp, S, D] -> [B, H, S/sp, D]."""
    B, h, S, D = x.shape
    n = comm.size
    parts = x.reshape(B, h, n, S // n, D).permute(2, 0, 1, 3, 4)   # [n, B, h, S/n, D]
    got = comm.all_to_all(parts.contiguous())                     # chunk i: rank i's heads
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * h, S // n, D)


@torch.inference_mode()
def sequence_parallel_forward(params: dict, cfg: DecoderConfig, ids: torch.Tensor,
                              mesh: Mesh) -> torch.Tensor:
    """[B, S] ids -> [B, S, V] logits on every rank, activations split along
    S over "sp" (`params` whole on every rank). S, the heads and the KV
    heads must divide sp (ValueError): the attention layout splits heads."""
    comm, r = mesh.comm("sp"), mesh.coords["sp"]
    sp = comm.size
    B, S = ids.shape
    if S % sp or cfg.num_heads % sp or cfg.num_kv_heads % sp:
        raise ValueError(
            f"S ({S}), heads ({cfg.num_heads}) and kv heads "
            f"({cfg.num_kv_heads}) must divide sp ({sp})")
    s = S // sp
    dev = params["embed"].device
    bias = kllama.causal_bias(0, S, S, dev, cfg.sliding_window)
    # RoPE at this rank's positions, before the layout changes
    cos, sin = (params[n][r * s:(r + 1) * s] for n in ("rope_cos", "rope_sin"))

    def attend(q, k, v):
        # [B, heads, S/sp, D] -> [B, heads/sp, S, D], attention, and back
        q, k, v = (_to_heads(t.transpose(1, 2), comm) for t in (q, k, v))
        return _to_positions(attention(q, k, v, bias), comm)

    x = F.embedding(ids[:, r * s:(r + 1) * s].to(dev), params["embed"])
    for i in range(cfg.num_layers):
        x = kllama.decoder_layer(kllama.layer_params(params["layers"], i), cfg, x,
                                 cos, sin, attend)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return comm.all_gather(kllama._head_mm(x, params["lm_head"], cfg), dim=1)
