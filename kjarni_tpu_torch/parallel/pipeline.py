"""Pipeline parallelism (pp): the GPipe-staged decoder forward and the ring
decode (port of kjarni_tpu/parallel/pipeline.py).

The decoder's stacked layer params [L, ...] split over the "pp" axis on the
layer dim: rank s holds layers [s*L/pp, (s+1)*L/pp). The batch splits into
micro-batches, and activations go from stage to stage by the group's ring
shift (parallel/comm.py, isend/irecv pairs): JAX's `ppermute` inside its
`shard_map`, with the same (pp-1)-step fill and drain.

  * `pipeline_forward`: a cache-free forward of full [b_micro, S] sequences;
    the last stage's logits reach every rank (JAX's `psum`, here a
    broadcast from that stage).
  * `pp_generate`: batched greedy decode with per-stage KV caches. pp
    micro-batches go round the ring, one per stage per tick; the last stage
    samples and embeds the new token, and that embedding wraps back to
    stage 0, which feeds it in exactly when that micro-batch's previous
    token has cleared the pipe.

Attention is the plain one, as in the JAX package. A ("pp", "tp") mesh with
tp > 1 computes each stage alike on its tp ranks, as the JAX functions do
(their `shard_map` splits only "pp").
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..models import llama as kllama
from ..models.llama import DecoderConfig
from ..ops.attention import attention
from ..ops.norms import rms_norm
from .mesh import Mesh


def make_pp_mesh(pp: int, tp: int = 1) -> Mesh:
    """A ("pp", "tp") mesh over the default process group: layers staged
    over pp. pp * tp must equal the world size (ValueError)."""
    return Mesh({"pp": pp, "tp": tp})


def pp_param_sharding(mesh: Mesh) -> dict:
    """Every stacked layer leaf splits its leading [L] dim over "pp"; the
    embedding, final norm, lm head and rope tables are whole on every
    stage (the first and last stages need them)."""
    stacked = ("pp", ...)
    return {"embed": (), "layers": stacked, "final_norm": (), "lm_head": (),
            "rope_cos": (), "rope_sin": ()}


def _stage(layers: dict, cfg: DecoderConfig, x: torch.Tensor, cos, sin, bias,
           cache=None, pos: int = 0) -> torch.Tensor:
    """This stage's layers over x [b, s, hidden]. With `cache` (ck, cv), each
    [L_local, b, Hkv, T, D] for one micro-batch, K/V are written at slot
    `pos` and attention reads all T slots under `bias`."""
    def attend(i, q, k, v):
        if cache is not None:
            kc, vc = cache[0][i], cache[1][i]
            kllama._cache_write(kc, k, pos)
            kllama._cache_write(vc, v, pos)
            k, v = kc.to(q.dtype), vc.to(q.dtype)
        return attention(q, k, v, bias)

    for i in range(layers["attn_norm"].shape[0]):
        x = kllama.decoder_layer(kllama.layer_params(layers, i), cfg, x, cos, sin,
                                 functools.partial(attend, i))
    return x


def _logits(params: dict, cfg: DecoderConfig, x: torch.Tensor) -> torch.Tensor:
    return kllama._head_mm(rms_norm(x, params["final_norm"], cfg.rms_norm_eps),
                           params["lm_head"], cfg)


@torch.inference_mode()
def pipeline_forward(params: dict, cfg: DecoderConfig, ids: torch.Tensor,
                     mesh: Mesh, n_micro: int) -> torch.Tensor:
    """GPipe forward: [B, S] ids -> [B, S, V] logits on every rank, layers
    staged over "pp" (`params` is this rank's shard under pp_param_sharding).
    B must split into n_micro micro-batches; n_micro >= pp keeps the bubble
    at (pp-1)/(n_micro+pp-1)."""
    comm, stage = mesh.comm("pp"), mesh.coords["pp"]
    pp = comm.size
    B, S = ids.shape
    if B % n_micro:
        raise ValueError(f"batch {B} must divide into {n_micro} microbatches")
    b = B // n_micro
    micro = ids.reshape(n_micro, b, S)
    embed = params["embed"]
    dev = embed.device
    bias = kllama.causal_bias(0, S, S, dev, cfg.sliding_window)
    cos, sin = params["rope_cos"][:S], params["rope_sin"][:S]
    carry = torch.zeros(b, S, cfg.hidden_size, dtype=embed.dtype, device=dev)
    out = torch.zeros(n_micro, b, S, cfg.vocab_size, dtype=embed.dtype, device=dev)
    for t in range(n_micro + pp - 1):
        mb = t - stage
        x = carry
        if 0 <= mb < n_micro:
            if stage == 0:
                x = F.embedding(micro[mb].to(dev), embed)
            x = _stage(params["layers"], cfg, x, cos, sin, bias)
            if stage == pp - 1:
                out[mb] = _logits(params, cfg, x)
        # stage s -> s+1; what wraps round to stage 0 is never read, since
        # stage 0 embeds its micro-batches fresh
        carry = comm.ring_shift(x)
    return comm.broadcast(out, src=pp - 1).reshape(B, S, -1)


@torch.inference_mode()
def pp_generate(params: dict, cfg: DecoderConfig, ids: torch.Tensor,
                mesh: Mesh, max_new: int) -> torch.Tensor:
    """Pipelined batched greedy decode: [B, S] prompts of one length ->
    [B, max_new] tokens on every rank, layers staged over "pp".

    B splits into exactly pp micro-batches (one in flight per stage). At
    decode tick d, stage s runs micro-batch (d - s) mod pp. Each stage's
    caches [L/pp, pp, b, Hkv, S+max_new, D] hold its own layers only.
    Greedy argmax (first index of the largest logit); no stop token: the
    whole [B, max_new] block is returned, as in the JAX package."""
    comm, stage = mesh.comm("pp"), mesh.coords["pp"]
    pp = m = comm.size
    B, S = ids.shape
    if B % m:
        raise ValueError(f"batch {B} must divide into pp={pp} microbatches")
    b = B // m
    T = S + max_new
    micro = ids.reshape(m, b, S)
    embed, layers = params["embed"], params["layers"]
    dev, dt, hid = embed.device, embed.dtype, cfg.hidden_size
    cos, sin = params["rope_cos"][:T], params["rope_sin"][:T]
    L_local = layers["attn_norm"].shape[0]
    # this stage's KV heads: the k shard's width (the whole k here)
    k_w = layers["k"]["w4"] if "w4" in layers["k"] else layers["k"]["w"]
    Hkv = k_w.shape[-1] // cfg.head_dim
    ck = torch.zeros(L_local, m, b, Hkv, T, cfg.head_dim, dtype=dt, device=dev)
    cv = torch.zeros_like(ck)
    first_emb = torch.zeros(m, b, hid, dtype=dt, device=dev)
    out = torch.zeros(m, max_new, b, dtype=torch.long, device=dev)

    def sample_embed(x_last):
        tok = torch.argmax(_logits(params, cfg, x_last), dim=-1)
        return tok, F.embedding(tok, embed)

    def run(x, mb, pos):
        q_pos = torch.arange(x.shape[1], device=dev) + pos
        bias = kllama.causal_bias(pos, x.shape[1], T, dev, cfg.sliding_window)
        return _stage(layers, cfg, x, cos[q_pos], sin[q_pos], bias,
                      (ck[:, mb], cv[:, mb]), pos)

    # phase A: the GPipe prefill, writing the prompts' K/V
    carry = torch.zeros(b, S, hid, dtype=dt, device=dev)
    for t in range(m + pp - 1):
        mb = t - stage
        x = carry
        if 0 <= mb < m:
            if stage == 0:
                x = F.embedding(micro[mb].to(dev), embed)
            x = run(x, mb, 0)
            if stage == pp - 1:
                out[mb, 0], first_emb[mb] = sample_embed(x[:, S - 1])
        carry = comm.ring_shift(x)
    # the first tokens' embeddings, last stage -> stage 0 round the ring
    first_emb = comm.ring_shift(first_emb)

    # phase B: the ring decode, one token per micro-batch every m ticks
    if max_new > 1:
        carry = torch.zeros(b, hid, dtype=dt, device=dev)
        # stage pp-1 emits micro-batch mb's token j at tick (pp-1) + mb + j*m
        for d in range((max_new - 1) * m + pp - 1):
            mb, g_in = (d - stage) % m, (d - stage) // m
            x = first_emb[mb] if stage == 0 and d < m else carry
            payload = x
            if d >= stage and g_in <= max_new - 2:
                x = run(x[:, None], mb, S + g_in)[:, 0]
                payload = x
                if stage == pp - 1:
                    out[mb, g_in + 1], payload = sample_embed(x)
            carry = comm.ring_shift(payload)
    out = comm.broadcast(out, src=pp - 1)
    # [m, max_new, b] -> [B, max_new] in the batch's order
    return out.permute(0, 2, 1).reshape(B, max_new)
