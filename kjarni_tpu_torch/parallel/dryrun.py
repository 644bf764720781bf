"""The multi-rank dry run (port of `__graft_entry__.py::dryrun_multichip`,
the JAX package's multi-device check): five phases of the parallel library
on n ranks.

1. one training step on a ("dp", "tp") mesh (dp 2 x tp n/2 when n is even
   and above 2, else tp n), at the JAX dryrun's shapes and seeds;
2. a sharded decode step from the updated params;
3. the GPipe forward and the pp ring decode on pp = 2 stages;
4. the Ulysses sequence-parallel prefill on sp = 4 (n >= 4);
5. the product path: `DecoderLM(tp=4)` over an on-disk checkpoint, whose
   greedy text must equal one process's (n >= 4).

The JAX package runs one program over n virtual devices; here n processes
(gloo, a `file://` rendezvous in a temporary directory) run phases 1-4,
and 4 more run phase 5, since DecoderLM(tp=4) takes a group of exactly 4
ranks. Phases 3 and 4 lay their pp / sp axis beside a "dp" axis of the
remaining ranks, each dp row running the same phase. With device "cuda"
every rank runs on cuda:0 (gloo staging through host memory); None means
the card and raises without one, "cpu" the host. The params are
`_random_llama`'s numpy recipe and seeds, so phase 1's loss is the one the
JAX package's `causal_lm_loss` gives on the same params. The checkpoint is
written with numpy and a word-level tokenizer.json, without transformers.

Run: python -m kjarni_tpu_torch.parallel.dryrun 8 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..core.placement import resolve_device
from ..models import llama as kllama

TRAIN_SHAPES = {"head_dim": 16, "hidden_size": 128, "vocab_size": 256,
                "max_seq_len": 64, "num_layers": 2}
STAGE_SHAPES = {"num_heads": 8, "num_kv_heads": 4, "head_dim": 16, "hidden_size": 128,
                "intermediate_size": 256, "vocab_size": 256, "max_seq_len": 64,
                "num_layers": 2}
PRODUCT_WORDS = ["[PAD]", "[UNK]", "<s>", "</s>", "hello", "world", "the", "a", "doctor",
                 "said", "is", "of", "and", "to", "in", "it", "was", "patient", "today",
                 "good", "bad", "day", "night", "one", "two"]


def random_llama(overrides: Optional[dict] = None, seed: int = 0):
    """(DecoderConfig, numpy params): the JAX package's `_random_llama`
    (__graft_entry__.py) recipe, draw for draw."""
    kw = dict(arch="llama", vocab_size=1024, hidden_size=256, num_layers=4,
              num_heads=8, num_kv_heads=4, head_dim=32, intermediate_size=512,
              max_seq_len=512, rope_theta=10000.0)
    kw.update(overrides or {})
    cfg = kllama.DecoderConfig(**kw)
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.02):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    L, H, Hkv, D = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    hid, inter, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    cos, sin = kllama.rope_cache(cfg, cfg.max_seq_len)
    params = {
        "embed": w(V, hid),
        "layers": {
            "q": {"w": w(L, hid, H * D)},
            "k": {"w": w(L, hid, Hkv * D)},
            "v": {"w": w(L, hid, Hkv * D)},
            "o": {"w": w(L, H * D, hid)},
            "gate": {"w": w(L, hid, inter)},
            "up": {"w": w(L, hid, inter)},
            "down": {"w": w(L, inter, hid)},
            "attn_norm": np.ones((L, hid), np.float32),
            "ffn_norm": np.ones((L, hid), np.float32),
        },
        "final_norm": np.ones(hid, np.float32),
        "lm_head": w(hid, V),
        "rope_cos": cos,
        "rope_sin": sin,
    }
    return cfg, params


def layout(n: int) -> tuple[int, int]:
    """The dp x tp factorization of n ranks: tp favored, dp > 1 kept when
    possible (the JAX dryrun's choice)."""
    return (2, n // 2) if n % 2 == 0 and n > 2 else (1, n)


def train_inputs(cfg, dp: int):
    """The dryrun batch: B = 2 * dp rows of 16, seed 1, a mask of ones."""
    B, S = 2 * dp, 16
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, (B, S))
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    return ids, labels, np.ones((B, S), np.int64)


def train_config(tp: int) -> dict:
    """The train phase's llama shapes: heads, KV heads and the FFN divide tp."""
    return {**TRAIN_SHAPES, "num_heads": max(8, tp), "num_kv_heads": max(4, tp),
            "intermediate_size": max(128, 2 * tp * 16)}


def _say(msg: str) -> None:
    if dist.get_rank() == 0:
        print(f"dryrun phase: {msg}", flush=True)


def run_phases(n: int, device: str) -> dict:
    """Phases 1-4 on this rank of an n-rank group; prints rank 0's phase
    lines and returns {"dp", "tp", "loss", "pp", "sp"}."""
    from ..weights.convert import params_from_jax
    from .mesh import Mesh, make_mesh, shard_cache, shard_llama_params, shard_params_with
    from .pipeline import pipeline_forward, pp_generate, pp_param_sharding
    from .sequence import sequence_parallel_forward
    from .train import sgd_train_step

    dp, tp = layout(n)
    mesh = make_mesh(dp=dp, tp=tp)
    cfg, raw = random_llama(train_config(tp))
    params = shard_llama_params(params_from_jax(raw, device), mesh)
    ids, labels, mask = train_inputs(cfg, dp)
    rows = ids.shape[0] // dp
    d = mesh.coords["dp"]
    mine = [torch.from_numpy(a[d * rows:(d + 1) * rows]).to(device) for a in (ids, labels, mask)]
    comms = {"tp": mesh.comm("tp"), "dp": mesh.comm("dp")}

    _say(f"train step (dp={dp} tp={tp})")
    new, loss = sgd_train_step(params, cfg, *mine, **comms)
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    _say("train step ok")

    with torch.inference_mode():
        ck, cv = shard_cache(kllama.init_cache(cfg, ids.shape[0], 32, device=device), mesh)
        tok = torch.zeros((rows, 1), dtype=torch.long, device=device)
        logits, _, _ = kllama.forward(new, cfg, tok, ck, cv, 0, tp=comms["tp"])
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError("non-finite sharded decode logits")
    _say("sharded decode ok")

    pcfg, praw = random_llama(STAGE_SHAPES)
    pparams = params_from_jax(praw, device)
    pp_ok = sp_ok = False
    if n >= 2 and n % 2 == 0:
        pmesh = Mesh({"dp": n // 2, "pp": 2})
        staged = shard_params_with(pparams, pp_param_sharding(pmesh), pmesh)
        x = torch.zeros((4, 8), dtype=torch.long, device=device)
        with torch.inference_mode():
            plog = pipeline_forward(staged, pcfg, x, pmesh, n_micro=2)
            ptoks = pp_generate(staged, pcfg, x, pmesh, max_new=4)
        if not bool(torch.isfinite(plog).all()) or tuple(ptoks.shape) != (4, 4):
            raise RuntimeError("the pp forward or ring decode went wrong")
        pp_ok = True
        _say("pp ring decode ok")
    if n >= 4 and n % 4 == 0:
        smesh = Mesh({"dp": n // 4, "sp": 4})
        with torch.inference_mode():
            slog = sequence_parallel_forward(pparams, pcfg, torch.zeros(
                (1, 16), dtype=torch.long, device=device), smesh)
        if not bool(torch.isfinite(slog).all()):
            raise RuntimeError("non-finite sp prefill logits")
        sp_ok = True
        _say("sp prefill ok")
    return {"dp": dp, "tp": tp, "loss": loss, "pp": pp_ok, "sp": sp_ok}


def write_product_dir(d: Path, seed: int = 11) -> None:
    """The product phase's checkpoint: a 2-layer llama of hidden 64 (4 heads,
    4 KV heads, FFN 128, untied head) with N(0, 0.02) weights drawn by
    numpy from `seed`, over a word-level tokenizer of PRODUCT_WORDS."""
    from ..weights.safetensors_loader import save_file
    V, hid, inter, L = len(PRODUCT_WORDS), 64, 128, 2
    rng = np.random.default_rng(seed)

    def w(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.02).astype(np.float32))

    ones = torch.ones(hid)
    tensors = {"model.embed_tokens.weight": w(V, hid), "model.norm.weight": ones,
               "lm_head.weight": w(V, hid)}
    for i in range(L):
        p = f"model.layers.{i}."
        tensors.update({p + "self_attn.q_proj.weight": w(hid, hid),
                        p + "self_attn.k_proj.weight": w(hid, hid),
                        p + "self_attn.v_proj.weight": w(hid, hid),
                        p + "self_attn.o_proj.weight": w(hid, hid),
                        p + "mlp.gate_proj.weight": w(inter, hid),
                        p + "mlp.up_proj.weight": w(inter, hid),
                        p + "mlp.down_proj.weight": w(hid, inter),
                        p + "input_layernorm.weight": ones,
                        p + "post_attention_layernorm.weight": ones})
    d.mkdir(parents=True, exist_ok=True)
    save_file(tensors, d / "model.safetensors")
    (d / "config.json").write_text(json.dumps({
        "model_type": "llama", "architectures": ["LlamaForCausalLM"], "vocab_size": V,
        "hidden_size": hid, "intermediate_size": inter, "num_hidden_layers": L,
        "num_attention_heads": 4, "num_key_value_heads": 4,
        "max_position_embeddings": 128, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
        "bos_token_id": 2, "eos_token_id": 3, "tie_word_embeddings": False}))
    specials = [{"id": i, "content": t, "single_word": False, "lstrip": False,
                 "rstrip": False, "normalized": False, "special": True}
                for i, t in enumerate(PRODUCT_WORDS[:4])]
    (d / "tokenizer.json").write_text(json.dumps({
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": specials,
        "normalizer": {"type": "Lowercase"}, "pre_tokenizer": {"type": "Whitespace"},
        "post_processor": None, "decoder": None,
        "model": {"type": "WordLevel", "unk_token": "[UNK]",
                  "vocab": {t: i for i, t in enumerate(PRODUCT_WORDS)}}}))


def product_texts(d: str, device: str) -> dict:
    """Phase 5 on this rank of a 4-rank group: greedy text at tp = 4, and
    on rank 0 the same request in one process."""
    from ..generate.sampling import GenerationConfig
    from ..models.decoder_lm import DecoderLM
    g = GenerationConfig(strategy="greedy", max_new_tokens=8)
    got = DecoderLM(d, max_context=64, tp=4, device=device).generate("hello world", config=g)
    out = {"tp4": got}
    if dist.get_rank() == 0:
        out["one"] = DecoderLM(d, max_context=64, device=device).generate("hello world",
                                                                          config=g)
    return out


def _rank(rank: int, n: int, rdzv: str, device: str, fn, args, results) -> None:
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank, world_size=n)
    try:
        out = fn(*args)
        if rank == 0:
            results.put(out)
    finally:
        dist.destroy_process_group()


def _spawn(n: int, tmp: Path, name: str, device: str, fn, *args):
    """fn(*args) on n spawned gloo ranks; rank 0's result. A rank that
    fails fails the run."""
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    mp.start_processes(_rank, args=(n, str(tmp / f"rdzv-{name}"), device, fn, args, results),
                       nprocs=n, join=True, start_method="spawn")
    return results.get()


def dryrun_multichip(n: int, device: Optional[str] = None) -> float:
    """Run the five phases on n ranks (module docstring); print the JAX
    dryrun's phase lines and its last line; return the train loss."""
    dev = resolve_device(device).type
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        r = _spawn(n, tmp, "phases", dev, run_phases, n, dev)
        product_ok = False
        if n >= 4:
            write_product_dir(tmp / "model")
            p = _spawn(4, tmp, "product", dev, product_texts, str(tmp / "model"), dev)
            if p["tp4"] != p["one"]:
                raise RuntimeError(f"tp=4 product path diverged: {p['tp4']!r} != {p['one']!r}")
            product_ok = True
            print("dryrun phase: product tp=4 ok", flush=True)
    print(f"dryrun_multichip ok: mesh dp={r['dp']} tp={r['tp']}, loss={r['loss']:.4f}, "
          f"pp={'ok' if r['pp'] else 'skipped'} sp={'ok' if r['sp'] else 'skipped'} "
          f"product_tp={'ok' if product_ok else 'skipped'}", flush=True)
    return r["loss"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the parallel library's five phases on n ranks")
    ap.add_argument("n", type=int, nargs="?", default=8, help="ranks (default 8: dp 2 x tp 4)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the ranks run (default: the CUDA card, every rank on cuda:0)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
