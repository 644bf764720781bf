"""The port's serving paths under parallelism against the JAX package's, on
the CPU, over one group of 2 gloo ranks spawned for the file
(tests/torch_dist.py): DecoderLM(tp=2) (plain, int4, int8 KV, sampled),
generate_batch and Chat under tp, the CLI's `--tp 2 generate` (an argument
or a pipe), `--tp 2 chat` through stdin and `--dp 2 embed` (rank 0's stdout
against the JAX CLI's), dp = 2 encoders, the pp = 2
pipeline and the sp = 2 prefill. JAX runs on its virtual CPU devices with
the same inputs and tolerances as tests/test_parallel.py and
test_parallel_product.py; both in f32.
"""

import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist as td
from __graft_entry__ import _random_llama
from helpers import build_word_tokenizer, save_torch_model, tiny_bert_dir
from test_torch_cli import _close, _same_text
from kjarni_tpu.cli import main as jcli
from kjarni_tpu.generate.sampling import GenerationConfig
from kjarni_tpu.models.decoder_lm import DecoderLM
from kjarni_tpu.parallel.mesh import shard_params_with
from kjarni_tpu.parallel.pipeline import (make_pp_mesh, pipeline_forward, pp_generate,
                                          pp_param_sharding)
from kjarni_tpu.parallel.sequence import make_sp_mesh, sequence_parallel_forward
from kjarni_tpu_torch.models import llama as tl

GREEDY = dict(strategy="greedy", max_new_tokens=12)
TINY = {"num_heads": 8, "num_kv_heads": 4, "head_dim": 16, "hidden_size": 128,
        "intermediate_size": 256, "vocab_size": 256, "max_seq_len": 64, "num_layers": 2}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = td.RankGroup(2, tmp_path_factory.mktemp("ranks2"))
    yield g
    g.close()


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A tiny llama whose heads, KV heads and FFN divide tp = 2 (its word
    vocabulary does not: the head stays replicated), and tiny BERT dirs."""
    from transformers import LlamaConfig, LlamaForCausalLM
    base = tmp_path_factory.mktemp("parallel_serving")
    d = base / "llama"
    d.mkdir()
    vm = build_word_tokenizer(d / "tokenizer.json", bert_style=False)
    cfg = LlamaConfig(vocab_size=len(vm), hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=128, bos_token_id=2, eos_token_id=3,
                      tie_word_embeddings=False)
    torch.manual_seed(11)
    save_torch_model(d, LlamaForCausalLM(cfg).eval(), cfg)
    # greedy by default, so the CLI's chat turns compare token for token
    (d / "generation_config.json").write_text(json.dumps({"do_sample": False}))
    out = {"llama": d}
    for name, kw in {"emb": dict(seed=3), "clf": dict(num_labels=2, seed=4),
                     "rr": dict(num_labels=1, seed=5, for_pair=True)}.items():
        out[name] = base / name
        tiny_bert_dir(out[name], **kw)
    return out


@pytest.mark.parametrize("kw", [{}, {"quantize": "int4"}, {"kv_cache": "int8"}],
                         ids=["plain", "int4", "int8_kv"])
def test_tp2_greedy_equals_jax_tp2(group, dirs, kw):
    """Both ranks' greedy text and streamed ids equal each other and the JAX
    DecoderLM(tp=2)'s; each rank holds half the q columns and a cache of
    its own KV head."""
    d = dirs["llama"]
    jlm = DecoderLM(d, dtype="f32", max_context=64, tp=2, **kw)
    ref_ids = [st.id for st in jlm.generate_stream("hello world",
                                                   config=GenerationConfig(**GREEDY))]
    ref = jlm.generate("hello world", config=GenerationConfig(**GREEDY))
    got = group.run(td.decoder_generate, str(d),
                    {"dtype": "f32", "max_context": 64, "tp": 2, **kw}, "hello world", GREEDY)
    for r in got:
        assert r["text"] == ref and r["stream_ids"] == ref_ids
        assert r["q_width"] == 2 * 16 and r["cache_kv_heads"] == 1


def test_tp2_sampled_same_on_every_rank(group, dirs):
    """A seeded sampled generation draws the same tokens on both ranks: the
    logits are the same bits after the all-reduce and the gather."""
    gen = dict(strategy="sample", max_new_tokens=16, seed=7,
               sampling={"temperature": 0.9, "top_k": 20, "top_p": 0.95, "min_p": 0.0})
    got = group.run(td.decoder_generate, str(dirs["llama"]),
                    {"dtype": "f32", "max_context": 64, "tp": 2}, "the doctor went", gen)
    assert got[0]["stream_ids"] == got[1]["stream_ids"] and got[0]["text"] == got[1]["text"]
    assert len(got[0]["stream_ids"]) > 0


def test_tp2_unseeded_sampling_same_on_every_rank(group, dirs):
    """Without a seed, rank 0 draws one and every rank samples with it: the
    ranks return the same tokens and run the same steps (each drawing its
    own would desynchronize their collectives)."""
    gen = dict(strategy="sample", max_new_tokens=16,
               sampling={"temperature": 1.0, "top_k": None, "top_p": None, "min_p": None})
    got = group.run(td.decoder_generate, str(dirs["llama"]),
                    {"dtype": "f32", "max_context": 64, "tp": 2}, "the doctor went", gen)
    assert got[0]["stream_ids"] == got[1]["stream_ids"] and got[0]["text"] == got[1]["text"]


def test_tp2_generate_batch_and_chat_equal_jax(group, dirs):
    from kjarni_tpu.tasks.chat import Chat
    from kjarni_tpu.tasks.generator import Generator
    d = str(dirs["llama"])
    prompts = ["hello world", "i love this product", "the best"]
    ref = Generator(d, tp=2).generate_batch(
        prompts, config=GenerationConfig(strategy="greedy", max_new_tokens=8))
    assert group.run(td.generator_batch, d, 2, prompts, 8) == [ref, ref]
    chat = Chat(d, system_prompt="be brief", tp=2)
    cfg = GenerationConfig(strategy="greedy", max_new_tokens=6)
    ref = [chat.send(m, config=cfg) for m in ("hello", "and again")]
    assert group.run(td.chat_send, d, 2, "be brief", ["hello", "and again"], 6) == [ref, ref]


def _jax_cli(argv, capsys):
    rc = jcli.main(argv)
    return rc, capsys.readouterr().out


CLI_CASES = {
    "generate_tp": (["generate", "hello world", "--tp", "2", "--preset", "greedy",
                     "--max-tokens", "8", "--format", "json"], None),
    "embed_dp": (["embed", "hello world", "--dp", "2"], None),
    # torchrun's ranks share one stdin: rank 0 alone reads it
    "generate_tp_stdin": (["generate", "-", "--tp", "2", "--preset", "greedy",
                           "--max-tokens", "8"], "the doctor went\n"),
    "chat_tp_stdin": (["chat", "--tp", "2", "--system", "be brief"],
                      "hello\n\nand again\nexit\n"),
}


@pytest.mark.parametrize("cmd", list(CLI_CASES))
def test_cli_rank0_stdout_equals_jax(group, dirs, capsys, monkeypatch, cmd):
    """`kjarni --tp 2 generate`, `--dp 2 embed`, a piped `generate - --tp 2`
    and an interactive `chat --tp 2` in each rank: rank 0's stdout equals
    the JAX CLI's with the same flags and input, rank 1 writes none and
    reads no stdin."""
    argv, stdin = CLI_CASES[cmd]
    argv = argv + ["--model", str(dirs["emb" if cmd == "embed_dp" else "llama"])]
    if stdin is not None:
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    rc, ref = _jax_cli(argv, capsys)
    got = group.run(td.cli, argv + ["--device", "cpu"], stdin)
    assert rc == 0 and [g["rc"] for g in got] == [0, 0], got
    assert got[1]["out"] == ""
    if cmd == "generate_tp":
        _close(json.loads(got[0]["out"]), json.loads(ref))
    elif cmd == "embed_dp":
        _same_text(got[0]["out"], ref)
    else:
        assert got[0]["out"] == ref


@pytest.mark.parametrize("task", ["embed", "classify", "rerank"])
def test_dp2_encoders_equal_jax(group, dirs, task):
    """Embedder, Classifier and Reranker at dp = 2 (11 texts or 3 pairs: pad
    rows) against the JAX tasks at dp = 2, within test_parallel_product.py's
    bounds, on both ranks."""
    from kjarni_tpu.tasks.classifier import Classifier
    from kjarni_tpu.tasks.embedder import Embedder
    from kjarni_tpu.tasks.reranker import Reranker
    if task == "embed":
        texts = [f"hello world doctor {i}" for i in range(11)]
        ref = Embedder(str(dirs["emb"]), dp=2).embed_batch(texts)
        for out in group.run(td.embed_dp, str(dirs["emb"]), 2, texts):
            np.testing.assert_allclose(out, ref, atol=1e-5)
    elif task == "classify":
        texts = ["i love this", "terrible quality", "great service"]
        ref = [r.label for r in Classifier(str(dirs["clf"]), dp=2).classify_batch(texts)]
        assert group.run(td.task_dp, "classify", str(dirs["clf"]), 2, texts) == [ref, ref]
    else:
        pairs = [("doctor", d) for d in ("the doctor was great", "terrible service",
                                         "hello world")]
        ref = Reranker(str(dirs["rr"]), dp=2).score_pairs(pairs)
        for out in group.run(td.task_dp, "rerank", str(dirs["rr"]), 2, pairs):
            np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.fixture(scope="module")
def tiny_llama():
    cfg, params = _random_llama(TINY)
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(tl.DecoderConfig)}
    return cfg, params, kw


@pytest.mark.parametrize("n_micro,batch", [(2, 4), (4, 8)], ids=["micro2", "micro4"])
def test_pp2_forward_equals_jax(group, tiny_llama, n_micro, batch):
    """pipeline_forward at pp = 2 (one layer a stage) within
    test_parallel.py's bound of JAX's, as many micro-batches as stages and
    more."""
    cfg, params, kw = tiny_llama
    ids = np.random.default_rng(3 + n_micro).integers(0, 256, (batch, 8)).astype(np.int32)
    mesh = make_pp_mesh(2, pp=2)
    jp = shard_params_with(jax.tree.map(jnp.asarray, params), pp_param_sharding(mesh), mesh)
    with mesh:
        ref = np.asarray(pipeline_forward(jp, cfg, jnp.asarray(ids), mesh, n_micro=n_micro))
    for out in group.run(td.pipeline, params, kw, ids, 2, 1, n_micro, None):
        np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("max_new,batch", [(6, 4), (1, 2)], ids=["ring", "single_token"])
def test_pp2_generate_equals_jax(group, tiny_llama, max_new, batch):
    """pp_generate's greedy ids equal JAX's: the ring decode, and a single
    token (the prefill alone)."""
    cfg, params, kw = tiny_llama
    ids = np.random.default_rng(7 + max_new).integers(0, 256, (batch, 8)).astype(np.int32)
    mesh = make_pp_mesh(2, pp=2)
    jp = shard_params_with(jax.tree.map(jnp.asarray, params), pp_param_sharding(mesh), mesh)
    with mesh:
        ref = np.asarray(pp_generate(jp, cfg, jnp.asarray(ids), mesh, max_new=max_new))
    for out in group.run(td.pipeline, params, kw, ids, 2, 1, None, max_new):
        np.testing.assert_array_equal(out, ref)


def test_sp2_forward_equals_jax(group, tiny_llama):
    """sequence_parallel_forward at sp = 2 within test_parallel.py's bound of
    JAX's at sp = 2, on both ranks."""
    cfg, params, kw = tiny_llama
    ids = np.random.default_rng(5).integers(0, 256, (2, 16)).astype(np.int32)
    ref = np.asarray(sequence_parallel_forward(jax.tree.map(jnp.asarray, params), cfg,
                                               jnp.asarray(ids), make_sp_mesh(2)))
    for out in group.run(td.sequence, params, kw, ids, 2):
        np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("case", ["pp_batch", "sp_length"])
def test_pp_and_sp_rejections(group, tiny_llama, case):
    """As in JAX: a batch that does not split into pp micro-batches, and a
    sequence length that does not divide sp, raise ValueError."""
    _, params, kw = tiny_llama
    if case == "pp_batch":
        err = group.run(td.raises, "pipeline", params, kw, np.zeros((3, 8), np.int32),
                        2, 1, None, 4)
        assert all("microbatches" in e for e in err)
    else:
        err = group.run(td.raises, "sequence", params, kw, np.zeros((1, 15), np.int32), 2)
        assert all("must divide sp (2)" in e for e in err)
