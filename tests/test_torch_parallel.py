"""The port's parallel library (kjarni_tpu_torch/parallel) against the JAX
package's, on the CPU, over one group of 8 gloo ranks spawned for the file
(tests/torch_dist.py): each rank's shards against JAX's addressable shards,
tp = 4 and dp = 2 x tp = 4 logits, pp = 4 pipelines, dp = 8 embeddings, and
the refusals outside a group. JAX runs on its 8 virtual CPU devices
(tests/conftest.py) with the same numpy inputs and the tolerances of
tests/test_parallel.py; both in f32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist as td
from __graft_entry__ import _random_llama
from helpers import build_word_tokenizer, save_torch_model, tiny_bert_dir
from kjarni_tpu.models import llama as jl
from kjarni_tpu.parallel.mesh import (batch_sharding, cache_sharding, encoder_param_sharding,
                                      make_mesh, shard_llama_params, shard_params_with)
from kjarni_tpu.parallel.pipeline import (make_pp_mesh, pipeline_forward, pp_generate,
                                          pp_param_sharding)
from kjarni_tpu_torch.core.errors import InvalidConfigError
from kjarni_tpu_torch.models import llama as tl

N_RANKS = 8
TINY = {"num_heads": 8, "num_kv_heads": 4, "head_dim": 16, "hidden_size": 128,
        "intermediate_size": 256, "vocab_size": 256, "max_seq_len": 64, "num_layers": 2}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = td.RankGroup(N_RANKS, tmp_path_factory.mktemp("ranks8"))
    yield g
    g.close()


def _llama(**over):
    cfg, params = _random_llama({**TINY, **over})
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(tl.DecoderConfig)}
    return cfg, params, kw


def _jax_shard(arr, rank: int) -> np.ndarray:
    """The shard of a placed JAX array on device `rank` (the rank's place in
    the mesh: devices reshape(dp, tp) row-major, as the port's ranks)."""
    dev = jax.devices()[rank]
    return next(np.asarray(s.data) for s in arr.addressable_shards if s.device == dev)


def _dequant_rows(w4: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """int4 [.., K/2, N] half-split with scales [.., G, N] -> f32 [.., K, N]."""
    lo = (w4.astype(np.int16) << 12 >> 12).astype(np.float32)
    hi = (w4.astype(np.int16) >> 4).astype(np.float32)
    q = np.concatenate([lo, hi], axis=-2)
    g = q.shape[-2] // scale.shape[-2]
    return q * np.repeat(scale, g, axis=-2)


@pytest.mark.parametrize("quantize", [None, "int8", "int4"])
def test_llama_shards_equal_jax_slices(group, quantize):
    """Every leaf of each rank's shard equals the JAX spec's slice on that
    rank's device, but for int4, which the port's ranks cannot take as JAX
    slices it (mesh.py's docstring): a column-parallel int4 scale is sliced
    with its columns (JAX replicates it), and a row-parallel w4 is a fresh
    half-split packing of the rank's contiguous K rows with their own groups:
    the same quantized numbers, regrouped."""
    cfg, params, _ = _llama()
    if quantize == "int8":
        params = jl.quantize_params_int8(params)
    elif quantize == "int4":
        params = jl.quantize_params_int4(params, group_size=16)
    params = jax.tree.map(np.asarray, params)
    jp = shard_llama_params(jax.tree.map(jnp.asarray, params), make_mesh(8, dp=2, tp=4))
    got = group.run(td.llama_shards, params, 2, 4)
    row_parallel = {"o", "down"}
    for rank, r in enumerate(got):
        t = r["coords"]["tp"]
        assert r["coords"] == {"dp": rank // 4, "tp": rank % 4}

        def check(path, mine, ref_arr, full):
            if quantize == "int4" and path[-1] == "scale" and path[-2] not in row_parallel:
                n = mine.shape[-1]
                np.testing.assert_array_equal(mine, full[..., t * n:(t + 1) * n], path)
            elif quantize == "int4" and path[-1] in ("w4", "scale") and \
                    path[-2] in row_parallel:
                return
            else:
                np.testing.assert_array_equal(mine, _jax_shard(ref_arr, rank), path)

        def walk(path, mine, ref, full):
            if isinstance(mine, dict):
                assert mine.keys() == ref.keys(), path
                for k in mine:
                    walk(path + (k,), mine[k], ref[k], full[k])
            else:
                check(path, mine, ref, full)

        walk((), r["shard"], jp, params)
        if quantize == "int4":
            for name in row_parallel:
                mine, full = r["shard"]["layers"][name], params["layers"][name]
                K = 2 * full["w4"].shape[-2]
                rows = slice(t * K // 4, (t + 1) * K // 4)
                np.testing.assert_array_equal(
                    _dequant_rows(mine["w4"], mine["scale"]),
                    _dequant_rows(full["w4"], full["scale"])[:, rows], name)


def test_encoder_rule_shards_equal_jax(group, tmp_path):
    """The BERT encoder's rule gives each rank JAX's slice of every leaf."""
    from kjarni_tpu.models.encoder_models import SentenceEncoder
    from kjarni_tpu.parallel.mesh import _match_structure
    tiny_bert_dir(tmp_path, seed=52)
    enc = SentenceEncoder(tmp_path, dtype="f32")
    params = jax.tree.map(lambda x: None if x is None else np.asarray(x), enc.params,
                          is_leaf=lambda x: x is None)
    mesh = make_mesh(8, dp=4, tp=2)
    sh = _match_structure(enc.params, encoder_param_sharding(mesh), mesh)
    placed = jax.tree.map(lambda x, s: None if x is None else jax.device_put(x, s),
                          enc.params, sh, is_leaf=lambda x: x is None or hasattr(x, "shape"))
    got = group.run(td.rule_shards, "bert", params, 4, 2)
    for rank, shard in enumerate(got):
        flat_mine = jax.tree_util.tree_leaves_with_path(shard)
        flat_ref = dict(jax.tree_util.tree_leaves_with_path(placed))
        assert len(flat_mine) == len(flat_ref)
        for path, leaf in flat_mine:
            np.testing.assert_array_equal(leaf, _jax_shard(flat_ref[path], rank), str(path))


@pytest.mark.parametrize("family", ["t5", "bart", "whisper"])
def test_encdec_rule_shards_equal_jax(group, family):
    """The T5, BART and Whisper rules give each rank JAX's slice of every
    leaf, over a random tree of each JAX rule's leaves and ranks (their tp
    forwards come later: ROADMAP.md item 9 i)."""
    from kjarni_tpu.parallel import mesh as jm
    mesh = make_mesh(8, dp=4, tp=2)
    rules = getattr(jm, f"{family}_param_sharding")(mesh)
    rng = np.random.default_rng(61)
    params = jax.tree.map(
        lambda sh: rng.standard_normal((4, 6, 8, 10)[:len(sh.spec)]).astype(np.float32),
        rules)
    placed = jax.tree.map(jax.device_put, params, rules)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(placed))
    for rank, shard in enumerate(group.run(td.rule_shards, family, params, 4, 2)):
        flat_mine = jax.tree_util.tree_leaves_with_path(shard)
        assert len(flat_mine) == len(flat_ref)
        for path, leaf in flat_mine:
            np.testing.assert_array_equal(leaf, _jax_shard(flat_ref[path], rank), str(path))


@pytest.mark.parametrize("dp,tp", [(1, 8), (2, 4)], ids=["tp8", "dp2xtp4"])
def test_tp_forward_all_logits_equal_jax(group, dp, tp):
    """forward_all_logits on each rank's rows and shard, within 1e-4 of the
    JAX package's on its ("dp", "tp") mesh (test_parallel.py's bound); the
    vocabulary divides tp, so the head is column-parallel and gathered."""
    cfg, params, kw = _llama()
    if tp == 8:     # every head count must divide tp: 8 KV heads
        cfg, params, kw = _llama(num_kv_heads=8)
    ids = np.random.default_rng(0).integers(0, 256, (2, 8)).astype(np.int32)
    mesh = make_mesh(8, dp=dp, tp=tp)
    jp = shard_llama_params(jax.tree.map(jnp.asarray, params), mesh)
    ck, cv = jl.init_cache(cfg, 2, 16)
    with mesh:
        ref, _, _ = jax.jit(lambda p, i, a, b: jl.forward_all_logits(p, cfg, i, a, b, 0))(
            jp, jax.device_put(jnp.asarray(ids), jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec(*batch_sharding(mesh).spec))),
            jax.device_put(ck, cache_sharding(mesh)), jax.device_put(cv, cache_sharding(mesh)))
    ref = np.asarray(ref)
    got = group.run(td.tp_forward_all_logits, params, kw, ids, dp, tp)
    rows = 2 // dp
    for r in got:
        assert r["kv_heads"] == cfg.num_kv_heads // tp and r["transport"] == "gloo"
        d = r["dp"]
        np.testing.assert_allclose(r["logits"], ref[d * rows:(d + 1) * rows],
                                   atol=1e-4, rtol=1e-4)


def test_pp4_forward_and_generate_equal_jax(group):
    """pipeline_forward at pp = 4 (one layer a stage, each stage on 2 ranks
    alike) within test_parallel.py's bound of JAX's pp = 4, and pp_generate's
    ids equal to JAX's."""
    cfg, params, kw = _llama(num_layers=4)
    ids = np.random.default_rng(6).integers(0, 256, (8, 8)).astype(np.int32)
    mesh = make_pp_mesh(4, pp=4)
    jp = shard_params_with(jax.tree.map(jnp.asarray, params), pp_param_sharding(mesh), mesh)
    with mesh:
        ref = np.asarray(pipeline_forward(jp, cfg, jnp.asarray(ids), mesh, n_micro=4))
        ref_ids = np.asarray(pp_generate(jp, cfg, jnp.asarray(ids), mesh, max_new=5))
    got = group.run(td.pipeline, params, kw, ids, 4, 2, 4, None)
    for out in got:
        np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-4)
    got = group.run(td.pipeline, params, kw, ids, 4, 2, None, 5)
    for out in got:
        np.testing.assert_array_equal(out, ref_ids)


def test_dp8_embeddings_equal_jax(group, tmp_path):
    """encode_data_parallel over 8 ranks on 10 texts (10 % 8 != 0: pad rows)
    within 1e-5 of the JAX package's over its dp = 8 mesh."""
    from kjarni_tpu.models.encoder_models import SentenceEncoder
    from kjarni_tpu.parallel.inference import encode_data_parallel, replicate_params
    tiny_bert_dir(tmp_path, seed=51)
    enc = SentenceEncoder(tmp_path, dtype="f32")
    texts = [f"hello world doctor {i}" for i in range(10)]
    mesh = make_mesh(8, dp=8, tp=1)
    ids, mask = enc.tokenizer.encode_batch(texts, max_len=enc.max_seq_len)
    ref = encode_data_parallel(replicate_params(enc.params, mesh), enc.config, mesh, ids, mask)
    for out in group.run(td.encode_data_parallel, str(tmp_path), texts):
        np.testing.assert_allclose(out, ref, atol=1e-5)


def test_mesh_bad_factorization_and_no_group(group):
    """make_mesh raises ValueError when dp * tp is not the world size, as
    the JAX make_mesh does for its devices; outside a group a Mesh raises."""
    out = group.run(td.make_mesh_error, 3, 3)
    assert all("dp*tp (3*3) != world size (8)" in e for e in out)
    from kjarni_tpu_torch.parallel.mesh import make_mesh as tmake
    with pytest.raises(InvalidConfigError, match="process group"):
        tmake(dp=1, tp=1)


@pytest.fixture(scope="module")
def llama_dirs(tmp_path_factory):
    """A tiny llama and a tiny gpt2 checkpoint (HF layout)."""
    from transformers import GPT2Config, GPT2LMHeadModel, LlamaConfig, LlamaForCausalLM
    base = tmp_path_factory.mktemp("tp_refusals")
    out = {"llama": base / "llama", "gpt2": base / "gpt2"}
    for d in out.values():
        d.mkdir()
    vm = build_word_tokenizer(out["llama"] / "tokenizer.json", bert_style=False)
    cfg = LlamaConfig(vocab_size=len(vm), hidden_size=32, intermediate_size=64,
                      num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=64, bos_token_id=2, eos_token_id=3)
    save_torch_model(out["llama"], LlamaForCausalLM(cfg).eval(), cfg)
    vm = build_word_tokenizer(out["gpt2"] / "tokenizer.json", bert_style=False)
    cfg = GPT2Config(vocab_size=len(vm), n_embd=32, n_layer=1, n_head=4, n_positions=64)
    save_torch_model(out["gpt2"], GPT2LMHeadModel(cfg).eval(), cfg)
    return out


@pytest.mark.parametrize("case", ["no_group", "gpt2", "plan", "world_size", "heads"])
def test_tp_refusals(group, llama_dirs, case):
    """DecoderLM(tp=N) raises as the JAX DecoderLM's gates do: the family and
    the execution plan first, then a missing group of N ranks (naming
    torchrun where JAX says how many devices it sees); and tp must divide
    the heads, KV heads and FFN width."""
    from kjarni_tpu_torch.models.decoder_lm import DecoderLM
    if case == "no_group":
        with pytest.raises(InvalidConfigError, match="torchrun --nproc-per-node 2"):
            DecoderLM(llama_dirs["llama"], tp=2, device="cpu")
        return
    kind = {"gpt2": "plain", "plan": "plan", "world_size": "world", "heads": "plain"}[case]
    model = llama_dirs["gpt2" if case == "gpt2" else "llama"]
    want = {"gpt2": "llama-family models only", "plan": "mutually exclusive",
            "world_size": "torchrun --nproc-per-node 16", "heads": "must divide"}[case]
    assert all(want in e for e in group.run(td.refusal, kind, str(model)))
