"""Tensor-parallel forwards of the encoder families (kjarni_tpu_torch
models/bert.py, t5.py, bart.py, whisper.py with `tp=`) against the JAX
package's replicated forwards, on the CPU, over one group of 4 gloo ranks
spawned for the file (tests/torch_dist.py): tp = 2 (a dp 2 x tp 2 mesh)
and tp = 4. Each rank holds its shard under the family's rule tree; the
tolerances are tests/test_parallel.py's (1e-5 for BERT, 1e-4 for the
encoder-decoders), in f32.

The cases cover the per-leaf fallback: nomic's gate and up, which the
encoder rule does not name, stay whole while its fc2 is row-sharded;
BART's vocabulary of 98 divides 2 and not 4, so its head (and
final_logits_bias) is sharded at tp = 2 and replicated at tp = 4;
Whisper's real vocabulary of 51,865 divides neither. mpnet's and T5's
per-head relative position biases are replicated and each rank takes its
own heads' columns.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist as td
from helpers import save_torch_model
from test_nomic import make_nomic_dir
from test_whisper import whisper_checkpoint
from kjarni_tpu.models import bart as jbart
from kjarni_tpu.models import bert as jbert
from kjarni_tpu.models import t5 as jt5
from kjarni_tpu.models import whisper as jw
from kjarni_tpu.weights.safetensors_loader import ModelWeights

N_RANKS = 4


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = td.RankGroup(N_RANKS, tmp_path_factory.mktemp("ranks4"))
    yield g
    g.close()


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return None if tree is None else np.asarray(tree)


def _hf(d):
    return json.loads((d / "config.json").read_text())


def _bert_dir(d, flavor):
    from transformers import BertConfig, BertModel, MPNetConfig, MPNetModel
    if flavor == "nomic":
        make_nomic_dir(d, seed=1)
        return
    kw = dict(vocab_size=120, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
              intermediate_size=128, max_position_embeddings=66)
    cls, config = ((BertModel, BertConfig(**kw)) if flavor == "bert"
                   else (MPNetModel, MPNetConfig(**kw)))
    torch.manual_seed(5)
    save_torch_model(d, cls(config).eval(), config)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("flavor", ["bert", "mpnet", "nomic"])
def test_bert_tp_equals_jax_replicated(group, tmp_path, flavor, tp):
    _bert_dir(tmp_path, flavor)
    hf = _hf(tmp_path)
    cfg = jbert.BertConfig.from_hf(hf)
    params = jbert.load_params(ModelWeights(tmp_path), cfg)
    rng = np.random.default_rng(3)
    ids = rng.integers(5, cfg.vocab_size - 1, (2, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 8:] = 0
    ids[1, 8:] = cfg.pad_token_id
    want = np.asarray(jbert.encode(params, cfg, jnp.asarray(ids), jnp.asarray(mask),
                                   jnp.zeros_like(jnp.asarray(ids))))
    got = group.run(td.family_tp, "bert", hf, _np(params), {"ids": ids, "mask": mask}, tp)
    for r in got:
        np.testing.assert_allclose(r["hidden"], want, atol=1e-5)


def _encdec(family, d):
    """(hf config, JAX params, inputs) of a tiny checkpoint of `family`."""
    if family == "whisper":
        _, cfg, params = whisper_checkpoint(d, seed=6)
        mel = np.random.default_rng(0).standard_normal((1, 80, 3000)).astype(np.float32) * 0.1
        dec = np.array([[50258, 50259, 50359, 50363, 100]], dtype=np.int32)
        return _hf(d), cfg, params, {"mel": mel, "dec_ids": dec}
    if family == "t5":
        from transformers import T5Config, T5ForConditionalGeneration
        config = T5Config(vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=2,
                          num_decoder_layers=2, num_heads=4, relative_attention_num_buckets=8,
                          feed_forward_proj="gated-gelu", tie_word_embeddings=False,
                          decoder_start_token_id=0)
        torch.manual_seed(71)
        save_torch_model(d, T5ForConditionalGeneration(config).eval(), config)
        cfg = jt5.T5Config.from_hf(_hf(d))
        params = jt5.load_params(ModelWeights(d), cfg)
        enc_ids, dec = [[5, 9, 23, 1]], [[0, 42, 17]]
    else:
        from transformers import BartConfig, BartForConditionalGeneration
        config = BartConfig(vocab_size=98, d_model=32, encoder_layers=1, decoder_layers=1,
                            encoder_attention_heads=4, decoder_attention_heads=4,
                            encoder_ffn_dim=64, decoder_ffn_dim=64, max_position_embeddings=64,
                            pad_token_id=1, bos_token_id=0, eos_token_id=2,
                            decoder_start_token_id=2)
        torch.manual_seed(72)
        save_torch_model(d, BartForConditionalGeneration(config).eval(), config)
        cfg = jbart.BartConfig.from_hf(_hf(d))
        params = jbart.load_params(ModelWeights(d), cfg)
        params["final_logits_bias"] = np.random.default_rng(4).standard_normal(
            cfg.vocab_size).astype(np.float32)
        enc_ids, dec = [[0, 5, 9, 2]], [[2, 0, 42]]
    enc_ids = np.array(enc_ids, np.int32)
    return _hf(d), cfg, params, {"enc_ids": enc_ids, "enc_mask": np.ones_like(enc_ids),
                                 "dec_ids": np.array(dec, np.int32)}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("family", ["t5", "bart", "whisper"])
def test_encdec_tp_equals_jax_replicated(group, tmp_path, family, tp):
    """encode, precompute_cross_kv and one decode_step of 3 (Whisper 5)
    tokens from slot 0, as tests/test_parallel.py::TestSeq2SeqSharding."""
    hf, cfg, params, x = _encdec(family, tmp_path)
    mod = {"t5": jt5, "bart": jbart, "whisper": jw}[family]
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    if family == "whisper":
        enc = mod.encode(params, cfg, jx["mel"])
        mask = jnp.ones((1, cfg.max_source_positions), jnp.int32)
    else:
        mask = jx["enc_mask"]
        enc = mod.encode(params, cfg, jx["enc_ids"], mask)
    ck, cv = mod.precompute_cross_kv(params, cfg, enc)
    sk, sv = mod.init_self_cache(cfg, 1, 8)
    logits, _, _ = mod.decode_step(params, cfg, jx["dec_ids"], sk, sv, ck, cv, mask, 0)
    got = group.run(td.family_tp, family, hf, _np(params), x, tp)
    heads = hf.get("num_heads") or hf.get("decoder_attention_heads")
    for r in got:
        assert r["heads"] == heads // tp
        np.testing.assert_allclose(r["enc"], np.asarray(enc), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(r["logits"], np.asarray(logits), atol=1e-4, rtol=1e-4)
