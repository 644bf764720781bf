"""kjarni_tpu_torch's encoder-decoder models (models/bart.py, models/t5.py)
and beam loops (generate/beam.py, generate/beam_fused.py) against the JAX
package's, on the CPU, in f32.

Both packages load the same tiny HF checkpoints (made by
tests/test_bart_beam.py and tests/test_t5_parity.py) and run the same numpy
inputs.
Tolerances are the JAX tests' own: encoder states and decoder logits atol
2e-3 / rtol 1e-3, incremental decode against the full pass atol 1e-3 /
rtol 1e-3; params, buckets and beam tokens exactly.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_bart_beam import bart_checkpoint
from test_t5_parity import t5_checkpoint

from kjarni_tpu.generate import beam as jbeam
from kjarni_tpu.generate.beam_fused import build_fused_beam as jax_fused_beam
from kjarni_tpu.models import bart as jbart
from kjarni_tpu.models import t5 as jt5
from kjarni_tpu.models.seq2seq_lm import Seq2SeqLM as JaxSeq2SeqLM
from kjarni_tpu_torch.generate import beam as tbeam
from kjarni_tpu_torch.generate.beam_fused import build_fused_beam
from kjarni_tpu_torch.models import bart as tbart
from kjarni_tpu_torch.models import t5 as tt5
from kjarni_tpu_torch.models.seq2seq_lm import Seq2SeqLM, reorder_cache
from kjarni_tpu_torch.weights.convert import params_from_jax
from kjarni_tpu_torch.weights.safetensors_loader import ModelWeights

ATOL, RTOL = 2e-3, 1e-3
INC_TOL = 1e-3


def _t(a, dtype=torch.long):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _assert_params_equal(port: dict, ref: dict):
    assert set(port) == set(ref)
    for k, v in ref.items():
        if isinstance(v, dict):
            _assert_params_equal(port[k], v)
        else:
            np.testing.assert_array_equal(port[k].numpy(), np.asarray(v, np.float32))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """name -> (dir, JAX config, JAX params, port config, port params)."""
    out = {}
    specs = {"bart": (bart_checkpoint, {"seed": 1}),
             "t5_gated": (t5_checkpoint, {"gated": True, "seed": 1}),
             "t5_relu_tied": (t5_checkpoint, {"gated": False, "seed": 1})}
    for name, (build, kw) in specs.items():
        d = tmp_path_factory.mktemp(name)
        _, jcfg, jparams = build(d, **kw)
        fam = tbart if name == "bart" else tt5
        cfg = (fam.BartConfig if name == "bart" else fam.T5Config).from_hf(
            json.loads((d / "config.json").read_text()))
        out[name] = (d, jcfg, jparams, cfg, fam.load_params(ModelWeights(d), cfg))
    return out


def _fams(name):
    return (jbart, tbart) if name == "bart" else (jt5, tt5)


NAMES = ("bart", "t5_gated", "t5_relu_tied")
ENC_IDS = np.array([[0, 5, 9, 23, 2], [0, 7, 2, 1, 1]], dtype=np.int32)
ENC_MASK = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]], dtype=np.int32)


@pytest.mark.parametrize("name", NAMES)
def test_load_params_equal_converted_jax_params(models, name):
    _, _, jparams, _, params = models[name]
    _assert_params_equal(params, jparams)
    assert params_from_jax(jparams)["lm_head"].is_contiguous()


@pytest.mark.parametrize("name", NAMES)
def test_encode_matches_jax(models, name):
    _, jcfg, jparams, cfg, params = models[name]
    jf, tf = _fams(name)
    want = np.asarray(jf.encode(jparams, jcfg, jnp.asarray(ENC_IDS), jnp.asarray(ENC_MASK)))
    got = tf.encode(params, cfg, _t(ENC_IDS), _t(ENC_MASK)).numpy()
    m = ENC_MASK.astype(bool)
    np.testing.assert_allclose(got[m], want[m], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_matches_jax_on_a_padded_batch(models, name):
    """Three decoder tokens at once over a padded encoder batch: the cross
    padding bias, the causal self bias (T5's causal buckets) and the head."""
    _, jcfg, jparams, cfg, params = models[name]
    jf, tf = _fams(name)
    dec = np.array([[2, 0, 42], [2, 17, 9]], dtype=np.int32)
    enc = jf.encode(jparams, jcfg, jnp.asarray(ENC_IDS), jnp.asarray(ENC_MASK))
    ck, cv = jf.precompute_cross_kv(jparams, jcfg, enc)
    sk, sv = jf.init_self_cache(jcfg, 2, 8)
    want, wk, _ = jf.decode_step(jparams, jcfg, jnp.asarray(dec), sk, sv, ck, cv,
                                 jnp.asarray(ENC_MASK), 0)
    tenc = tf.encode(params, cfg, _t(ENC_IDS), _t(ENC_MASK))
    tck, tcv = tf.precompute_cross_kv(params, cfg, tenc)
    np.testing.assert_allclose(tck.numpy(), np.asarray(ck), atol=ATOL, rtol=RTOL)
    tsk, tsv = tf.init_self_cache(cfg, 2, 8)
    got, gk, _ = tf.decode_step(params, cfg, _t(dec), tsk, tsv, tck, tcv,
                                _t(ENC_MASK), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_incremental_decode_matches_full_and_jax(models, name):
    _, jcfg, jparams, cfg, params = models[name]
    jf, tf = _fams(name)
    enc_ids, enc_mask = ENC_IDS[:1, :4], ENC_MASK[:1, :4]
    dec = np.array([[2, 0, 42, 17]], dtype=np.int32)
    tenc = tf.encode(params, cfg, _t(enc_ids), _t(enc_mask))
    ck, cv = tf.precompute_cross_kv(params, cfg, tenc)
    sk, sv = tf.init_self_cache(cfg, 1, 8)
    full, _, _ = tf.decode_step(params, cfg, _t(dec), sk, sv, ck, cv, _t(enc_mask), 0)
    sk, sv = tf.init_self_cache(cfg, 1, 8)
    for i in range(dec.shape[1]):
        last, sk, sv = tf.decode_step(params, cfg, _t(dec[:, i:i + 1]), sk, sv, ck, cv,
                                      _t(enc_mask), i)
    np.testing.assert_allclose(last[0, 0].numpy(), full[0, -1].numpy(),
                               atol=INC_TOL, rtol=INC_TOL)
    jenc = jf.encode(jparams, jcfg, jnp.asarray(enc_ids), jnp.asarray(enc_mask))
    jck, jcv = jf.precompute_cross_kv(jparams, jcfg, jenc)
    jsk, jsv = jf.init_self_cache(jcfg, 1, 8)
    for i in range(dec.shape[1]):
        jlast, jsk, jsv = jf.decode_step(jparams, jcfg, jnp.asarray(dec[:, i:i + 1]),
                                         jsk, jsv, jck, jcv, jnp.asarray(enc_mask),
                                         jnp.int32(i))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=ATOL, rtol=RTOL)


def test_t5_tied_head_takes_the_d_model_scale(models):
    _, _, _, cfg, params = models["t5_relu_tied"]
    assert cfg.tie_word_embeddings
    enc = tt5.encode(params, cfg, _t(ENC_IDS[:1]), _t(ENC_MASK[:1]))
    ck, cv = tt5.precompute_cross_kv(params, cfg, enc)
    sk, sv = tt5.init_self_cache(cfg, 1, 8)
    logits, _, _ = tt5.decode_step(params, cfg, _t([[0]]), sk, sv, ck, cv,
                                   _t(ENC_MASK[:1]), 0)
    scaled_head = dict(params, lm_head=params["lm_head"] * cfg.d_model ** -0.5)
    sk, sv = tt5.init_self_cache(cfg, 1, 8)
    raw, _, _ = tt5.decode_step(scaled_head, dataclasses.replace(cfg, tie_word_embeddings=False),
                                _t([[0]]), sk, sv, ck, cv, _t(ENC_MASK[:1]), 0)
    np.testing.assert_allclose(logits.numpy(), raw.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("nb,md", [(32, 128), (8, 20)])
def test_t5_buckets_and_bias_equal_jax(bidirectional, nb, md):
    rel = np.arange(-1600, 1601, dtype=np.int32)
    want = np.asarray(jt5._bucket(jnp.asarray(rel), bidirectional, nb, md))
    got = tt5._bucket(torch.from_numpy(rel.astype(np.int64)), bidirectional, nb, md)
    np.testing.assert_array_equal(got.numpy(), want)
    table = np.random.default_rng(nb).standard_normal((nb, 4)).astype(np.float32)
    # an encoder-sized block, and one decode row past the smallest cached
    # bucket row
    for q0, sq, sk in ((5, 40, 64), (300, 1, 512)):
        q, k = np.arange(q0, q0 + sq), np.arange(sk)
        want = np.asarray(jt5.position_bias(jnp.asarray(table), jnp.asarray(q),
                                            jnp.asarray(k), bidirectional, nb, md))
        got = tt5.position_bias(torch.from_numpy(table), q0, sq, sk, bidirectional, nb, md)
        np.testing.assert_array_equal(got.numpy(), want)


def test_reorder_cache_takes_parent_rows():
    cache = torch.arange(2 * 3 * 1 * 2 * 1, dtype=torch.float32).reshape(2, 3, 1, 2, 1)
    out = reorder_cache(cache, torch.tensor([2, 2, 0]))
    assert torch.equal(out[:, 0], cache[:, 2]) and torch.equal(out[:, 1], cache[:, 2])
    assert torch.equal(out[:, 2], cache[:, 0])


# ---------------------------------------------------------------------------
# the beam loops over a scripted decode function
# ---------------------------------------------------------------------------

V, R, MAXLEN = 23, 5, 10


def _script(seed: int, coarse: bool):
    """Logits [MAXLEN, R, V] indexed by (step, last token % R): the history
    reaches the scores through the tokens the beams carry. `coarse` rounds
    them to 0.5, so that exact ties arise among candidates."""
    t = np.random.default_rng(seed).standard_normal((MAXLEN, R, V)).astype(np.float32) * 3
    return np.round(t * 2) / 2 if coarse else t


def _cfgs():
    base = dict(num_beams=3, max_length=MAXLEN, eos_token_id=2,
                decoder_start_token_id=1)
    return [
        dict(base, min_length=2, no_repeat_ngram_size=2, length_penalty=2.0,
             forced_bos_token_id=0, forced_eos_token_id=2),
        dict(base, min_length=0, no_repeat_ngram_size=0, length_penalty=1.0),
        dict(base, num_beams=4, early_stopping=False, length_penalty=1.5,
             no_repeat_ngram_size=3),
        dict(base, num_beams=2, early_stopping=False, length_penalty=0.0),
    ]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("ci", range(4))
def test_device_beam_loop_equals_jax_fused_loop(seed, ci):
    kw = _cfgs()[ci]
    table = _script(seed, coarse=seed % 2 == 1)
    k = kw["num_beams"]
    jcfg, cfg = jbeam.BeamSearchConfig(**kw), tbeam.BeamSearchConfig(**kw)
    jt = jnp.asarray(table)

    def jdecode(cur, sk, sv, pos, parents):
        return jt[pos][cur[:, 0] % R], sk[parents], sv

    jrun = jax.jit(jax_fused_beam(jdecode, jcfg, V, MAXLEN))
    want, wlen = jrun(jnp.zeros((k,)), jnp.zeros((k,)))
    tt = torch.from_numpy(table)
    seen = []

    def decode(cur, sk, sv, pos, parents):
        seen.append(parents.clone())
        return tt[pos][cur[:, 0] % R], sk[parents], sv

    got, glen = build_fused_beam(decode, cfg, V, MAXLEN)(torch.zeros(k), torch.zeros(k))
    assert glen == int(wlen)
    assert got[:glen].tolist() == np.asarray(want)[:glen].tolist()
    assert torch.equal(seen[0], torch.arange(k))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("ci", range(4))
def test_host_beam_search_equals_jax(seed, ci):
    kw = _cfgs()[ci]
    table = _script(seed, coarse=seed % 2 == 1)

    def step_fn(tokens, pos, parents):
        return table[pos][np.asarray(tokens) % R]

    streamed = {"jax": [], "torch": []}
    want = jbeam.beam_search(step_fn, jbeam.BeamSearchConfig(**kw), streamed["jax"].append)
    got = tbeam.beam_search(step_fn, tbeam.BeamSearchConfig(**kw), streamed["torch"].append)
    assert got.tokens == want.tokens and got.score == want.score
    assert streamed["torch"] == streamed["jax"]


# ---------------------------------------------------------------------------
# Seq2SeqLM: both loops over the model's decode step, against the JAX package
# ---------------------------------------------------------------------------

def _beam_cfg(cfg, k=3, max_length=12, min_length=2, ngram=3, lp=2.0):
    return dict(num_beams=k, max_length=max_length, min_length=min_length,
                length_penalty=lp, early_stopping=True, no_repeat_ngram_size=ngram,
                eos_token_id=cfg.eos_token_id,
                decoder_start_token_id=cfg.decoder_start_token_id,
                forced_bos_token_id=getattr(cfg, "forced_bos_token_id", None),
                forced_eos_token_id=getattr(cfg, "forced_eos_token_id", None))


def _jax_host_tokens(lm, kw, enc_ids, enc_mask):
    """The JAX package's host loop over its jitted step (its tests' recipe)."""
    bs = jbeam.BeamSearchConfig(**kw)
    from kjarni_tpu.core.bucketing import seq_bucket
    _, ck, cv = lm._encode_and_cross(lm.params, jnp.asarray(enc_ids), jnp.asarray(enc_mask))
    k = bs.num_beams
    ck, cv = jnp.repeat(ck, k, axis=1), jnp.repeat(cv, k, axis=1)
    bm = jnp.repeat(jnp.asarray(enc_mask), k, axis=0)
    sk, sv = lm.family.init_self_cache(lm.config, k,
                                       seq_bucket(bs.max_length + 1, lm.max_decode_len))
    state = {"sk": sk, "sv": sv}

    def step_fn(tokens, pos, parents):
        logits, state["sk"], state["sv"] = lm._step(
            lm.params, jnp.asarray(tokens[:, None]), state["sk"], state["sv"],
            ck, cv, bm, jnp.int32(pos), jnp.asarray(parents))
        return logits

    return jbeam.beam_search(step_fn, bs).tokens


@pytest.fixture(scope="module")
def jax_lms():
    """family -> one JAX Seq2SeqLM whose params each case swaps for its own
    checkpoint's: its jitted step and fused loop take the params as an
    argument, so the checkpoints of one config share their compiles."""
    return {}


@pytest.mark.parametrize("family,seed", [("bart", 3), ("bart", 4), ("bart", 8),
                                         ("bart", 15), ("t5", 5)])
def test_seq2seq_beam_loops_equal_jax(tmp_path, jax_lms, family, seed):
    from helpers import build_word_tokenizer
    if family == "bart":
        bart_checkpoint(tmp_path, seed=seed, with_tokenizer=True)
        enc_ids = np.array([[0, 5, 9, 13, 2]], dtype=np.int32)
    else:
        t5_checkpoint(tmp_path, gated=True, seed=seed)
        build_word_tokenizer(tmp_path / "tokenizer.json", bert_style=False)
        enc_ids = np.array([[5, 9, 23, 13, 1]], dtype=np.int32)
    enc_mask = np.ones_like(enc_ids)
    fresh = JaxSeq2SeqLM(tmp_path)
    jlm = jax_lms.setdefault(family, fresh)
    assert jlm.config == fresh.config
    jlm.params = fresh.params
    lm = Seq2SeqLM(tmp_path, device="cpu")
    kw = _beam_cfg(lm.config)
    want_fused = jlm._generate_fused(jbeam.BeamSearchConfig(**kw), jnp.asarray(enc_ids),
                                     jnp.asarray(enc_mask))
    want_host = _jax_host_tokens(jlm, kw, enc_ids, enc_mask)
    bs = tbeam.BeamSearchConfig(**kw)
    assert lm._generate_fused(bs, _t(enc_ids), _t(enc_mask)) == want_fused
    streamed = []
    assert lm._generate_host(bs, _t(enc_ids), _t(enc_mask), streamed.append) == want_host
    assert len(streamed) >= 1
