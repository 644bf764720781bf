"""The port's GPT-2 against the JAX package's, on the CPU, in f32.

A tiny HF GPT-2 checkpoint at tests/test_generation.py's gpt2_dir geometry
(n_embd 48, 2 layers, 4 heads, 128 positions, the word tokenizer), with
larger weights than HF's init so greedy choices are not near-ties. Forward
logits and caches at atol 1e-3 (prefill, then decode; also over params
converted from the JAX package's dict); greedy generate, generate_stream
and generate_batch ids exactly equal; the family's options as in the JAX
package: int8 weights ignored, the int8 KV cache refused, no flash.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import build_word_tokenizer, save_torch_model
from test_torch_batch import Ids

from kjarni_tpu.generate.sampling import GenerationConfig as JaxGenerationConfig
from kjarni_tpu.models import gpt2 as jg2
from kjarni_tpu.models.decoder_lm import DecoderLM as JaxDecoderLM
from kjarni_tpu.weights.safetensors_loader import ModelWeights as JaxWeights
from kjarni_tpu_torch.core.errors import InvalidConfigError
from kjarni_tpu_torch.generate.sampling import GenerationConfig
from kjarni_tpu_torch.models import gpt2 as tg2
from kjarni_tpu_torch.models.decoder_lm import DecoderLM
from kjarni_tpu_torch.weights.convert import params_from_jax
from kjarni_tpu_torch.weights.safetensors_loader import ModelWeights

ATOL = 1e-3
PROMPTS = ["hello world the doctor", "the nurse love this great product it is safe data",
           "i hate mondays"]


@pytest.fixture(scope="module")
def gpt2_dir(tmp_path_factory):
    from transformers import GPT2Config, GPT2LMHeadModel
    d = tmp_path_factory.mktemp("torch_gpt2_lm")
    vocab_map = build_word_tokenizer(d / "tokenizer.json", bert_style=False)
    config = GPT2Config(vocab_size=len(vocab_map), n_embd=48, n_layer=2,
                        n_head=4, n_positions=128, bos_token_id=2,
                        eos_token_id=3)
    torch.manual_seed(11)
    model = GPT2LMHeadModel(config).eval()
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 2:
                p.normal_(0.0, 0.1)
    save_torch_model(d, model, config)
    return d


@pytest.fixture(scope="module")
def both(gpt2_dir):
    import json
    hf = json.loads((gpt2_dir / "config.json").read_text())
    cfg_j, cfg_t = jg2.Gpt2Config.from_hf(hf), tg2.Gpt2Config.from_hf(hf)
    return (cfg_j, jg2.load_params(JaxWeights(gpt2_dir), cfg_j),
            cfg_t, tg2.load_params(ModelWeights(gpt2_dir), cfg_t))


def _ids(n, seed, vocab=39):
    return np.random.default_rng(seed).integers(0, vocab, (1, n)).astype(np.int32)


def _run(fwd, init, cfg, params, chunks, to):
    ck, cv = init(cfg, 1, 64)
    pos = 0
    for ids in chunks:
        lg, ck, cv = fwd(params, cfg, to(ids), ck, cv, pos)
        pos += ids.shape[1]
    return np.asarray(lg), np.asarray(ck)


@pytest.mark.parametrize("params_from", ["checkpoint", "jax_dict"])
@pytest.mark.parametrize("case", ["prefill", "prefill_then_decode"])
def test_forward_matches_jax(both, case, params_from):
    cfg_j, p_j, cfg_t, p_t = both
    if params_from == "jax_dict":   # the JAX package's names, carried across
        p_t = params_from_jax(p_j)
        assert set(p_t["layers"]) == set(p_j["layers"]) and "wpe" in p_t
    assert torch.is_tensor(p_t["lm_head"]) and p_t["lm_head"].shape == (48, 39)
    chunks = {"prefill": [_ids(20, 1)], "prefill_then_decode": [_ids(20, 2), _ids(1, 3)]}[case]
    lg_j, ck_j = _run(jg2.forward, jg2.init_cache, cfg_j, jax.tree.map(jnp.asarray, p_j),
                      chunks, jnp.asarray)
    lg_t, ck_t = _run(tg2.forward, tg2.init_cache, cfg_t, p_t, chunks,
                      lambda ids: torch.from_numpy(ids).long())
    np.testing.assert_allclose(lg_t, lg_j, atol=ATOL)
    np.testing.assert_allclose(ck_t, ck_j, atol=ATOL)


def test_all_logits_match_jax(both):
    cfg_j, p_j, cfg_t, p_t = both
    ids = _ids(24, 4)
    ck, cv = jg2.init_cache(cfg_j, 1, 32)
    lg_j, _, _ = jg2.forward_all_logits(jax.tree.map(jnp.asarray, p_j), cfg_j,
                                        jnp.asarray(ids), ck, cv, 0)
    ck, cv = tg2.init_cache(cfg_t, 1, 32)
    lg_t, _, _ = tg2.forward_all_logits(p_t, cfg_t, torch.from_numpy(ids).long(),
                                        ck, cv, 0)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=ATOL)


@pytest.fixture(scope="module")
def lms(gpt2_dir):
    jlm, tlm = JaxDecoderLM(gpt2_dir, max_context=64), DecoderLM(gpt2_dir, device="cpu",
                                                                  max_context=64)
    jlm.tokenizer, tlm.tokenizer = Ids(jlm.tokenizer), Ids(tlm.tokenizer)
    return jlm, tlm


def _greedy(n=12, jax=False):
    return (JaxGenerationConfig if jax else GenerationConfig).greedy(
        max_new_tokens=n, max_length=64)


def test_family_dispatch(lms):
    _, tlm = lms
    assert tlm.family is tg2 and not tlm._flash_ok
    assert tlm.config.arch == "gpt2" and tlm.max_context == 64


def test_generate_and_stream_match_jax(lms):
    jlm, tlm = lms
    for p in PROMPTS:
        assert tlm.generate(p, config=_greedy()) == jlm.generate(p, config=_greedy(jax=True))
        assert tlm._session_ids == jlm._session_ids
    t_ids = [st.id for st in tlm.generate_stream(PROMPTS[1], config=_greedy())]
    j_ids = [st.id for st in jlm.generate_stream(PROMPTS[1], config=_greedy(jax=True))]
    assert t_ids == j_ids and len(t_ids) > 0


@pytest.mark.parametrize("shared", [False, True])
def test_generate_batch_matches_jax_and_single(lms, shared):
    jlm, tlm = lms
    prefix = "the doctor and the nurse love this great product it is safe data was the best "
    prompts = [prefix + p for p in PROMPTS] if shared else PROMPTS
    got = tlm.generate_batch(prompts, config=_greedy())
    assert got == jlm.generate_batch(prompts, config=_greedy(jax=True))
    assert tlm._batch_prefix_len == jlm._batch_prefix_len == (16 if shared else 0)
    assert got == [tlm.generate(p, config=_greedy()) for p in prompts]


def test_int8_weights_are_ignored(gpt2_dir, lms):
    _, tlm = lms
    lm8 = DecoderLM(gpt2_dir, device="cpu", max_context=64, quantize="int8")
    assert torch.is_tensor(lm8.params["lm_head"])
    assert lm8.params["layers"]["c_attn_w"].dtype == torch.float32
    lm8.tokenizer = tlm.tokenizer
    assert lm8.generate(PROMPTS[0], config=_greedy()) == \
        tlm.generate(PROMPTS[0], config=_greedy())


def test_int8_kv_cache_is_refused(gpt2_dir):
    with pytest.raises(InvalidConfigError, match="llama-family"):
        DecoderLM(gpt2_dir, device="cpu", kv_cache="int8")


def test_default_device_is_the_card(gpt2_dir):
    if torch.cuda.is_available():
        assert DecoderLM(gpt2_dir).device.type == "cuda"
    else:
        with pytest.raises(InvalidConfigError, match="device='cpu'"):
            DecoderLM(gpt2_dir)
