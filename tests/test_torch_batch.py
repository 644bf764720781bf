"""The port's batched generation against the JAX package's, on the CPU.

`DecoderLM.generate_batch` over the tiny llama checkpoint of
tests/test_torch_generation.py (2 layers, hidden 256, so int4 takes the
grouped form), both packages in f32. Each row's greedy ids must equal the
JAX package's `generate_batch` and the port's unbatched `generate` exactly,
over ragged prompts, a shared prefix above and below the 16-token reuse
minimum, identical prompts, a stop token mid-segment and decode segments
across a small `_kv_bucket_step`, with bf16-layout (f32 here), int4 and int8
weights and the int8 KV cache. Decoding spells the ids, so texts compare ids.
"""

import dataclasses

import pytest
import torch

from test_torch_generation import llama_dir  # noqa: F401  (the shared checkpoint)

from kjarni_tpu.generate.sampling import GenerationConfig as JaxGenerationConfig
from kjarni_tpu.models.decoder_lm import DecoderLM as JaxDecoderLM
from kjarni_tpu_torch.generate.sampling import GenerationConfig, SamplingParams
from kjarni_tpu_torch.models.decoder_lm import DecoderLM

WORDS = ("hello world the doctor and the nurse love this great product it is "
         "safe data was the best purchase ever made i hate mondays").split()
MODES = {"f32": {}, "int4": dict(quantize="int4"), "int8": dict(quantize="int8"),
         "kv_int8": dict(kv_cache="int8")}


def _words(start, n):
    return " ".join(WORDS[(start + i) % len(WORDS)] for i in range(n))


PREFIX = _words(0, 20)          # 21 tokens with BOS: above the reuse minimum
SHORT = _words(0, 10)           # 11 tokens with BOS: below it
PROMPTS = {
    "ragged": [_words(3, 4), _words(7, 17), _words(1, 30)],
    "shared_long": [f"{PREFIX} {_words(5, 3)}", f"{PREFIX} {_words(9, 9)}",
                    f"{PREFIX} {_words(2, 14)}"],
    "shared_short": [f"{SHORT} {_words(5, 3)}", f"{SHORT} {_words(9, 12)}"],
    "identical": [_words(4, 25)] * 3,
}
PREFIX_LEN = {"ragged": 0, "shared_long": 21, "shared_short": 0, "identical": 25}


class Ids:
    """The model's tokenizer, but decode spells the ids, so that comparing
    two generate texts compares their token ids."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

    def encode(self, *args, **kw):
        return self.tokenizer.encode(*args, **kw)

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(t)) for t in ids)


def _pair(d, mode, **extra):
    jlm = JaxDecoderLM(d, **MODES[mode], **extra)
    tlm = DecoderLM(d, device="cpu", **MODES[mode], **extra)
    jlm.tokenizer, tlm.tokenizer = Ids(jlm.tokenizer), Ids(tlm.tokenizer)
    return jlm, tlm


@pytest.fixture(scope="module")
def lms(llama_dir):   # noqa: F811
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = _pair(llama_dir, mode)
        return cache[mode]
    return get


def _greedy(n=16, jax=False):
    cls = JaxGenerationConfig if jax else GenerationConfig
    return cls.greedy(max_new_tokens=n, max_length=128)


# every prompt kind in f32; each quantized mode with and without a shared prefix
CASES = [("f32", kind) for kind in PROMPTS] + [
    (mode, kind) for mode in ("int4", "int8", "kv_int8") for kind in ("ragged", "shared_long")]


@pytest.mark.parametrize("mode,kind", CASES)
def test_generate_batch_matches_jax_and_single(lms, mode, kind):
    jlm, tlm = lms(mode)
    prompts = PROMPTS[kind]
    got = tlm.generate_batch(prompts, config=_greedy())
    assert got == jlm.generate_batch(prompts, config=_greedy(jax=True))
    assert tlm._batch_prefix_len == jlm._batch_prefix_len == PREFIX_LEN[kind]
    assert len(got) == len(prompts) and all(len(r.split()) <= 16 for r in got)
    assert got == [tlm.generate(p, config=_greedy()) for p in prompts]


@pytest.mark.parametrize("mode", ["f32", "kv_int8"])
def test_stop_token_ends_one_row_mid_segment(llama_dir, mode):   # noqa: F811
    """A stop id drawn by one row at its 5th step or later: that row emits nothing
    more (the JAX package's -1), the others run on, as in the reference."""
    jlm, tlm = _pair(llama_dir, mode)
    prompts = PROMPTS["ragged"]
    row = tlm.generate_batch(prompts, config=_greedy(24))[1].split()
    j = next(j for j in range(4, len(row)) if row[j] not in row[:j])
    jlm.stop_token_ids = tlm.stop_token_ids = {int(row[j])}
    got = tlm.generate_batch(prompts, config=_greedy(24))
    assert got == jlm.generate_batch(prompts, config=_greedy(24, jax=True))
    assert got[1] == " ".join(row[:j])
    assert any(len(r.split()) > j for r in got)
    assert got == [tlm.generate(p, config=_greedy(24)) for p in prompts]


@pytest.mark.parametrize("mode", ["f32", "int8", "kv_int8"])
def test_kv_bucket_segments_match_jax(llama_dir, mode):   # noqa: F811
    """Decode reading 16-slot buckets of the cache: the same ids as the JAX
    package's 16-slot segments and as the port's whole-cache decode."""
    jlm, tlm = _pair(llama_dir, mode)
    _, whole = _pair(llama_dir, mode)
    jlm._kv_bucket_step = tlm._kv_bucket_step = 16
    prompts = PROMPTS["shared_long"]
    got = tlm.generate_batch(prompts, config=_greedy(40))
    assert got == jlm.generate_batch(prompts, config=_greedy(40, jax=True))
    assert got == whole.generate_batch(prompts, config=_greedy(40))


def test_penalties_in_batch_match_jax_and_single(lms):
    """A repetition penalty and an n-gram ban read each row's own history
    in batched decode: the same ids as the JAX package's vmapped chain and
    as the port's unbatched generate."""
    jlm, tlm = lms("f32")
    kw = dict(repetition_penalty=1.3, no_repeat_ngram_size=2)
    cfg = GenerationConfig.greedy(max_new_tokens=24, max_length=128, **kw)
    prompts = PROMPTS["shared_long"]
    got = tlm.generate_batch(prompts, config=cfg)
    assert got == jlm.generate_batch(prompts, config=JaxGenerationConfig.greedy(
        max_new_tokens=24, max_length=128, **kw))
    assert got == [tlm.generate(p, config=cfg) for p in prompts]


def test_sampled_batch_is_seeded_and_rows_are_independent(lms):
    _, tlm = lms("f32")
    cfg = GenerationConfig(max_new_tokens=12, max_length=128, seed=7,
                           sampling=SamplingParams(temperature=1.0, top_k=20,
                                                   top_p=0.95, min_p=0.01))
    prompts = PROMPTS["ragged"]
    first = tlm.generate_batch(prompts, config=cfg)
    assert first == tlm.generate_batch(prompts, config=cfg)
    assert all(row for row in first)
    other = tlm.generate_batch(prompts, config=dataclasses.replace(cfg, seed=8))
    assert other != first


def test_generate_batch_edges(lms):
    _, tlm = lms("f32")
    assert tlm.generate_batch([]) == []
    assert tlm.generate_batch(["hello"], config=_greedy(0)) == [""]
    assert tlm.last_batch_steps == 0


def test_batched_forward_rows_equal_single_forwards(llama_dir):   # noqa: F811
    """llama.forward with per-row positions and a pad mask: each
    left-padded row's logits equal the unpadded row's alone (atol 1e-3)."""
    from kjarni_tpu_torch.models import llama as tl
    lm = DecoderLM(llama_dir, device="cpu")
    rows = [lm.encode_prompt(p) for p in PROMPTS["ragged"]]
    S = max(len(r) for r in rows)
    ids = torch.zeros(len(rows), S, dtype=torch.long)
    positions = torch.zeros(len(rows), S, dtype=torch.long)
    pad = torch.zeros(len(rows), 64, dtype=torch.long)
    for r, row in enumerate(rows):
        ids[r, S - len(row):] = torch.tensor(row)
        positions[r, S - len(row):] = torch.arange(len(row))
        pad[r, S - len(row):] = 1
    pad[:, S:] = 1
    ck, cv = tl.init_cache(lm.config, len(rows), 64)
    got, _, _ = tl.forward(lm.params, lm.config, ids, ck, cv, 0, positions=positions,
                           pad_mask=pad)
    for r, row in enumerate(rows):
        ck, cv = tl.init_cache(lm.config, 1, 64)
        want, _, _ = tl.forward(lm.params, lm.config, torch.tensor([row]), ck, cv, 0)
        torch.testing.assert_close(got[r], want[0], atol=1e-3, rtol=0)
