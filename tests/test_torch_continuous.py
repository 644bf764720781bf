"""The port's ContinuousEngine against the JAX package's, on the CPU.

The cases of tests/test_continuous.py, parametrised where they repeat, on
the same tiny llama checkpoint (2 layers, hidden 64) loaded into both
packages in f32: every greedy request's ids must equal the JAX engine's and
the port's own single stream exactly (mid-flight joins, more requests than
slots, windows of 1-8 steps, working buckets, the prefix table, chunked
admission, int8 KV, GPT-2, penalties and the n-gram ban). The admission
memory plans must equal the JAX engine's. Sampled slots cannot match
(jax.random vs torch.Generator): top_k = 1 must equal greedy, a seed must
repeat its stream, and every draw must lie in its slot's filter set, which
must equal the JAX engine's filters on the same logits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import build_word_tokenizer, save_torch_model

from kjarni_tpu.core.errors import GenerationError as JaxGenerationError
from kjarni_tpu.generate import continuous as jc
from kjarni_tpu.generate import sampling as js
from kjarni_tpu.models.decoder_lm import DecoderLM as JaxDecoderLM
from kjarni_tpu_torch.core.errors import GenerationError
from kjarni_tpu_torch.generate import continuous as tc
from kjarni_tpu_torch.generate import sampling as ts
from kjarni_tpu_torch.models.decoder_lm import DecoderLM

PROMPTS = ["hello world", "the doctor went to", "data is safe with",
           "mondays are great for", "keeping the physician"]
PREFIX = "hello world the"
SAMPLED = dict(temperature=0.9, top_k=20, top_p=0.95, min_p=0.0)


def _llama_dir(d, max_pos):
    from transformers import LlamaConfig, LlamaForCausalLM
    vocab_map = build_word_tokenizer(d / "tokenizer.json", bert_style=False)
    config = LlamaConfig(vocab_size=len(vocab_map), hidden_size=64,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=max_pos, bos_token_id=2,
                         eos_token_id=3, tie_word_embeddings=False)
    torch.manual_seed(11)
    save_torch_model(d, LlamaForCausalLM(config).eval(), config)
    return d


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    return _llama_dir(tmp_path_factory.mktemp("torch_cont_lm"), 128)


class Pkg:
    """One package's engine, model, sampling types and single stream."""

    def __init__(self, mod, lm, sampling, max_length):
        self.Engine, self.lm, self.sp, self.max_length = \
            mod.ContinuousEngine, lm, sampling, max_length

    def sampling(self, **kw):
        return self.sp.SamplingParams(**kw)

    def single(self, prompt=None, n=8, token_ids=None, **kw):
        cfg = self.sp.GenerationConfig.greedy(max_new_tokens=n,
                                              max_length=self.max_length, **kw)
        return [st.id for st in self.lm.generate_stream(prompt, token_ids=token_ids,
                                                        config=cfg)]


@pytest.fixture(scope="module")
def pkgs(lm_dir):
    cache = {}

    def get(kv=None):
        if kv not in cache:
            cache[kv] = (Pkg(jc, JaxDecoderLM(lm_dir, max_context=96, kv_cache=kv), js, 96),
                         Pkg(tc, DecoderLM(lm_dir, max_context=96, kv_cache=kv,
                                           device="cpu"), ts, 96))
        return cache[kv]
    return get


def _run(eng, reqs):
    """Submit (prompt, max_new, kw) requests and run; ids per request."""
    rids = [eng.submit(p, max_new_tokens=n, **kw) for p, n, kw in reqs]
    done = {fr.request_id: fr.token_ids for fr in eng.run()}
    return [done[r] for r in rids]


# (slots, requests, steps taken before the late request, late request, engine kwargs)
SCENARIOS = {
    "batch": (4, [(p, 8, {}) for p in PROMPTS[:4]], 0, None, {}),
    "more_requests_than_slots": (2, [(p, 6, {}) for p in PROMPTS], 0, None, {}),
    "midflight_join": (4, [(PROMPTS[0], 12, {}), (PROMPTS[1], 12, {})], 5,
                       (PROMPTS[2], 8), {}),
    "join_at_window_boundary": (2, [(PROMPTS[0], 16, {})], 1, (PROMPTS[1], 8),
                                dict(steps_per_sync=4)),
    "window_4_greedy": (2, [(PROMPTS[3], 10, {})], 0, None, dict(steps_per_sync=4)),
    "prefix_hit": (2, [(PREFIX + " doctor went", 8, {}), (PREFIX + " data", 8, {})], 0,
                   None, dict(prefixes=[PREFIX])),
    "prefix_mixed_wave": (4, [(PREFIX + " doctor went", 6, dict(defer_admit=True)),
                              ("mondays are great for", 6, dict(defer_admit=True)),
                              (PREFIX + " physician", 6, dict(defer_admit=True)),
                              ("data is safe with", 6, dict(defer_admit=True))], 0, None,
                          dict(prefixes=[PREFIX])),
    "prefix_equal_to_prompt": (2, [(PREFIX, 6, {})], 0, None, dict(prefixes=[PREFIX])),
    "two_prefixes": (4, [(PREFIX + " doctor went", 6, dict(defer_admit=True)),
                         ("data is safe with mondays", 6, dict(defer_admit=True)),
                         (PREFIX + " physician", 6, dict(defer_admit=True)),
                         ("data is safe with doctor", 6, dict(defer_admit=True))], 0,
                     None, dict(prefixes=[PREFIX, "data is safe with"])),
    "longest_prefix_wins": (2, [("hello world the doctor went to", 6, {})], 0, None,
                            dict(prefixes=["hello world", "hello world the doctor went"])),
}


def _scenario(pkg, name, kv_step=None):
    slots, reqs, steps, late, kw = SCENARIOS[name]
    kw = dict(kw)
    prefixes = kw.pop("prefixes", [])
    eng = pkg.Engine(pkg.lm, slots=slots, **kw)
    if kv_step:
        eng._kv_bucket_step = kv_step
    for p in prefixes:
        assert eng.register_prefix(p) > 0
    rids = [eng.submit(p, max_new_tokens=n, **k) for p, n, k in reqs]
    for _ in range(steps):
        eng.step()
    if late:
        rids.append(eng.submit(late[0], max_new_tokens=late[1]))
    done = {fr.request_id: fr for fr in eng.run()}
    prompts = [r[0] for r in reqs] + ([late[0]] if late else [])
    return ([done[r].token_ids for r in rids], [done[r].finish_reason for r in rids],
            prompts, [n for _, n, _ in reqs] + ([late[1]] if late else []), eng)


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_ids_equal_jax_engine_and_single_stream(pkgs, name, kv):
    jp, tp = pkgs(kv)
    j_ids, j_fin, prompts, ns, j_eng = _scenario(jp, name)
    t_ids, t_fin, _, _, t_eng = _scenario(tp, name)
    assert t_ids == j_ids and t_fin == j_fin
    for ids, p, n in zip(t_ids, prompts, ns):
        assert ids == tp.single(p, n), p
    assert t_eng.stats == j_eng.stats
    assert t_eng._admit_plans == {(b, m, t_eng.S): p for (b, m), p in j_eng._admit_plans.items()}


@pytest.mark.parametrize("kv", [None, "int8"])
def test_working_buckets_match_full_cache(pkgs, kv):
    """A shrunk _kv_bucket_step crosses several working slices mid-decode
    and re-admits freed slots under small buckets; ids equal the unbucketed
    engine's and the JAX engine's."""
    jp, tp = pkgs(kv)
    for name in ("batch", "more_requests_than_slots"):
        full = _scenario(tp, name)[0]
        assert _scenario(tp, name, kv_step=8)[0] == full == _scenario(jp, name, kv_step=8)[0]


def test_finish_reason_text_and_refusals(pkgs):
    jp, tp = pkgs()
    eng = tp.Engine(tp.lm, slots=2)
    eng.submit(PROMPTS[0], max_new_tokens=4)
    (fr,) = eng.run()
    assert fr.finish_reason in ("eos", "length")
    assert fr.text == tp.lm.tokenizer.decode(fr.token_ids)
    for pkg, err in ((jp, JaxGenerationError), (tp, GenerationError)):
        e = pkg.Engine(pkg.lm, slots=2)
        with pytest.raises(err, match="exceeds slot capacity"):
            e.submit("hello " * 200, max_new_tokens=64)
        with pytest.raises(err, match="no_repeat_ngram_size"):
            e.submit("hello", no_repeat_ngram=True)
        e = pkg.Engine(pkg.lm, slots=2, max_prefixes=1)
        e.register_prefix(PREFIX)
        assert e.register_prefix(PREFIX) > 0 and len(e._prefixes) == 1   # idempotent
        with pytest.raises(err, match="prefix table is full"):
            e.register_prefix("data is safe with")


def test_capacity_reserves_window_overshoot(pkgs):
    for pkg, err in zip(pkgs(), (JaxGenerationError, GenerationError)):
        eng = pkg.Engine(pkg.lm, slots=1, max_context=32, steps_per_sync=8)
        eng.submit("hello world", max_new_tokens=17)     # 3 + 16 + 8 <= 32
        with pytest.raises(err, match="exceeds slot capacity"):
            eng.submit("hello world", max_new_tokens=26)   # 3 + 25 + 8 > 32
        eng.run()


def test_window_invariance_with_a_sampled_slot(pkgs):
    """Windows of 1, 3 and 8 steps give the same ids, the sampled slot's
    included (its generator draws once per step it decodes); the greedy
    slots equal the JAX engine's."""
    jp, tp = pkgs()

    def run(pkg, k):
        eng = pkg.Engine(pkg.lm, slots=3, steps_per_sync=k)
        return _run(eng, [(PROMPTS[0], 9, {}),
                          (PROMPTS[1], 13, dict(sampling=pkg.sampling(
                              temperature=0.8, top_k=10, top_p=0.95, min_p=0.0), seed=7)),
                          (PROMPTS[2], 5, {})])

    t1 = run(tp, 1)
    assert t1 == run(tp, 8) == run(tp, 3)
    j8 = run(jp, 8)
    assert (t1[0], t1[2]) == (j8[0], j8[2])


def test_prefix_bucket_capped_at_capacity(pkgs):
    """A suffix whose bucket would overrun the slot at pos_start = m is
    capped, as in the JAX engine."""
    from kjarni_tpu_torch.core.bucketing import seq_bucket
    prefix = "hello world the doctor went to keeping the physician"
    prompt = prefix + " " + " ".join(["data is safe with mondays"] * 13)
    out = []
    for pkg in pkgs():
        eng = pkg.Engine(pkg.lm, slots=1, max_context=96, steps_per_sync=4)
        n = eng.register_prefix(prefix)
        ids = pkg.lm.encode_prompt(prompt, add_bos=True)
        assert n + seq_bucket(len(ids) - n) > 96
        out.append(_run(eng, [(prompt, 4, {})])[0])
    assert out[0] == out[1] == pkgs()[1].single(prompt, 4)


BASE_A = " ".join(["hello world the doctor went"] * 7)   # ~36 tokens
BASE_B = " ".join(["data is safe with mondays"] * 7)


@pytest.mark.parametrize("prompts,min_len,cap,learned", [
    ([BASE_A + " data is safe", BASE_A + " mondays are great",
      BASE_A + " keeping the physician"], 16, 8, 1),
    (["hello world the", "hello world the doctor"], 16, 8, 0),
    ([BASE_A + " data", BASE_A + " mondays"], 0, 8, 0),
    ([BASE_A + " data", BASE_A + " mondays", BASE_B + " hello", BASE_B + " doctor"], 16, 8, 2),
    ([BASE_A + " data", BASE_A + " mondays", BASE_B + " hello", BASE_B + " doctor"], 16, 1, 1),
], ids=["learns", "below_threshold", "disabled", "learns_two", "stops_at_cap"])
def test_auto_prefix(pkgs, prompts, min_len, cap, learned):
    outs, tables = [], []
    for pkg in pkgs():
        eng = pkg.Engine(pkg.lm, slots=2, auto_prefix_min=min_len, max_prefixes=cap)
        outs.append(_run(eng, [(p, 4, {}) for p in prompts]))
        tables.append([ids for ids, _ in eng._prefixes])
        assert eng.stats["prefix_hits"] >= (1 if learned else 0)
    assert len(tables[1]) == learned and tables[0] == tables[1]
    assert outs[0] == outs[1] == [pkgs()[1].single(p, 4) for p in prompts]


def test_equal_length_prefixes_share_a_plan(pkgs):
    """Two prefixes of one length admit under one (bucket, m) plan."""
    for pkg in pkgs():
        eng = pkg.Engine(pkg.lm, slots=2)
        assert eng.register_prefix(PREFIX) == eng.register_prefix("data is safe")
        _run(eng, [(PREFIX + " doctor went", 4, {}), ("data is safe mondays are", 4, {})])
        assert len([k for k in eng._admit_plans if k[1] > 0]) == 1


class TestSampledSlots:
    def test_top_k_one_equals_greedy(self, pkgs):
        _, tp = pkgs()
        eng = tp.Engine(tp.lm, slots=2)
        ids = _run(eng, [(PROMPTS[3], 8, dict(sampling=tp.sampling(
            temperature=1.3, top_k=1, top_p=0.99, min_p=0.0)))])
        assert ids[0] == tp.single(PROMPTS[3], 8)

    @pytest.mark.parametrize("kv", [None, "int8"])
    def test_seed_repeats_and_greedy_slot_exact(self, pkgs, kv):
        jp, tp = pkgs(kv)

        def run(with_prefix=False):
            eng = tp.Engine(tp.lm, slots=3)
            if with_prefix:
                eng.register_prefix("the doctor")
            return _run(eng, [(PROMPTS[0], 8, {}),
                              (PROMPTS[1], 8, dict(sampling=tp.sampling(**SAMPLED), seed=42)),
                              (PROMPTS[2], 8, dict(sampling=tp.sampling(**SAMPLED), seed=43))])

        a, b = run(), run()
        assert a == b and a[1] != a[2]
        assert run(with_prefix=True) == a       # a prefix hit draws the same stream
        assert a[0] == jp.single(PROMPTS[0], 8) == tp.single(PROMPTS[0], 8)
        assert all(0 <= t < tp.lm.config.vocab_size for t in a[1])

    def test_filters_equal_jax_and_draws_lie_in_them(self, monkeypatch):
        """_filter_slots against the JAX engine's per-slot filter chain (its
        _sample_slot's sampled branch) on the same logits, one parameter set
        per row; then every draw of _sample_slot lies in its row's set."""
        rng = np.random.default_rng(0)
        V = 300
        logits = (rng.standard_normal((5, V)) * 3).astype(np.float32)
        top_k = np.array([0, 1, 20, 299, 50])
        top_p = np.array([0.9, 0.5, 0.99, 0.3, 0.95], np.float32)
        min_p = np.array([0.0, 0.1, 0.05, 0.0, 0.2], np.float32)

        def jax_mask(l, k, p, mp):
            srt = jnp.sort(l)[::-1]
            kth = srt[jnp.clip(k - 1, 0, V - 1)]
            l = jnp.where((k > 0) & (l < kth), js.NEG_INF, l)
            return np.asarray(js.min_p_filter(js.top_p_filter(l, p), mp)) > js.NEG_INF / 2

        want = np.stack([jax_mask(jnp.asarray(logits[r]), int(top_k[r]), float(top_p[r]),
                                  float(min_p[r])) for r in range(5)])
        t = {n: torch.from_numpy(a) for n, a in (("k", top_k), ("p", top_p), ("m", min_p))}
        got = tc._filter_slots(torch.from_numpy(logits), t["k"], t["p"], t["m"])
        np.testing.assert_array_equal(got.numpy() > ts.NEG_INF / 2, want)
        gens = [torch.Generator().manual_seed(r) for r in range(5)]
        temp = torch.tensor([0.0, 0.7, 1.0, 1.3, 0.9])
        for _ in range(20):
            tok = tc._sample_slot(torch.from_numpy(logits), gens, [1, 2, 3, 4], temp,
                                  t["k"], t["p"], t["m"])
            assert tok[0] == int(np.argmax(logits[0]))
            for r in range(1, 5):
                assert want[r, tok[r]], (r, int(tok[r]))


class TestPenalties:
    @pytest.mark.parametrize("kind", ["repetition_penalty", "no_repeat_ngram"])
    def test_penalty_slot_matches_jax_and_single_stream(self, pkgs, kind):
        jp, tp = pkgs()
        out = []
        for pkg in (jp, tp):
            if kind == "repetition_penalty":
                eng = pkg.Engine(pkg.lm, slots=2)
                reqs = [(PROMPTS[0], 10, dict(repetition_penalty=1.4)), (PROMPTS[1], 10, {})]
                single = dict(repetition_penalty=1.4)
            else:
                eng = pkg.Engine(pkg.lm, slots=2, no_repeat_ngram_size=2)
                reqs = [(PROMPTS[4], 10, dict(no_repeat_ngram=True)), (PROMPTS[0], 8, {})]
                single = dict(no_repeat_ngram_size=2)
            out.append(_run(eng, reqs))
        assert out[0] == out[1]
        assert out[1][0] == tp.single(reqs[0][0], 10, **single)
        assert out[1][1] == tp.single(reqs[1][0], reqs[1][1])


@pytest.fixture(scope="module")
def big_pkgs(tmp_path_factory):
    """A 1024-slot model: prompt buckets >= 256 divide by 128, so a shrunk
    score gate can pick the chunked plan."""
    d = _llama_dir(tmp_path_factory.mktemp("torch_cont_big"), 1024)
    return (Pkg(jc, JaxDecoderLM(d, max_context=1024), js, 1024),
            Pkg(tc, DecoderLM(d, max_context=1024, device="cpu"), ts, 1024))


LONG_IDS = [[2] + [5 + (i * 7 + s) % 20 for i in range(n)]
            for s, n in ((0, 200), (3, 170), (9, 240))]


def test_chunked_admission_matches_plain_and_jax(big_pkgs):
    outs, plans = [], []
    for pkg in big_pkgs:
        for limit in (None, 1):
            eng = pkg.Engine(pkg.lm, slots=4)
            if limit:
                eng._admit_score_limit = limit     # every 256-bucket wave chunks
            rids = [eng.submit(token_ids=ids, max_new_tokens=8) for ids in LONG_IDS]
            done = {fr.request_id: fr.token_ids for fr in eng.run()}
            outs.append([done[r] for r in rids])
            plans.append({key[:2]: p for key, p in eng._admit_plans.items()})
    assert outs[0] == outs[1] == outs[2] == outs[3]
    assert plans[0] == plans[2] and plans[1] == plans[3]
    assert {p["mode"] for p in plans[3].values()} == {"chunked"}
    assert {p["mode"] for p in plans[2].values()} == {"plain"}
    assert outs[3][2] == big_pkgs[1].single(token_ids=LONG_IDS[2], n=8)


def test_chunked_midflight_join(big_pkgs):
    out = []
    for pkg in big_pkgs:
        eng = pkg.Engine(pkg.lm, slots=4)
        eng._admit_score_limit = 1
        eng.submit(token_ids=LONG_IDS[0], max_new_tokens=12)
        for _ in range(3):
            eng.step()
        late = eng.submit(token_ids=LONG_IDS[2], max_new_tokens=8)
        out.append({fr.request_id: fr for fr in eng.run()}[late].token_ids)
    assert out[0] == out[1] == big_pkgs[1].single(token_ids=LONG_IDS[2], n=8)


@pytest.mark.parametrize("slots,T,flash", [(8, 16384, False), (8, 4096, False),
                                           (4, 8192, False), (8, 4096, True)])
@pytest.mark.parametrize("bucket,m", [(4096, 0), (2048, 256), (512, 256), (128, 0),
                                      (1024, 33)])
def test_admission_plans_equal_jax(big_pkgs, slots, T, flash, bucket, m):
    """The memory plan (mode, chunk, working range, score bytes) of each
    (bucket, m) wave, counted over all S lanes as the JAX engine pads them,
    under a gate shrunk 16x (the tiny model has 4 heads), with and without
    flash."""
    jp, tp = big_pkgs
    je, te = jp.Engine(jp.lm, slots=slots), tp.Engine(tp.lm, slots=slots)
    for e in (je, te):
        e.T = T
        e._flash_ok = flash
        e._admit_score_limit = 125_000_000
    je._admit_fn(bucket, m)
    assert te._admit_plan(bucket, m, 1) == je._admit_plans[(bucket, m)]


class TestGpt2:
    def test_gpt2_engine_matches_jax_and_single_stream(self, tmp_path):
        from transformers import GPT2Config, GPT2LMHeadModel
        d = tmp_path / "gpt2"
        d.mkdir()
        vm = build_word_tokenizer(d / "tokenizer.json", bert_style=False)
        config = GPT2Config(vocab_size=len(vm), n_embd=32, n_layer=2, n_head=2,
                            n_positions=64, bos_token_id=2, eos_token_id=3)
        torch.manual_seed(13)
        save_torch_model(d, GPT2LMHeadModel(config).eval(), config)
        out = []
        pkgs_ = (Pkg(jc, JaxDecoderLM(d, max_context=64), js, 64),
                 Pkg(tc, DecoderLM(d, max_context=64, device="cpu"), ts, 64))
        for pkg in pkgs_:
            eng = pkg.Engine(pkg.lm, slots=2, steps_per_sync=4)
            eng._kv_bucket_step = 16
            out.append(_run(eng, [("hello world", 8, {}), ("the doctor went", 12, {}),
                                  ("data is safe", 6, {})]))
        assert out[0] == out[1]
        assert out[1][1] == pkgs_[1].single("the doctor went", 12)


def test_int8_slot_caches(pkgs):
    _, tp = pkgs("int8")
    eng = tp.Engine(tp.lm, slots=2)
    assert eng.cache_k["q"].dtype == torch.int8 and eng.cache_k["s"].dtype == torch.float32
    assert eng.cache_k["s"].shape == eng.cache_k["q"].shape[:-1]
    assert eng.cache_k["q"].shape[1] == 2          # slots are the batch axis


def test_hist_ring_matches_jax():
    rng = np.random.default_rng(1)
    h = rng.integers(0, 50, (3, tc._HIST_BUF))
    hl = np.array([0, 5, tc._HIST_BUF])
    tok = np.array([7, 8, 9])
    th, thl = tc._hist_append(torch.from_numpy(h), torch.from_numpy(hl), torch.from_numpy(tok))
    for r in range(3):
        jh, jhl = jc._hist_append(jnp.asarray(h[r]), jnp.int32(hl[r]), jnp.int32(tok[r]))
        np.testing.assert_array_equal(th[r].numpy(), np.asarray(jh))
        assert int(thl[r]) == int(jhl)
