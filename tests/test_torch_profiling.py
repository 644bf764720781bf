"""The port's own spans (core/profiling.py) on the CPU, on a tiny llama.

With no profiler running, `annotate` records nothing and the engine and the
single stream leave `spans()` empty. Under `profiling.trace`, the continuous
engine and `generate_stream` record the span tree their modules document:
names, parents, counts that add up to what was admitted and decoded, and
each request's wait from submit to its first token. The spans sit on the
profiler's host timeline as FUNCTION-scope events. `GenerationStats` times
the prefill up to the first token read back, and the decode from there.
"""

import time

import pytest
import torch

from helpers import build_word_tokenizer, save_torch_model

from kjarni_tpu_torch.core import profiling
from kjarni_tpu_torch.core.bucketing import seq_bucket
from kjarni_tpu_torch.core.stats import GenerationStats
from kjarni_tpu_torch.generate.continuous import ContinuousEngine
from kjarni_tpu_torch.generate.sampling import GenerationConfig, SamplingParams
from kjarni_tpu_torch.models import decoder_lm
from kjarni_tpu_torch.models.decoder_lm import DecoderLM

MAX_CONTEXT = 128
LENGTHS = (5, 9, 20, 33, 7, 12)      # prompts of several buckets
NEW = 6


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    from transformers import LlamaConfig, LlamaForCausalLM
    d = tmp_path_factory.mktemp("profiling_llama")
    vocab = build_word_tokenizer(d / "tokenizer.json", bert_style=False)
    config = LlamaConfig(vocab_size=len(vocab), hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=MAX_CONTEXT, bos_token_id=2,
                         eos_token_id=3, tie_word_embeddings=False)
    torch.manual_seed(5)
    save_torch_model(d, LlamaForCausalLM(config).eval(), config)
    model = DecoderLM(d, device="cpu", max_context=MAX_CONTEXT)
    model.stop_token_ids = set()          # every request runs to its budget
    return model


def _prompts(lm):
    g = torch.Generator().manual_seed(3)
    V = lm.config.vocab_size
    return [torch.randint(4, V, (n,), generator=g).tolist() for n in LENGTHS]


def _serve(lm, prompts):
    """(request ids, finished requests, engine): every prompt queued, then
    admitted in the engine's steps."""
    eng = ContinuousEngine(lm, slots=4, steps_per_sync=4)
    rids = [eng.submit(token_ids=p, max_new_tokens=NEW, defer_admit=True,
                       sampling=SamplingParams(temperature=0.8, top_p=0.9) if i % 2 else None)
            for i, p in enumerate(prompts)]
    return rids, eng.run(), eng


def _stream(lm, ids, n=NEW):
    cfg = GenerationConfig.greedy(max_new_tokens=n, max_length=MAX_CONTEXT)
    lm._session_ids = []                  # no prefix reused from an earlier request
    return [st.id for st in lm.generate_stream(token_ids=ids, config=cfg)]


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_nothing_is_recorded_without_a_profiler(lm):
    profiling.reset()
    with profiling.annotate("kjarni.test", device=True, a=1) as sp:
        sp.count(b=2)
    assert not sp and profiling.annotate("kjarni.other") is sp
    assert profiling.recording() is False
    _serve(lm, _prompts(lm)[:3])
    _stream(lm, _prompts(lm)[0], 3)
    assert profiling.spans() == []


def test_engine_records_its_span_tree(lm, tmp_path):
    prompts = _prompts(lm)
    with profiling.trace(tmp_path):
        rids, finished, eng = _serve(lm, prompts)
    spans = profiling.spans()
    by, ids = _by_name(spans), {s.id: s for s in spans}
    assert {"kjarni.engine.step", "kjarni.engine.admit_wave", "kjarni.engine.decode",
            "kjarni.engine.readback", "kjarni.engine.deliver", "kjarni.engine.first_token",
            "kjarni.forward"} == set(by)
    assert all(s.parent is None for s in by["kjarni.engine.step"])
    for name in ("admit_wave", "decode", "readback", "deliver"):
        assert {ids[s.parent].name for s in by[f"kjarni.engine.{name}"]} == \
            {"kjarni.engine.step"}, name
    assert {ids[s.parent].name for s in by["kjarni.forward"]} == \
        {"kjarni.engine.admit_wave", "kjarni.engine.decode"}
    assert all(s.start_ns <= s.end_ns and s.device_ms is None for s in spans)

    # the waves admitted every prompt, each padded to its bucket
    waves = by["kjarni.engine.admit_wave"]
    assert len(waves) == eng.stats["admission_waves"]
    assert sum(w.counts["lanes"] for w in waves) == len(prompts)
    assert sum(w.counts["prompt_tokens"] for w in waves) == sum(LENGTHS)
    assert sorted(b for w in waves for b in [w.counts["bucket"]] * w.counts["lanes"]) == \
        sorted(seq_bucket(n, MAX_CONTEXT) for n in LENGTHS)

    # one decode span a window, whose k are the forwards run under it
    decodes = by["kjarni.engine.decode"]
    assert len(decodes) == len(by["kjarni.engine.readback"]) == eng.stats["windows"]
    under = {}
    for f in by["kjarni.forward"]:
        under[f.parent] = under.get(f.parent, 0) + 1
    assert [under[d.id] for d in decodes] == [d.counts["k"] for d in decodes]
    assert all(0 < d.counts["active"] <= d.counts["S"] == 4 for d in decodes)
    assert all(s.counts == {} for name in ("step", "readback", "deliver")
               for s in by[f"kjarni.engine.{name}"])

    # one record a request, from its submit to the readback of its first
    # token, made in the window that delivered it
    firsts = by["kjarni.engine.first_token"]
    assert len(firsts) == len(rids) == len(finished)
    for r in firsts:
        assert r.start_ns < r.end_ns and r.counts == {}
        deliver = ids[r.parent]
        assert deliver.name == "kjarni.engine.deliver"
        (read,) = [s for s in by["kjarni.engine.readback"] if s.parent == deliver.parent]
        assert read.end_ns <= r.end_ns <= deliver.start_ns
    assert sorted(r.start_ns for r in firsts) == [r.start_ns for r in firsts]


def test_stream_records_its_span_tree(lm, tmp_path):
    ids_in = _prompts(lm)[3]
    with profiling.trace(tmp_path):
        toks = _stream(lm, ids_in)
    spans = profiling.spans()
    by, ids = _by_name(spans), {s.id: s for s in spans}
    (req,) = by["kjarni.stream.request"]
    assert req.parent is None and list(req.counts) == ["first_token_ns"]
    assert len(toks) == NEW
    assert req.start_ns < req.counts["first_token_ns"] < req.end_ns
    for name in ("start", "prefill"):
        (s,) = by[f"kjarni.stream.{name}"]
        assert s.parent == req.id
    (pre,) = by["kjarni.stream.prefill"]
    assert pre.counts == {"prompt_tokens": len(ids_in),
                          "bucket": seq_bucket(len(ids_in), MAX_CONTEXT)}
    assert pre.device_ms is None and pre.end_ns < req.counts["first_token_ns"]
    steps = by["kjarni.stream.decode_step"]
    assert len(steps) == NEW and all(s.parent == req.id and s.counts == {} for s in steps)
    # the first token is stamped at its sync, inside the first step, before
    # that step enqueues the next forward
    first_fwd = next(f for f in by["kjarni.forward"] if f.parent == steps[0].id)
    assert steps[0].start_ns < req.counts["first_token_ns"] < first_fwd.start_ns
    fwd = by["kjarni.forward"]
    assert [ids[f.parent].name for f in fwd] == \
        ["kjarni.stream.prefill"] + ["kjarni.stream.decode_step"] * NEW
    assert all(f.counts == {} for f in fwd)


def test_spans_are_function_scope_host_events(lm, tmp_path):
    with profiling.trace(tmp_path) as prof:
        _serve(lm, _prompts(lm)[:2])
        _stream(lm, _prompts(lm)[1], 2)
    ours = [e for e in prof.events() if e.name.startswith("kjarni.")]
    names = {e.name for e in ours}
    assert {"kjarni.engine.step", "kjarni.stream.prefill", "kjarni.forward"} <= names
    assert all(e.scope == 0 and e.device_type == torch.autograd.DeviceType.CPU
               and not e.is_user_annotation for e in ours)
    # the first-token records are the program's only, not the profiler's
    assert "kjarni.engine.first_token" not in names
    assert "kjarni.engine.first_token" in {s.name for s in profiling.spans()}


def test_each_profiler_run_is_a_session_of_its_own(lm, tmp_path, monkeypatch):
    with profiling.trace(tmp_path / "a"):
        _stream(lm, _prompts(lm)[0], 2)
    first = profiling.session()
    with profiling.trace(tmp_path / "b"):
        with profiling.annotate("kjarni.test", n=1):
            pass
    assert profiling.session() == first + 1
    (only,) = profiling.spans()
    assert (only.name, only.counts) == ("kjarni.test", {"n": 1})
    profiling.reset()
    assert profiling.spans() == []
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(5):
            with profiling.annotate("kjarni.test"):
                pass
    assert len(profiling.spans()) == 3


def test_a_request_left_open_records_nothing_after_its_session(lm, tmp_path):
    """A request submitted while a profiler runs, whose first token comes
    back after it stops, leaves no record in a later session."""
    eng = ContinuousEngine(lm, slots=2, steps_per_sync=2)
    with profiling.trace(tmp_path / "a"):
        eng.submit(token_ids=_prompts(lm)[0], max_new_tokens=NEW)
    eng.step()
    with profiling.trace(tmp_path / "b"):
        t0 = time.perf_counter_ns()
        eng.submit(token_ids=_prompts(lm)[1], max_new_tokens=2)
        eng.run()
    (only,) = [s for s in profiling.spans() if s.name == "kjarni.engine.first_token"]
    assert only.start_ns >= t0
    assert eng._stamps == {}


def test_generation_stats_time_the_prefill_to_the_first_token(lm, monkeypatch):
    """The first sampled token waits on the prefill's device work: a slowed
    first sample falls in prefill_seconds, not in decode_seconds."""
    orig, calls = decoder_lm.sample_token, []

    def slow_first(*a, **kw):
        if not calls:
            time.sleep(0.5)
        calls.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(decoder_lm, "sample_token", slow_first)
    stats = GenerationStats()
    cfg = GenerationConfig.greedy(max_new_tokens=4, max_length=MAX_CONTEXT)
    toks = list(lm.generate_stream(token_ids=_prompts(lm)[2], config=cfg, stats=stats))
    assert len(toks) == 4 and stats.generated_tokens == 4
    assert stats.prompt_tokens == LENGTHS[2]
    assert stats.prefill_seconds >= 0.5 > stats.decode_seconds


def test_generation_stats_charge_the_first_decode_forward_to_decode(lm, monkeypatch):
    """The forward of the first generated token runs after that token is
    read back: a slowed first decode forward falls in decode_seconds, and
    the stream's first-token stamp comes before it."""
    orig, calls = lm.family.forward, []

    def slow_second(*a, **kw):      # call 0 is the prefill
        if len(calls) == 1:
            time.sleep(0.5)
        calls.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(lm.family, "forward", slow_second)
    stats = GenerationStats()
    cfg = GenerationConfig.greedy(max_new_tokens=4, max_length=MAX_CONTEXT)
    lm._session_ids = []
    t0 = time.perf_counter_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        toks = list(lm.generate_stream(token_ids=_prompts(lm)[4], config=cfg, stats=stats))
    assert len(toks) == 4 and len(calls) == 5
    assert stats.decode_seconds >= 0.5 > stats.prefill_seconds
    (req,) = [s for s in profiling.spans() if s.name == "kjarni.stream.request"]
    assert (req.counts["first_token_ns"] - t0) / 1e9 < 0.5
