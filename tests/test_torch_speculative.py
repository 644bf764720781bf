"""The port's SpeculativeGenerator against the JAX package's, on the CPU.

tests/test_speculative.py's target (3 layers, hidden 64) and draft (1 layer,
hidden 32) checkpoints, loaded into both packages in f32. Greedy speculative
ids must equal the vanilla greedy ids of both packages and the JAX
speculative ids (its fused loop and its stream), with int4 weights too;
a self-draft must accept every token; `generate` must equal
`generate_stream`; working buckets of 16 and 8 slots must equal the full
cache, a stop id mid-round included. The probabilistic rule cannot match
jax.random: a seed must repeat its stream. Generator and Chat take
`draft_model=`: greedy requests take the speculative loop, sampled ones
bypass it.
"""

import pytest

from test_speculative import make_llama_dir

from kjarni_tpu.generate.sampling import GenerationConfig as JaxGenerationConfig
from kjarni_tpu.generate.speculative import SpeculativeGenerator as JaxSpeculative
from kjarni_tpu.models.decoder_lm import DecoderLM as JaxDecoderLM
from kjarni_tpu_torch.core.errors import GenerationError
from kjarni_tpu_torch.generate.sampling import GenerationConfig
from kjarni_tpu_torch.generate.speculative import SpeculativeGenerator
from kjarni_tpu_torch.models.decoder_lm import DecoderLM

PROMPTS = ["hello world the", "doctor physician", "keeping the physician",
           "data is safe with"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return (make_llama_dir(tmp_path_factory.mktemp("tspec_target"), seed=31, layers=3),
            make_llama_dir(tmp_path_factory.mktemp("tspec_draft"), seed=32, layers=1,
                           hidden=32))


_LMS: dict = {}


def _lms(dirs, ctx=64, quantize=None, step=None):
    """(JAX target, JAX draft, port target, port draft), loaded once per
    module for each (context, quantize, bucket step), with no session kept."""
    key = (dirs, ctx, quantize, step)
    if key not in _LMS:
        t, d = dirs
        _LMS[key] = (JaxDecoderLM(t, max_context=ctx, quantize=quantize),
                     JaxDecoderLM(d, max_context=ctx),
                     DecoderLM(t, max_context=ctx, quantize=quantize, device="cpu"),
                     DecoderLM(d, max_context=ctx, device="cpu"))
        for lm in _LMS[key]:
            lm._kv_bucket_step = step or lm._kv_bucket_step
    for lm in _LMS[key]:
        lm._session_ids = []
    return _LMS[key]


def _greedy(n, ctx, jax=False):
    return (JaxGenerationConfig if jax else GenerationConfig).greedy(max_new_tokens=n,
                                                                     max_length=ctx)


@pytest.mark.parametrize("quantize", [None, "int4"])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_greedy_equals_vanilla_and_jax(dirs, k, quantize):
    jt, jd, tt, td = _lms(dirs, quantize=quantize)
    spec, jspec = SpeculativeGenerator(tt, td, num_tokens=k), JaxSpeculative(jt, jd, num_tokens=k)
    for prompt in PROMPTS[:2]:
        vanilla = [st.id for st in tt.generate_stream(prompt, config=_greedy(12, 64))]
        assert vanilla == [st.id for st in jt.generate_stream(prompt,
                                                              config=_greedy(12, 64, True))]
        got = [st.id for st in spec.generate_stream(prompt, config=_greedy(12, 64))]
        want = [st.id for st in jspec.generate_stream(prompt, config=_greedy(12, 64, True))]
        assert got == want == vanilla
        assert (spec.last_rounds, spec.last_drafted, spec.last_accepted) == \
            (jspec.last_rounds, jspec.last_drafted, jspec.last_accepted)
        assert spec.generate(prompt, config=_greedy(12, 64)) == \
            jspec.generate(prompt, config=_greedy(12, 64, True)) == \
            tt.generate(prompt, config=_greedy(12, 64))


def test_self_draft_accepts_every_token(dirs):
    _, _, tt, _ = _lms(dirs)
    spec = SpeculativeGenerator(tt, tt, num_tokens=3)
    vanilla = [st.id for st in tt.generate_stream(PROMPTS[1], config=_greedy(10, 64))]
    assert [st.id for st in spec.generate_stream(PROMPTS[1], config=_greedy(10, 64))] == vanilla
    assert spec.last_acceptance_rate == 1.0 and spec.last_rounds > 0


def test_max_new_tokens_and_stop(dirs):
    jt, jd, tt, td = _lms(dirs)
    spec, jspec = SpeculativeGenerator(tt, td), JaxSpeculative(jt, jd)
    for n in (1, 2, 5):
        got = [st.id for st in spec.generate_stream("hello", config=_greedy(n, 64))]
        assert len(got) <= n
        assert got == [st.id for st in jspec.generate_stream("hello",
                                                             config=_greedy(n, 64, True))]


def test_probabilistic_seed_repeats(dirs):
    _, _, tt, td = _lms(dirs)
    spec = SpeculativeGenerator(tt, td, num_tokens=3, probabilistic=True)
    cfg = GenerationConfig(max_new_tokens=8, max_length=64, seed=7)
    a = [st.id for st in spec.generate_stream("hello world", config=cfg)]
    b = [st.id for st in spec.generate_stream("hello world", config=cfg)]
    assert a == b and len(a) > 0
    assert all(0 <= t < tt.config.vocab_size for t in a)
    assert spec.generate("hello world", config=cfg) == \
        "".join(st.text for st in spec.generate_stream("hello world", config=cfg))


def test_verify_rules_on_known_logits():
    import torch
    from kjarni_tpu_torch.generate.speculative import verify_greedy, verify_prob
    V, k = 6, 3
    t = torch.full((k + 1, V), -5.0)
    t[0, 2] = t[1, 4] = t[2, 1] = t[3, 0] = 5.0      # target argmax: 2, 4, 1, 0
    n, nxt = verify_greedy(t, torch.tensor([2, 4, 3]))
    assert (int(n), int(nxt)) == (2, 1)
    n, nxt = verify_greedy(t, torch.tensor([2, 4, 1]))
    assert (int(n), int(nxt)) == (3, 0)                # all accepted: the bonus
    # the draft equal to the target accepts everything and draws from p[k]
    g = torch.Generator().manual_seed(0)
    n, nxt = verify_prob(t, t[:k], torch.tensor([2, 4, 1]), g)
    assert int(n) == k and 0 <= int(nxt) < V


def test_vocab_mismatch_refused(dirs, tmp_path):
    import torch
    from helpers import build_word_tokenizer, save_torch_model
    from transformers import LlamaConfig, LlamaForCausalLM
    config = LlamaConfig(vocab_size=10, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2,
                         max_position_embeddings=64)
    torch.manual_seed(1)
    save_torch_model(tmp_path, LlamaForCausalLM(config).eval(), config)
    build_word_tokenizer(tmp_path / "tokenizer.json", bert_style=False)
    _, _, tt, _ = _lms(dirs)
    with pytest.raises(GenerationError, match="share a vocabulary"):
        SpeculativeGenerator(tt, DecoderLM(tmp_path, max_context=64, device="cpu"))


@pytest.mark.parametrize("step,n,prompt", [(16, 40, "hello world the"),
                                           (16, 40, "keeping the physician"),
                                           (8, 60, "data is safe with")],
                         ids=["bucket16", "bucket16_stream", "stop_mid_round"])
def test_working_buckets_equal_full_cache(dirs, step, n, prompt):
    jt, jd, tt, td = _lms(dirs, ctx=96, step=step)
    full = _lms(dirs, ctx=96)
    want = full[2].generate(prompt, config=_greedy(n, 96))
    spec = SpeculativeGenerator(tt, td, num_tokens=4)
    assert spec.generate(prompt, config=_greedy(n, 96)) == want
    got = [st.id for st in spec.generate_stream(prompt, config=_greedy(n, 96))]
    assert got == [st.id for st in full[2].generate_stream(prompt, config=_greedy(n, 96))]
    if step == 16:    # the JAX loop compiles once per bucket: 16-slot buckets only
        assert got == [st.id for st in JaxSpeculative(jt, jd, num_tokens=4).generate_stream(
            prompt, config=_greedy(n, 96, True))]


class TestTasks:
    def test_generator_draft_model(self, dirs):
        from kjarni_tpu.tasks.generator import Generator as JaxGenerator
        from kjarni_tpu_torch.tasks.generator import Generator
        t, d = dirs
        plain = Generator(str(t), max_context=64, device="cpu")
        spec = Generator(str(t), draft_model=str(d), max_context=64, draft_num_tokens=3,
                         device="cpu")
        jspec = JaxGenerator(str(t), draft_model=str(d), max_context=64, draft_num_tokens=3)
        cfg = _greedy(10, 64)
        assert spec.generate(PROMPTS[0], config=cfg) == plain.generate(PROMPTS[0], config=cfg) \
            == jspec.generate(PROMPTS[0], config=_greedy(10, 64, True))
        assert spec.speculative.last_rounds > 0 and spec.speculative.k == 3
        assert 0.0 <= spec.speculative.last_acceptance_rate <= 1.0
        assert spec.speculative.draft.device.type == "cpu"
        toks = list(spec.generate_stream(PROMPTS[1], config=_greedy(8, 64)))
        assert toks and spec.speculative.last_drafted > 0
        sampled = GenerationConfig(strategy="sample", max_new_tokens=5, max_length=64, seed=3)
        spec.speculative.last_rounds = 0
        assert isinstance(spec.generate("hello", config=sampled), str)
        assert spec.speculative.last_rounds == 0       # the sampled path bypassed it
        assert plain.speculative is None

    def test_chat_draft_model(self, dirs):
        from kjarni_tpu.tasks.chat import Chat as JaxChat
        from kjarni_tpu_torch.tasks.chat import Chat
        t, d = dirs
        plain = Chat(str(t), max_context=64, system_prompt=None, device="cpu")
        spec = Chat(str(t), draft_model=str(d), max_context=64, system_prompt=None,
                    device="cpu")
        jspec = JaxChat(str(t), draft_model=str(d), max_context=64, system_prompt=None)
        kw = dict(preset="greedy", max_new_tokens=8, max_length=64)
        want = plain.send("hello world", **kw)
        assert spec.send("hello world", **kw) == want == jspec.send("hello world", **kw)
        assert spec.speculative.last_rounds > 0
        assert spec.conversation.messages[-1].content == want.strip()
