"""The port's Chat against the JAX package's, on the CPU, in f32.

A tiny HF llama checkpoint (2 layers, hidden 256, 256 positions, the word
tokenizer) under the llama3 template. Greedy replies, the conversation and
the token ids in the cache must equal the JAX package's `Chat` turn by turn.
Also: a turn that reuses the cached prefix equals a fresh run of the same
prompt, a diverging prompt drops the prefix, the oldest turn is dropped when
the prompt outgrows the context, and `chat_template=` overrides the format.
"""

import pytest
import torch

from helpers import build_word_tokenizer, save_torch_model

from kjarni_tpu.tasks.chat import Chat as JaxChat
from kjarni_tpu_torch.chat_templates import Role
from kjarni_tpu_torch.core.errors import InvalidConfigError
from kjarni_tpu_torch.generate.sampling import GenerationConfig
from kjarni_tpu_torch.models.decoder_lm import DecoderLM
from kjarni_tpu_torch.tasks.chat import Chat, chat_send

GREEDY = dict(preset="greedy", max_new_tokens=10, max_length=256)
TURNS = ["hello world the doctor and the nurse love this great product",
         "it is safe data was the best purchase ever made",
         "i hate mondays and the worst quality service"]
SYSTEM = "the doctor is a good physician"


@pytest.fixture(scope="module")
def chat_dir(tmp_path_factory):
    from transformers import LlamaConfig, LlamaForCausalLM
    d = tmp_path_factory.mktemp("torch_llama_chat")
    vocab_map = build_word_tokenizer(d / "tokenizer.json", bert_style=False)
    config = LlamaConfig(vocab_size=len(vocab_map), hidden_size=256,
                         intermediate_size=512, num_hidden_layers=2,
                         num_attention_heads=8, num_key_value_heads=4,
                         max_position_embeddings=256, bos_token_id=2,
                         eos_token_id=3, tie_word_embeddings=False)
    torch.manual_seed(12)
    model = LlamaForCausalLM(config).eval()
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 2:
                p.normal_(0.0, 0.08)
    save_torch_model(d, model, config)
    return d


def _pair(d, **kw):
    return JaxChat(str(d), **kw), Chat(str(d), device="cpu", **kw)


def _same(jc, tc):
    assert [(m.role.value, m.content) for m in tc.conversation.messages] == \
        [(m.role.value, m.content) for m in jc.conversation.messages]
    assert tc.lm._session_ids == jc.lm._session_ids


@pytest.mark.parametrize("kv_cache", [None, "int8"])
def test_three_turns_match_jax(chat_dir, kv_cache):
    jc, tc = _pair(chat_dir, system_prompt=SYSTEM, kv_cache=kv_cache)
    for i, msg in enumerate(TURNS):
        n_before = len(tc.lm._session_ids)
        assert tc.send(msg, **GREEDY) == jc.send(msg, **GREEDY)
        _same(jc, tc)
        assert tc.lm.last_prefill_tokens == jc.lm.last_prefill_tokens
        if i:   # later turns prefill only what follows the cached prefix
            assert tc.lm.last_prefill_tokens < len(tc.lm._session_ids) - n_before
    assert [m.role for m in tc.conversation.messages] == \
        [Role.SYSTEM] + [Role.USER, Role.ASSISTANT] * 3


def _prompt_ids(tc, msg):
    """The token ids a send of `msg` will prefill from."""
    tc.conversation.push_user(msg)
    ids = tc._encode()
    tc.conversation.messages.pop()
    return ids


def test_reused_prefix_equals_a_fresh_run(chat_dir):
    _, tc = _pair(chat_dir, system_prompt=SYSTEM)
    tc.send(TURNS[0], **GREEDY)
    ids = _prompt_ids(tc, TURNS[1])
    tc.send(TURNS[1], **GREEDY)
    assert tc.lm.last_prefill_tokens < len(ids)
    fresh = DecoderLM(chat_dir, device="cpu")
    cfg = GenerationConfig.greedy(max_new_tokens=10, max_length=256, add_bos_token=False)
    fresh.generate(token_ids=ids, config=cfg)
    assert fresh.last_prefill_tokens == len(ids)
    assert fresh._session_ids == tc.lm._session_ids


def test_diverging_prompt_drops_the_prefix(chat_dir):
    jc, tc = _pair(chat_dir, system_prompt="")
    assert tc.send(TURNS[0], **GREEDY) == jc.send(TURNS[0], **GREEDY)
    before = list(tc.lm._session_ids)
    jc.clear_history()
    tc.clear_history()
    assert len(tc.conversation) == 0
    ids = _prompt_ids(tc, TURNS[2])
    common = next(i for i, (a, b) in enumerate(zip(before, ids)) if a != b)
    assert 0 < common < tc.lm._min_reuse_prefix
    assert tc.send(TURNS[2], **GREEDY) == jc.send(TURNS[2], **GREEDY)
    _same(jc, tc)
    assert tc.lm.last_prefill_tokens == jc.lm.last_prefill_tokens == len(ids)


def test_oldest_turn_is_dropped_to_fit(chat_dir):
    jc, tc = _pair(chat_dir, system_prompt=SYSTEM, max_context=72)
    for msg in TURNS:
        assert tc.send(msg, **GREEDY) == jc.send(msg, **GREEDY)
        _same(jc, tc)
        assert len(tc.lm._session_ids) <= 72
    msgs = tc.conversation.messages
    assert msgs[0].role == Role.SYSTEM and msgs[1].content != TURNS[0]
    assert msgs[-2].content == TURNS[2]


def test_chat_template_override(chat_dir):
    jc, tc = _pair(chat_dir, system_prompt=SYSTEM, chat_template="chatml")
    assert tc.lm.apply_chat_template(tc.conversation).startswith("<|im_start|>system")
    assert tc.send(TURNS[0], **GREEDY) == jc.send(TURNS[0], **GREEDY)
    _same(jc, tc)


def test_stream_updates_history_at_its_end(chat_dir):
    tc = Chat(str(chat_dir), device="cpu", system_prompt=SYSTEM)
    parts = [st.text for st in tc.stream(TURNS[0], **GREEDY)]
    assert tc.conversation.messages[-1].content == "".join(parts).strip()
    assert isinstance(chat_send(TURNS[1], str(chat_dir), device="cpu"), str)


def test_refusals(chat_dir):
    # tp = 2 outside a process group of 2 ranks names the launcher
    with pytest.raises(InvalidConfigError, match="torchrun --nproc-per-node 2"):
        Chat(str(chat_dir), device="cpu", tp=2)
    if not torch.cuda.is_available():   # Chat() means the card
        with pytest.raises(InvalidConfigError, match="device='cpu'"):
            Chat(str(chat_dir))
