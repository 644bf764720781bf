"""The port's GGUF reader, its GGUF-embedded tokenizer and GGUF model dirs
against the JAX package's, on the CPU.

GGUF files are written with tests/test_gguf.py's writer (imported; its
metadata packer is wrapped here to also write arrays, for the embedded
vocabulary and merges). Each dequantizer must equal the JAX one exactly on
the same raw blocks; parsing, the GGUF -> HF name map and the synthesized HF
config must be equal; the GGUF-embedded byte-level BPE must encode and decode
as the JAX one; and a `model.gguf` dir with no tokenizer.json or config.json
(Q8_0 and Q4_K projections) must give the JAX package's greedy ids in f32.
Also the safetensors readers on U16 / U32 / U64 tensors.
"""

import struct

import numpy as np
import pytest
import torch

import test_gguf
from test_gguf import (GGML_F16, GGML_F32, GGML_Q4_K, GGML_Q8_0, make_q8_0,
                       random_q4k_block, random_q5k_block, random_q6k_block, write_gguf)

from kjarni_tpu.weights import gguf as jg
from kjarni_tpu_torch.weights import gguf as tg

GGML_Q4_0, GGML_BF16 = 2, 30
SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>"]


def _pack_value(value) -> bytes:
    """A GGUF metadata value, arrays included (type 9: element type, count,
    elements); scalars as test_gguf packs them."""
    if isinstance(value, list):
        if all(isinstance(v, str) for v in value):
            return (struct.pack("<IQ", 8, len(value))
                    + b"".join(test_gguf._pack_string(v) for v in value))
        return struct.pack("<IQ", 5, len(value)) + struct.pack(f"<{len(value)}i", *value)
    return test_gguf._pack_kv("", value)[8:]     # drop the empty key


@pytest.fixture
def array_metadata(monkeypatch):
    orig = test_gguf._pack_kv

    def pack_kv(key, value):
        if not isinstance(value, list):
            return orig(key, value)
        return test_gguf._pack_string(key) + struct.pack("<I", 9) + _pack_value(value)
    monkeypatch.setattr(test_gguf, "_pack_kv", pack_kv)


def _q4_0_blocks(rng, n) -> bytes:
    return b"".join(np.float16(rng.uniform(0.01, 0.1)).tobytes()
                    + rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(n))


def _q4k_blocks(rng, n, d_scale) -> bytes:
    """n Q4_K super-blocks with d and dmin near d_scale (values ~ 256 d_scale)."""
    out = b""
    for _ in range(n):
        out += np.float16(rng.uniform(0.2, 1.0) * d_scale).tobytes()
        out += np.float16(rng.uniform(0.0, 1.0) * d_scale).tobytes()
        out += rng.integers(0, 256, 140, dtype=np.uint8).tobytes()
    return out


BLOCKS = {
    "q8_0": lambda rng: make_q8_0(rng.standard_normal(96).astype(np.float32)),
    "q4_0": lambda rng: _q4_0_blocks(rng, 3),
    "q4_k": lambda rng: b"".join(random_q4k_block(rng) for _ in range(3)),
    "q5_k": lambda rng: b"".join(random_q5k_block(rng) for _ in range(3)),
    "q6_k": lambda rng: b"".join(random_q6k_block(rng) for _ in range(3)),
}


@pytest.mark.parametrize("fmt", list(BLOCKS))
def test_dequantizers_equal_jax(fmt):
    raw = np.frombuffer(BLOCKS[fmt](np.random.default_rng(len(fmt))), dtype=np.uint8)
    got = getattr(tg, f"dequant_{fmt}")(raw)
    np.testing.assert_array_equal(got, getattr(jg, f"dequant_{fmt}")(raw))


def test_parse_name_map_and_config_equal_jax(tmp_path, array_metadata):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 32)).astype(np.float32)         # [out=4, in=32]
    bf16 = (w.view(np.uint32) >> 16).astype(np.uint16)           # truncated to bf16
    tensors = {
        "token_embd.weight": ([32, 4], GGML_F32, w.tobytes()),
        "blk.0.attn_q.weight": ([32, 4], GGML_F16, w.astype(np.float16).tobytes()),
        "blk.0.attn_k.weight": ([32, 4], GGML_BF16, bf16.tobytes()),
        "blk.0.attn_v.weight": ([32, 4], GGML_Q8_0, make_q8_0(w.reshape(-1))),
        "blk.0.ffn_up.weight": ([32, 4], GGML_Q4_0, _q4_0_blocks(rng, 4)),
        "blk.0.ffn_gate.weight": ([256, 1], GGML_Q4_K, random_q4k_block(rng)),
        "output_norm.weight": ([32], GGML_F32, np.ones(32, np.float32).tobytes()),
        "rope_freqs.weight": ([16], GGML_F32, np.ones(16, np.float32).tobytes()),
    }
    md = {"general.architecture": "qwen2", "qwen2.block_count": 1,
          "qwen2.embedding_length": 32, "qwen2.attention.head_count": 4,
          "qwen2.attention.head_count_kv": 2, "qwen2.feed_forward_length": 64,
          "qwen2.rope.freq_base": 1e6, "tokenizer.ggml.eos_token_id": 3,
          "tokenizer.ggml.tokens": ["a", "b", "c", "d"], "general.name": "tiny"}
    write_gguf(tmp_path / "m.gguf", tensors, md)
    jf, tf = jg.GgufFile(tmp_path / "m.gguf"), tg.GgufFile(tmp_path / "m.gguf")
    assert tf.metadata == jf.metadata and tf.version == jf.version
    assert tf.tensor_names() == jf.tensor_names()
    for name in tf.tensor_names():
        assert tf.tensor_type_name(name) == jf.tensor_type_name(name)
        np.testing.assert_array_equal(tf.get(name), jf.get(name))
    np.testing.assert_array_equal(tf.get("blk.0.attn_k.weight"),
                                  (bf16.astype(np.uint32) << 16).view(np.float32))
    jw, tw = jg.GgufWeights(tmp_path / "m.gguf"), tg.GgufWeights(tmp_path / "m.gguf")
    assert sorted(tw.keys()) == sorted(jw.keys())
    assert "rope_freqs.weight" not in tw and "lm_head.weight" not in tw
    assert tw.hf_config() == jw.hf_config()
    assert tw.hf_config()["model_type"] == "qwen2" and tw.hf_config()["vocab_size"] == 4
    names = list(tensors) + ["output.weight", "blk.7.attn_qkv.weight", "blk.2.attn_q.bias",
                             "blk.1.nothing.weight", "unknown"]
    assert [tg.gguf_to_hf_name(n) for n in names] == [jg.gguf_to_hf_name(n) for n in names]


def _bpe_metadata(extra_merges=()):
    """tokenizer.ggml.* metadata of a byte-level BPE: the 256 byte symbols,
    merges over a few words, and the llama3-style specials (token type 3)."""
    from kjarni_tpu_torch.tokenizer_native import bytes_to_unicode
    tokens = list(bytes_to_unicode().values())
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("Ġ", "w"), ("o", "r"), ("Ġw", "or"),
              ("Ġ", "t"), ("Ġt", "h"), ("Ġth", "e"), ("d", "o"), ("do", "c"),
              *extra_merges]
    for a, b in merges:
        if a + b not in tokens:
            tokens.append(a + b)
    types = [1] * len(tokens) + [3] * len(SPECIALS)
    tokens += SPECIALS
    return {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.merges": [f"{a} {b}" for a, b in merges],
            "tokenizer.ggml.token_type": types,
            "tokenizer.ggml.bos_token_id": tokens.index(SPECIALS[0]),
            "tokenizer.ggml.eos_token_id": tokens.index(SPECIALS[1])}


@pytest.mark.parametrize("with_types", [True, False])
def test_bpe_from_gguf_metadata_equals_jax(with_types):
    from kjarni_tpu.tokenizer_native import bpe_from_gguf_metadata as jax_bpe
    from kjarni_tpu_torch.tokenizer_native import bpe_from_gguf_metadata
    md = _bpe_metadata()
    if not with_types:      # <|...|> shaped tokens then act as specials
        del md["tokenizer.ggml.token_type"]
    tb, jb = bpe_from_gguf_metadata(md), jax_bpe(md)
    assert tb.special_tokens == jb.special_tokens and len(tb.special_tokens) == 3
    text = "<|begin_of_text|>hello world the doc<|eot_id|> héllo, 42 worlds!"
    ids = tb.encode(text)
    assert ids == jb.encode(text) and md["tokenizer.ggml.eos_token_id"] not in ids
    for skip in (True, False):
        assert tb.decode(ids, skip_special_tokens=skip) == jb.decode(ids, skip)
    assert tb.decode(ids, skip_special_tokens=False) == text
    assert bpe_from_gguf_metadata({"tokenizer.ggml.tokens": ["a"]}) is None


def _write_model_gguf(d, proj_type, seed, tokenizer=True):
    """A 2-layer llama GGUF (hidden 256, GQA 4/2 heads of 64) whose
    projections are `proj_type` (Q8_0 from values, or Q4_K blocks), with F32
    norms, embedding and head, the embedded BPE (unless not `tokenizer`),
    and no other file."""
    rng = np.random.default_rng(seed)
    md = _bpe_metadata()
    V = len(md["tokenizer.ggml.tokens"])
    if not tokenizer:
        md = {}
    H, I_, nh, nkv, hd = 256, 512, 4, 2, 64
    md.update({"general.architecture": "llama", "llama.block_count": 2,
               "llama.embedding_length": H, "llama.feed_forward_length": I_,
               "llama.attention.head_count": nh, "llama.attention.head_count_kv": nkv,
               "llama.context_length": 128, "llama.attention.layer_norm_rms_epsilon": 1e-5,
               "llama.rope.freq_base": 10000.0, "llama.vocab_size": V})

    def f32(o, i, s=0.05):
        return (rng.standard_normal((o, i)) * s).astype(np.float32)

    def proj(o, i):
        if proj_type == GGML_Q8_0:
            return ([i, o], GGML_Q8_0, make_q8_0(f32(o, i).reshape(-1)))
        return ([i, o], GGML_Q4_K, _q4k_blocks(rng, o * i // 256, 2e-4))

    ones = ([H], GGML_F32, np.ones(H, np.float32).tobytes())
    tensors = {"token_embd.weight": ([H, V], GGML_F32, f32(V, H, 0.5).tobytes()),
               "output_norm.weight": ones,
               "output.weight": ([H, V], GGML_F32, f32(V, H, 0.1).tobytes())}
    for i in range(2):
        p = f"blk.{i}."
        tensors.update({p + "attn_q.weight": proj(nh * hd, H),
                        p + "attn_k.weight": proj(nkv * hd, H),
                        p + "attn_v.weight": proj(nkv * hd, H),
                        p + "attn_output.weight": proj(H, nh * hd),
                        p + "ffn_gate.weight": proj(I_, H), p + "ffn_up.weight": proj(I_, H),
                        p + "ffn_down.weight": proj(H, I_),
                        p + "attn_norm.weight": ones, p + "ffn_norm.weight": ones})
    d.mkdir()
    write_gguf(d / "model.gguf", tensors, md)
    return d


@pytest.mark.parametrize("proj_type", [GGML_Q8_0, GGML_Q4_K], ids=["q8_0", "q4_k"])
def test_gguf_dir_greedy_ids_equal_jax(tmp_path, array_metadata, proj_type):
    from kjarni_tpu.generate.sampling import GenerationConfig as JaxGenerationConfig
    from kjarni_tpu.models.decoder_lm import DecoderLM as JaxDecoderLM
    from kjarni_tpu_torch.generate.sampling import GenerationConfig
    from kjarni_tpu_torch.models.decoder_lm import DecoderLM
    from kjarni_tpu_torch.tokenizer_native import BPETokenizer
    d = _write_model_gguf(tmp_path / "gguf", proj_type, seed=proj_type)
    assert sorted(p.name for p in d.iterdir()) == ["model.gguf"]
    jlm, tlm = JaxDecoderLM(d, max_context=128), DecoderLM(d, max_context=128, device="cpu")
    assert isinstance(tlm.tokenizer, BPETokenizer)
    assert tlm.hf_config == jlm.hf_config and tlm.stop_token_ids == jlm.stop_token_ids
    w = jg.GgufWeights(d / "model.gguf").get("model.layers.1.mlp.down_proj.weight")
    np.testing.assert_array_equal(tlm.params["layers"]["down"]["w"][1].numpy(), w.T)
    prompt = "hello world the doc hello the world"
    assert tlm.encode_prompt(prompt) == jlm.encode_prompt(prompt)
    kw = dict(max_new_tokens=24, max_length=128)
    got = [st.id for st in tlm.generate_stream(prompt, config=GenerationConfig.greedy(**kw))]
    want = [st.id for st in jlm.generate_stream(prompt,
                                                config=JaxGenerationConfig.greedy(**kw))]
    assert got == want and len(got) > 0
    assert tlm.generate(prompt, config=GenerationConfig.greedy(**kw)) == \
        jlm.generate(prompt, config=JaxGenerationConfig.greedy(**kw))


def test_safetensors_sources_come_before_gguf(tmp_path, array_metadata):
    """A dir holding both: safetensors and config.json win over the GGUF
    file, as in the JAX package, and then so must a tokenizer.json (the JAX
    package reads the embedded BPE only when the weights come from GGUF)."""
    import json
    from helpers import build_word_tokenizer
    from kjarni_tpu.models.decoder_lm import DecoderLM as JaxDecoderLM
    from kjarni_tpu_torch.core.errors import InvalidConfigError
    from kjarni_tpu_torch.models.decoder_lm import DecoderLM
    from kjarni_tpu_torch.tokenizer import KjarniTokenizer
    from kjarni_tpu_torch.weights.safetensors_loader import save_file
    d = _write_model_gguf(tmp_path / "both", GGML_Q8_0, seed=5)
    lm = DecoderLM(d, device="cpu")
    gw = tg.GgufWeights(d / "model.gguf")
    save_file({k: torch.from_numpy(np.ascontiguousarray(gw.get(k))) for k in gw.keys()},
              d / "model.safetensors")
    (d / "config.json").write_text(json.dumps(dict(lm.hf_config, rms_norm_eps=1e-3)))
    with pytest.raises(InvalidConfigError, match="no tokenizer.json"):
        DecoderLM(d, device="cpu")
    with pytest.raises(Exception, match="no tokenizer.json"):
        JaxDecoderLM(d)
    build_word_tokenizer(d / "tokenizer.json", bert_style=False)
    lm2 = DecoderLM(d, device="cpu")
    assert lm2.config.rms_norm_eps == 1e-3 and lm.config.rms_norm_eps == pytest.approx(1e-5)
    assert torch.equal(lm2.params["embed"], lm.params["embed"])
    assert isinstance(lm2.tokenizer, KjarniTokenizer)


def test_missing_tokenizer_is_refused(tmp_path, array_metadata):
    from kjarni_tpu_torch.core.errors import InvalidConfigError
    from kjarni_tpu_torch.models.decoder_lm import DecoderLM
    d = _write_model_gguf(tmp_path / "no_tok", GGML_Q8_0, seed=6, tokenizer=False)
    with pytest.raises(InvalidConfigError, match="no tokenizer.json"):
        DecoderLM(d, device="cpu")


@pytest.mark.parametrize("np_dtype", [np.uint16, np.uint32, np.uint64])
def test_safetensors_unsigned_dtypes_equal_jax(tmp_path, np_dtype):
    """U16 / U32 / U64 tensors, at an offset after three U8 bytes, read as
    the JAX reader reads them (the values span the whole unsigned range)."""
    from kjarni_tpu.weights.safetensors_loader import ModelWeights as JaxWeights
    from kjarni_tpu_torch.weights.safetensors_loader import ModelWeights, save_file
    vals = np.random.default_rng(0).integers(0, np.iinfo(np_dtype).max, 12,
                                             dtype=np_dtype, endpoint=True)
    t = {"a.u8": torch.tensor([1, 2, 3], dtype=torch.uint8), "b": torch.from_numpy(vals)}
    save_file(t, tmp_path / "model.safetensors")
    got, want = ModelWeights(tmp_path).get("b"), JaxWeights(tmp_path).get("b")
    assert got.dtype == t["b"].dtype and want.dtype == np_dtype
    np.testing.assert_array_equal(got.numpy(), want)
