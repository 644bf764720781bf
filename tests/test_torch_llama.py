"""kjarni_tpu_torch's llama forward against the JAX package's, on the CPU.

Both run the same random llama params (`__graft_entry__._random_llama`,
converted with `params_from_jax`) in f32; the JAX flash path runs the Pallas
kernel in interpret mode, the port's the kernel's plain version. Tolerance
atol 1e-3 on the logits (f32; the sums run in other orders).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kjarni_tpu.ops.pallas.flash_attention as jax_fa
from __graft_entry__ import _random_llama
from helpers import save_torch_model
from test_phi3_parity import phi3_checkpoint
from kjarni_tpu.models import llama as jl
from kjarni_tpu.weights.safetensors_loader import ModelWeights as JaxWeights
from kjarni_tpu_torch.core.errors import GenerationError
from kjarni_tpu_torch.models import llama as tl
from kjarni_tpu_torch.weights.convert import params_from_jax
from kjarni_tpu_torch.weights.safetensors_loader import ModelWeights

ATOL = 1e-3


@pytest.fixture
def interpret_flash(monkeypatch):
    orig = jax_fa.flash_attention

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(jax_fa, "flash_attention", interp)


@pytest.fixture(scope="module")
def model():
    cfg_j, params_np = _random_llama({"num_layers": 2, "max_seq_len": 512})
    cfg_t = tl.DecoderConfig(**{f.name: getattr(cfg_j, f.name)
                                for f in dataclasses.fields(tl.DecoderConfig)})
    return cfg_j, cfg_t, params_np


def _ids(n, seed, vocab=1024):
    return np.random.default_rng(seed).integers(0, vocab, (1, n)).astype(np.int32)


def _run_jax(cfg, params, chunks, **last_kw):
    """Prefill `chunks` in turn (each [1, S] at the running position); the
    last one with `last_kw`. Returns (logits, cache_k)."""
    params = jax.tree.map(jnp.asarray, params)
    ck, cv = jl.init_cache(cfg, 1, 512)
    pos = 0
    for i, ids in enumerate(chunks):
        kw = last_kw if i == len(chunks) - 1 else {}
        lg, ck, cv = jl.forward(params, cfg, jnp.asarray(ids), ck, cv,
                                jnp.int32(pos), **kw)
        pos += ids.shape[1]
    return np.asarray(lg), np.asarray(ck)


def _run_torch(cfg, params, chunks, **last_kw):
    ck, cv = tl.init_cache(cfg, 1, 512)
    pos = 0
    for i, ids in enumerate(chunks):
        kw = last_kw if i == len(chunks) - 1 else {}
        lg, ck, cv = tl.forward(params, cfg, torch.from_numpy(ids).long(), ck, cv,
                                pos, **kw)
        pos += ids.shape[1]
    return lg.numpy(), ck.numpy()


class TestForwardParity:
    @pytest.mark.parametrize("case", ["prefill", "prefill_then_decode",
                                      "flash_from_zero", "flash_kv_bucket"])
    def test_matches_jax(self, model, interpret_flash, case):
        cfg_j, cfg_t, params_np = model
        chunks = {"prefill": [_ids(128, 0)],
                  "prefill_then_decode": [_ids(100, 1), _ids(1, 2)],
                  "flash_from_zero": [_ids(128, 3)],
                  "flash_kv_bucket": [_ids(128, 4), _ids(128, 5)]}[case]
        kw = {"flash_from_zero": dict(use_flash=True),
              "flash_kv_bucket": dict(use_flash=True, kv_bucket=256)}.get(case, {})
        lg_j, ck_j = _run_jax(cfg_j, params_np, chunks, **kw)
        lg_t, ck_t = _run_torch(cfg_t, params_from_jax(params_np), chunks, **kw)
        np.testing.assert_allclose(lg_t, lg_j, atol=ATOL)
        np.testing.assert_allclose(ck_t, ck_j, atol=ATOL)

    @pytest.mark.parametrize("width", ["phi3_d96", "mistral_window64"])
    @pytest.mark.parametrize("case", ["flash_from_zero", "flash_kv_bucket"])
    def test_flash_widths_match_jax(self, interpret_flash, width, case):
        """Phi-3's head width (96, no GQA) and a Mistral-style sliding window,
        through the flash path of both packages."""
        extra = {"phi3_d96": dict(head_dim=96, num_heads=4, num_kv_heads=4),
                 "mistral_window64": dict(sliding_window=64)}[width]
        cfg_j, params_np = _random_llama({"num_layers": 2, "max_seq_len": 512, **extra})
        cfg_t = tl.DecoderConfig(**{f.name: getattr(cfg_j, f.name)
                                    for f in dataclasses.fields(tl.DecoderConfig)})
        chunks = {"flash_from_zero": [_ids(128, 9)],
                  "flash_kv_bucket": [_ids(128, 10), _ids(128, 11)]}[case]
        kw = {"flash_from_zero": dict(use_flash=True),
              "flash_kv_bucket": dict(use_flash=True, kv_bucket=256)}[case]
        lg_j, ck_j = _run_jax(cfg_j, params_np, chunks, **kw)
        lg_t, ck_t = _run_torch(cfg_t, params_from_jax(params_np), chunks, **kw)
        np.testing.assert_allclose(lg_t, lg_j, atol=ATOL)
        np.testing.assert_allclose(ck_t, ck_j, atol=ATOL)

    def test_int4_params_match_jax(self, model):
        cfg_j, cfg_t, params_np = model
        q_np = jl.quantize_params_int4(params_np)
        chunks = [_ids(64, 6), _ids(1, 7)]
        lg_j, _ = _run_jax(cfg_j, q_np, chunks)
        lg_t, _ = _run_torch(cfg_t, params_from_jax(q_np), chunks)
        np.testing.assert_allclose(lg_t, lg_j, atol=ATOL)

    def test_quantize_matches_jax(self, model):
        _, _, params_np = model
        q_np = jl.quantize_params_int4(params_np)
        q_t = tl.quantize_params_int4(params_from_jax(params_np))
        for name in ("q", "down"):
            np.testing.assert_array_equal(q_t["layers"][name]["w4"].numpy(),
                                          q_np["layers"][name]["w4"])
            np.testing.assert_allclose(q_t["layers"][name]["scale"].numpy(),
                                       q_np["layers"][name]["scale"], rtol=1e-7)
        np.testing.assert_array_equal(q_t["lm_head"]["w4"].numpy(),
                                      q_np["lm_head"]["w4"])

    def test_all_logits_match_jax(self, model):
        cfg_j, cfg_t, params_np = model
        ids = _ids(32, 8)
        ck, cv = jl.init_cache(cfg_j, 1, 64)
        lg_j, _, _ = jl.forward_all_logits(jax.tree.map(jnp.asarray, params_np),
                                           cfg_j, jnp.asarray(ids), ck, cv, 0)
        ck, cv = tl.init_cache(cfg_t, 1, 64)
        lg_t, _, _ = tl.forward_all_logits(params_from_jax(params_np), cfg_t,
                                           torch.from_numpy(ids).long(), ck, cv, 0)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=ATOL)


def test_cache_write_past_end_is_refused(model):
    _, cfg_t, params_np = model
    ck, cv = tl.init_cache(cfg_t, 1, 64)
    with pytest.raises(GenerationError):
        tl.forward(params_from_jax(params_np), cfg_t,
                   torch.zeros(1, 8, dtype=torch.long), ck, cv, 60)


@pytest.fixture(scope="module")
def phi3_longrope(tmp_path_factory):
    """tests/test_phi3_parity.py's longrope checkpoint (original window 32,
    max positions 64), its JAX config and the port's."""
    d = tmp_path_factory.mktemp("phi3_longrope")
    rs = {"type": "longrope",
          "short_factor": [1.0 + 0.1 * i for i in range(8)],
          "long_factor": [2.0 + 0.2 * i for i in range(8)]}
    _, cfg_j, _ = phi3_checkpoint(d, seed=1, rope_scaling=rs, max_pos=64)
    cfg_t = tl.DecoderConfig.from_hf(json.loads((d / "config.json").read_text()))
    return cfg_j, cfg_t


@pytest.mark.parametrize("length", [16, 32, 33, 64])
def test_phi3_longrope_rope_cache_is_exact(phi3_longrope, length):
    """Short factors up to the original window (32), long factors and the
    attention factor past it: the port's tables equal the JAX package's."""
    cfg_j, cfg_t = phi3_longrope
    # every field the port has (the JAX config adds host-placement flags)
    assert dataclasses.asdict(cfg_t) == {f.name: getattr(cfg_j, f.name)
                                         for f in dataclasses.fields(cfg_t)}
    cos_j, sin_j = jl.rope_cache(cfg_j, length)
    cos_t, sin_t = tl.rope_cache(cfg_t, length)
    np.testing.assert_array_equal(cos_t, cos_j)
    np.testing.assert_array_equal(sin_t, sin_j)
    short = tl.rope_cache(cfg_t, 16)[0]
    # past the window the long factors (and the attention factor) take over
    assert np.array_equal(cos_t[:16], short) == (length <= 32)


@pytest.fixture(scope="module")
def qwen2(tmp_path_factory):
    """A tiny Qwen2 checkpoint (q/k/v with bias, GQA) loaded by both packages."""
    from transformers import Qwen2Config, Qwen2ForCausalLM
    d = tmp_path_factory.mktemp("qwen2")
    config = Qwen2Config(vocab_size=120, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, max_position_embeddings=128,
                         tie_word_embeddings=False)
    torch.manual_seed(4)
    model = Qwen2ForCausalLM(config).eval()
    with torch.no_grad():   # HF zero-initialises biases; make them count
        for layer in model.model.layers:
            for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                         layer.self_attn.v_proj):
                proj.bias.normal_(0.0, 0.5)
    save_torch_model(d, model, config)
    hf = json.loads((d / "config.json").read_text())
    cfg_j, cfg_t = jl.DecoderConfig.from_hf(hf), tl.DecoderConfig.from_hf(hf)
    return (cfg_j, jl.load_params(JaxWeights(d), cfg_j, rope_cache_len=64),
            cfg_t, tl.load_params(ModelWeights(d), cfg_t, rope_cache_len=64))


@pytest.mark.parametrize("case", ["prefill", "prefill_then_decode"])
def test_qwen2_qkv_bias_forward_matches_jax(qwen2, case):
    cfg_j, p_j, cfg_t, p_t = qwen2
    assert cfg_t.qkv_bias and "b" in p_t["layers"]["q"] and "b" in p_t["layers"]["v"]
    np.testing.assert_array_equal(p_t["layers"]["k"]["b"].numpy(),
                                  np.asarray(p_j["layers"]["k"]["b"]))
    chunks = {"prefill": [_ids(20, 12, vocab=120)],
              "prefill_then_decode": [_ids(20, 13, vocab=120), _ids(1, 14, vocab=120)]}[case]
    lg_j, ck_j = _run_jax(cfg_j, p_j, chunks)
    lg_t, ck_t = _run_torch(cfg_t, p_t, chunks)
    np.testing.assert_allclose(lg_t, lg_j, atol=ATOL)
    np.testing.assert_allclose(ck_t, ck_j, atol=ATOL)
