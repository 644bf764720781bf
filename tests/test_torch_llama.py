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


# the zoo's head ratios, tiny: Qwen2.5-0.5B's 7:1 with q/k/v biases (K = 224:
# one int4 scale per column, as Qwen2.5-0.5B's K = 896), Llama-3.2-3B's 24 / 8
# heads (3:1, K = 768: groups of 128) and Phi-3's 1:1 at D = 96 (fused qkv
# and gate_up)
ZOO_RATIOS = {
    "qwen2_7to1_bias": ("Qwen2", dict(hidden_size=224, num_attention_heads=14,
                                      num_key_value_heads=2)),
    "llama_3to1": ("Llama", dict(hidden_size=768, num_attention_heads=24,
                                 num_key_value_heads=8)),
    "phi3_1to1_d96": ("Phi3", dict(hidden_size=192, num_attention_heads=2,
                                   num_key_value_heads=2, pad_token_id=0)),
}


@pytest.fixture(scope="module", params=list(ZOO_RATIOS))
def zoo_ratio(request, tmp_path_factory):
    """One ZOO_RATIOS checkpoint (2 layers, random HF weights) loaded by both
    packages, f32."""
    import transformers
    family, kw = ZOO_RATIOS[request.param]
    d = tmp_path_factory.mktemp(request.param)
    config = getattr(transformers, f"{family}Config")(
        vocab_size=160, intermediate_size=256, num_hidden_layers=2,
        max_position_embeddings=512, tie_word_embeddings=False, **kw)
    torch.manual_seed(7)
    model = getattr(transformers, f"{family}ForCausalLM")(config).eval()
    if family == "Qwen2":
        with torch.no_grad():   # HF zero-initialises biases; make them count
            for layer in model.model.layers:
                for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                             layer.self_attn.v_proj):
                    proj.bias.normal_(0.0, 0.5)
    save_torch_model(d, model, config)
    hf = json.loads((d / "config.json").read_text())
    cfg_j, cfg_t = jl.DecoderConfig.from_hf(hf), tl.DecoderConfig.from_hf(hf)
    return (request.param, cfg_j, jl.load_params(JaxWeights(d), cfg_j, rope_cache_len=256),
            cfg_t, tl.load_params(ModelWeights(d), cfg_t, rope_cache_len=256))


def _greedy(forward, argmax, params, cfg, ids, cache, steps):
    """A flash prefill of ids at slot 0, then `steps` greedy decode steps;
    (the logits of every step, the greedy ids)."""
    ck, cv = cache
    lg, ck, cv = forward(params, cfg, ids, ck, cv, 0, use_flash=True)
    logits, out = [np.asarray(lg)], []
    for i in range(steps):
        out.append(int(argmax(lg)))
        lg, ck, cv = forward(params, cfg, out[-1], ck, cv, ids.shape[1] + i)
        logits.append(np.asarray(lg))
    return logits, out


@pytest.mark.parametrize("quantize", [None, "int4"])
def test_zoo_head_ratios_match_jax(zoo_ratio, interpret_flash, quantize):
    """The prefill's logits (both flash paths) and 8 greedy ids after it, at
    the zoo's head ratios, plain and int4, equal the JAX package's."""
    name, cfg_j, p_j, cfg_t, p_t = zoo_ratio
    H, Hkv = cfg_t.num_heads, cfg_t.num_kv_heads
    assert (H // Hkv, cfg_t.qkv_bias) == {"qwen2_7to1_bias": (7, True),
                                          "llama_3to1": (3, False),
                                          "phi3_1to1_d96": (1, False)}[name]
    assert name != "phi3_1to1_d96" or cfg_t.head_dim == 96
    if quantize:
        p_j, p_t = jl.quantize_params_int4(p_j), tl.quantize_params_int4(p_t)
        G = p_t["layers"]["q"]["scale"].shape[1]
        assert G == (6 if name == "llama_3to1" else 1)
    ids = _ids(100, 20, vocab=160)

    def jax_fwd(params, cfg, x, ck, cv, pos, **kw):
        x = jnp.asarray(np.asarray(x, np.int32).reshape(1, -1))
        return jl.forward(params, cfg, x, ck, cv, jnp.int32(pos), **kw)

    def torch_fwd(params, cfg, x, ck, cv, pos, **kw):
        x = torch.from_numpy(np.asarray(x, np.int64).reshape(1, -1))
        return tl.forward(params, cfg, x, ck, cv, pos, **kw)
    lg_j, ids_j = _greedy(jax_fwd, lambda lg: np.argmax(np.asarray(lg)[0]), p_j, cfg_j,
                          ids, jl.init_cache(cfg_j, 1, 128), 8)
    lg_t, ids_t = _greedy(torch_fwd, lambda lg: torch.argmax(lg[0]), p_t, cfg_t, ids,
                          tl.init_cache(cfg_t, 1, 128), 8)
    assert ids_t == ids_j
    for a, b in zip(lg_t, lg_j):
        np.testing.assert_allclose(a, b, atol=ATOL)
