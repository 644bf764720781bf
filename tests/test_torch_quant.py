"""The port's int8 weights and int8 KV cache against the JAX package's, on
the CPU, in f32.

Quantized weights within +-1 of the JAX package's and scales at rtol 1e-6;
the int8 cache's _cache_write the same; forwards over int8 weights (also as
converted from the JAX package's quantized dict) and over the int8 cache
(plain, from-zero flash and flash over the dequantized `kv_bucket` slice,
the JAX flash path run in interpret mode) at atol 1e-3 on the logits; and
greedy generate with a prefix-reuse follow-up through `Generator`, ids
exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _random_llama
from test_torch_generation import FOLLOW, GREEDY, PROMPT, llama_dir  # noqa: F401
from test_torch_llama import ATOL, _ids, interpret_flash  # noqa: F401

from kjarni_tpu.generate.sampling import GenerationConfig as JaxGenerationConfig
from kjarni_tpu.models import llama as jl
from kjarni_tpu.tasks.generator import Generator as JaxGenerator
from kjarni_tpu_torch.generate.sampling import GenerationConfig
from kjarni_tpu_torch.models import llama as tl
from kjarni_tpu_torch.tasks.generator import Generator
from kjarni_tpu_torch.weights.convert import params_from_jax

PROJ = ("q", "k", "v", "o", "gate", "up", "down")


@pytest.fixture(scope="module")
def model():
    cfg_j, params_np = _random_llama({"num_layers": 2, "max_seq_len": 512})
    cfg_t = tl.DecoderConfig(**{f.name: getattr(cfg_j, f.name)
                                for f in dataclasses.fields(tl.DecoderConfig)})
    return cfg_j, cfg_t, params_np


def _assert_int8_close(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.int8
    diff = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1, diff.max()


def test_quantize_params_int8_matches_jax(model):
    _, _, params_np = model
    q_np = jl.quantize_params_int8(params_np)
    q_t = tl.quantize_params_int8(params_from_jax(params_np))
    for name in PROJ:
        _assert_int8_close(q_t["layers"][name]["w"], q_np["layers"][name]["w"])
        np.testing.assert_allclose(q_t["layers"][name]["scale"].numpy(),
                                   q_np["layers"][name]["scale"], rtol=1e-6)
    _assert_int8_close(q_t["lm_head"]["w"], q_np["lm_head"]["w"])
    np.testing.assert_allclose(q_t["lm_head"]["scale"].numpy(),
                               q_np["lm_head"]["scale"], rtol=1e-6)
    # embeddings and norms keep their dtype
    assert q_t["embed"].dtype == q_t["layers"]["attn_norm"].dtype == torch.float32


def _run(fwd, init, cfg, params, chunks, to, quantized, **last_kw):
    """Prefill `chunks` in turn at the running position (the last with
    last_kw) over a fresh cache; returns (logits, cache_k) as numpy."""
    ck, cv = init(cfg, 1, 512, quantized=quantized)
    pos = 0
    for i, ids in enumerate(chunks):
        kw = last_kw if i == len(chunks) - 1 else {}
        lg, ck, cv = fwd(params, cfg, to(ids), ck, cv, pos, **kw)
        pos += ids.shape[1]
    return np.asarray(lg), jax.tree.map(np.asarray, ck) if isinstance(ck, dict) \
        else np.asarray(ck)


def _both(model, chunks, weights="f32", quantized=False, **kw):
    cfg_j, cfg_t, params_np = model
    if weights == "int8":
        params_np = jl.quantize_params_int8(params_np)
    j = _run(jl.forward, jl.init_cache, cfg_j, jax.tree.map(jnp.asarray, params_np),
             chunks, jnp.asarray, quantized, **kw)
    t = _run(tl.forward, tl.init_cache, cfg_t, params_from_jax(params_np), chunks,
             lambda ids: torch.from_numpy(ids).long(), quantized, **kw)
    return j, t


def test_int8_params_from_jax_forward_matches_jax(model):
    """params_from_jax keeps the JAX package's int8 {"w", "scale"} entries
    as int8 and f32 (they came across as float weights before)."""
    _, _, params_np = model
    q_t = params_from_jax(jl.quantize_params_int8(params_np))
    assert q_t["layers"]["q"]["w"].dtype == torch.int8
    assert q_t["lm_head"]["scale"].dtype == torch.float32
    (lg_j, _), (lg_t, _) = _both(model, [_ids(64, 20), _ids(1, 21)], weights="int8")
    np.testing.assert_allclose(lg_t, lg_j, atol=ATOL)


def test_int8_logits_stay_close_to_f32(model):
    """The JAX package's bound (tests/test_generation.py): cosine > 0.999."""
    (_, _), (ref, _) = _both(model, [_ids(32, 22)])
    (_, _), (got, _) = _both(model, [_ids(32, 22)], weights="int8")
    r, g = np.ravel(ref), np.ravel(got)
    assert r @ g / (np.linalg.norm(r) * np.linalg.norm(g)) > 0.999


@pytest.mark.parametrize("S,pos", [(8, 0), (5, 17)])
def test_cache_write_int8_matches_jax(S, pos):
    rng = np.random.default_rng(S + pos)
    new = (rng.standard_normal((2, 3, S, 16)) * 2).astype(np.float32)
    new[0, 1, 0] = 0.0     # an all-zero row takes the 1e-6 floor
    cache_j = {"q": jnp.zeros((2, 3, 32, 16), jnp.int8),
               "s": jnp.zeros((2, 3, 32), jnp.float32)}
    cache_j, full_j = jl._cache_write(cache_j, jnp.asarray(new), pos, jnp.float32)
    cache_t = {"q": torch.zeros(2, 3, 32, 16, dtype=torch.int8),
               "s": torch.zeros(2, 3, 32)}
    tl._cache_write(cache_t, torch.from_numpy(new), pos)
    _assert_int8_close(cache_t["q"], cache_j["q"])
    np.testing.assert_allclose(cache_t["s"].numpy(), np.asarray(cache_j["s"]), rtol=1e-6)
    np.testing.assert_allclose(tl._cache_read(cache_t, 32, torch.float32).numpy(),
                               np.asarray(full_j), atol=ATOL)
    with pytest.raises(Exception, match="exceeds"):
        tl._cache_write(cache_t, torch.from_numpy(new), 32 - S + 1)


@pytest.mark.parametrize("case", ["prefill_then_decode", "flash_from_zero",
                                  "flash_kv_bucket"])
@pytest.mark.parametrize("weights", ["f32", "int8"])
def test_int8_cache_forward_matches_jax(model, interpret_flash, case, weights):  # noqa: F811
    """llama.forward over the int8 cache: plain attention over the
    dequantized cache, flash from zero over the fresh bf16-layout K/V, and
    flash over the dequantized kv_bucket slice at q_offset (kv_bucket > S)."""
    chunks = {"prefill_then_decode": [_ids(100, 23), _ids(1, 24)],
              "flash_from_zero": [_ids(128, 25)],
              "flash_kv_bucket": [_ids(128, 26), _ids(128, 27)]}[case]
    kw = {"flash_from_zero": dict(use_flash=True),
          "flash_kv_bucket": dict(use_flash=True, kv_bucket=256)}.get(case, {})
    (lg_j, ck_j), (lg_t, ck_t) = _both(model, chunks, weights, quantized=True, **kw)
    np.testing.assert_allclose(lg_t, lg_j, atol=ATOL)
    # K/V come out of matmuls summed in other orders (~1e-7 relative), so a
    # value on a rounding edge may land one step over: q within +-1, the
    # scales at rtol 1e-5, and the dequantized caches within one step + atol
    diff = np.abs(ck_t["q"].astype(np.int32) - ck_j["q"].astype(np.int32))
    assert diff.max() <= 1
    np.testing.assert_allclose(ck_t["s"], ck_j["s"], rtol=1e-5)
    deq_t, deq_j = ck_t["q"] * ck_t["s"][..., None], ck_j["q"] * ck_j["s"][..., None]
    assert (np.abs(deq_t - deq_j) <= ATOL + ck_j["s"][..., None]).all()


@pytest.mark.parametrize("kw", [dict(quantize="int8"), dict(kv_cache="int8"),
                                dict(quantize="int8", kv_cache="int8")])
def test_generate_reuse_and_stream_match_jax(llama_dir, kw):  # noqa: F811
    jg = JaxGenerator(str(llama_dir), **kw)
    tg = Generator(str(llama_dir), device="cpu", **kw)
    if "quantize" in kw and kw["quantize"] == "int8":
        assert tg.lm.params["layers"]["q"]["w"].dtype == torch.int8
    if "kv_cache" in kw:
        assert tg.lm._ensure_cache()[0]["q"].dtype == torch.int8

    assert tg.generate(PROMPT, **GREEDY) == jg.generate(PROMPT, **GREEDY)
    assert tg.lm._session_ids == jg.lm._session_ids

    # the follow-up prefills only its new suffix over the reused (int8) cache
    extra = tg.lm.encode_prompt(FOLLOW, add_bos=False)
    follow = list(tg.lm._session_ids) + extra
    g = dict(max_new_tokens=16, max_length=128)
    assert tg.lm.generate(token_ids=follow, config=GenerationConfig.greedy(**g)) == \
        jg.lm.generate(token_ids=follow, config=JaxGenerationConfig.greedy(**g))
    assert tg.lm.last_prefill_tokens == jg.lm.last_prefill_tokens == len(extra)
    assert tg.lm._session_ids == jg.lm._session_ids

    t_ids = [st.id for st in tg.generate_stream(FOLLOW, **GREEDY)]
    assert t_ids == [st.id for st in jg.generate_stream(FOLLOW, **GREEDY)]
