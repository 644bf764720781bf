"""kjarni_tpu_torch's encoder (models/bert.py and the ops under it) against
the JAX package's, on the CPU, in f32.

Both packages load the same tiny checkpoints: the HF configs of
tests/test_bert_parity.py (bert, distilbert, roberta, mpnet) and
tests/test_nomic.py's NomicBERT dir, and run the same numpy inputs.
Tolerances are the JAX tests' own: hidden states atol 2e-4 / rtol 1e-3 and
cosine >= 0.999 (Nomic atol 1e-4); the pooler atol 5e-4; packed against
plain 2e-6; bucket tables, masks and rope tables exactly.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import save_torch_model
from test_nomic import make_nomic_dir

from kjarni_tpu.models import bert as jb
from kjarni_tpu.ops import activations as jact
from kjarni_tpu.ops import attention as jatt
from kjarni_tpu.ops import masks as jmasks
from kjarni_tpu.ops import norms as jnorms
from kjarni_tpu.ops import pooling as jpool
from kjarni_tpu.ops import rope as jrope
from kjarni_tpu.weights.safetensors_loader import ModelWeights as JaxWeights
from kjarni_tpu_torch.core.errors import InvalidConfigError
from kjarni_tpu_torch.models import bert as tb
from kjarni_tpu_torch.ops import activations as tact
from kjarni_tpu_torch.ops import attention as tatt
from kjarni_tpu_torch.ops import masks as tmasks
from kjarni_tpu_torch.ops import norms as tnorms
from kjarni_tpu_torch.ops import pooling as tpool
from kjarni_tpu_torch.ops import rope as trope
from kjarni_tpu_torch.weights.convert import params_from_jax
from kjarni_tpu_torch.weights.safetensors_loader import ModelWeights

COS_TOL = 0.999
PACK_ATOL = 2e-6


def _hf_model(flavor):
    """The tiny HF model of tests/test_bert_parity.py for `flavor`."""
    from transformers import (BertConfig, BertModel, DistilBertConfig, DistilBertModel,
                              MPNetConfig, MPNetModel, RobertaConfig, RobertaModel)
    if flavor == "bert":
        config = BertConfig(vocab_size=128, hidden_size=64, num_hidden_layers=3,
                            num_attention_heads=4, intermediate_size=128,
                            max_position_embeddings=64)
        cls, seed = BertModel, 0
    elif flavor == "distilbert":
        config = DistilBertConfig(vocab_size=100, dim=48, n_layers=2, n_heads=4,
                                  hidden_dim=96, max_position_embeddings=64)
        cls, seed = DistilBertModel, 1
    elif flavor == "roberta":
        config = RobertaConfig(vocab_size=120, hidden_size=64, num_hidden_layers=2,
                               num_attention_heads=4, intermediate_size=128,
                               max_position_embeddings=66, pad_token_id=1,
                               type_vocab_size=1)
        cls, seed = RobertaModel, 2
    else:
        config = MPNetConfig(vocab_size=120, hidden_size=64, num_hidden_layers=2,
                             num_attention_heads=4, intermediate_size=128,
                             max_position_embeddings=66)
        cls, seed = MPNetModel, 3
    torch.manual_seed(seed)
    return cls(config).eval(), config


FLAVORS = ("bert", "distilbert", "roberta", "mpnet", "nomic")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """flavor -> (dir, JAX config, JAX params, port config, port params)."""
    out = {}
    for flavor in FLAVORS:
        d = tmp_path_factory.mktemp(flavor)
        if flavor == "nomic":
            make_nomic_dir(d, seed=1)
        else:
            save_torch_model(d, *_hf_model(flavor))
        hf = json.loads((d / "config.json").read_text())
        jcfg, tcfg = jb.BertConfig.from_hf(hf), tb.BertConfig.from_hf(hf)
        out[flavor] = (d, jcfg, jb.load_params(JaxWeights(d), jcfg), tcfg,
                       tb.load_params(ModelWeights(d), tcfg))
    return out


def _inputs(cfg, seed, batch=2, seq=12, pad_from=9):
    """Random ids with the second row padded from `pad_from`, as the JAX
    tests' make_inputs (pads take the model's pad id)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, cfg.vocab_size - 1, size=(batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), dtype=np.int32)
    mask[1, pad_from:] = 0
    ids[1, pad_from:] = cfg.pad_token_id
    return ids, mask


def _ragged(cfg, seed, B, S):
    """B rows of random lengths 1..S, pads at the model's pad id."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, cfg.vocab_size - 1, (B, S)).astype(np.int32)
    mask = np.zeros((B, S), np.int32)
    for b in range(B):
        n = int(rng.integers(1, S + 1))
        mask[b, :n] = 1
        ids[b, n:] = cfg.pad_token_id
    return ids, mask


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _assert_close(got, expected, atol=2e-4, rtol=1e-3):
    np.testing.assert_allclose(got, expected, atol=atol, rtol=rtol)
    g, e = got.ravel(), expected.ravel()
    assert float(g @ e / (np.linalg.norm(g) * np.linalg.norm(e) + 1e-12)) >= COS_TOL


class TestEncode:
    @pytest.mark.parametrize("case", ["bert", "bert_token_types", "distilbert",
                                      "roberta", "mpnet", "nomic"])
    def test_matches_jax(self, checkpoints, case):
        flavor = case.split("_")[0]
        _, jcfg, jp, tcfg, tp = checkpoints[flavor]
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        ids, mask = _inputs(tcfg, seed=len(case))
        tt = None
        if case == "bert_token_types":
            tt = (np.arange(12)[None, :] >= 5).astype(np.int32).repeat(2, axis=0)
        want = np.asarray(jb.encode(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                    None if tt is None else jnp.asarray(tt)))
        got = tb.encode(tp, tcfg, _t(ids), torch.from_numpy(mask),
                        None if tt is None else _t(tt)).numpy()
        assert got.shape == (2, 12, tcfg.hidden_size)
        if flavor == "nomic":
            _assert_close(got, want, atol=1e-4, rtol=1e-4)
        else:
            _assert_close(got, want)

    def test_token_types_change_the_output(self, checkpoints):
        _, _, _, tcfg, tp = checkpoints["bert"]
        ids, mask = _inputs(tcfg, seed=3)
        a = tb.encode(tp, tcfg, _t(ids), torch.from_numpy(mask))
        b = tb.encode(tp, tcfg, _t(ids), torch.from_numpy(mask), torch.ones_like(_t(ids)))
        assert not torch.allclose(a, b)

    def test_pooler_matches_jax(self, checkpoints):
        _, jcfg, jp, tcfg, tp = checkpoints["bert"]
        hidden = np.random.default_rng(0).standard_normal((3, 5, 64)).astype(np.float32)
        want = np.asarray(jb.pooler_forward(jp["pooler"], jnp.asarray(hidden)))
        got = tb.pooler_forward(tp["pooler"], torch.from_numpy(hidden)).numpy()
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)

    def test_unknown_model_type_is_refused(self):
        with pytest.raises(InvalidConfigError):
            tb.BertConfig.from_hf({"model_type": "gpt2"})


@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (64, 256)])
def test_mpnet_bucket_table_is_exact(num_buckets, max_distance):
    """Every (query, key) bucket for S = 512, equal as integers: the log is
    f32 and the cast truncates toward zero in both packages."""
    pos = np.arange(512)
    rel = pos[None, :] - pos[:, None]
    want = np.asarray(jb._mpnet_relative_position_bucket(
        jnp.asarray(rel, jnp.int32), num_buckets, max_distance))
    got = tb._mpnet_relative_position_bucket(torch.from_numpy(rel), num_buckets,
                                             max_distance)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


class TestPacking:
    @pytest.mark.parametrize("flavor,n,B,S", [
        ("bert", 2, 6, 16), ("bert", 4, 8, 16), ("bert", 4, 4, 32),
        ("roberta", 4, 8, 16), ("mpnet", 2, 6, 16), ("nomic", 4, 8, 12)])
    def test_packed_equals_plain(self, checkpoints, flavor, n, B, S):
        _, _, _, tcfg, tp = checkpoints[flavor]
        ids, mask = _ragged(tcfg, 100 + n * 10 + S, B, S)
        tt = None
        if tcfg.type_vocab_size > 1:
            tt = _t((np.arange(S)[None, :] >= S // 2).astype(np.int32).repeat(B, axis=0))
        plain = tb.encode(tp, tcfg, _t(ids), torch.from_numpy(mask), tt)
        packed = tb.encode_packed_n(tp, tcfg, _t(ids), torch.from_numpy(mask), tt, n=n)
        np.testing.assert_allclose(packed.numpy(), plain.numpy(), atol=PACK_ATOL, rtol=0)

    def test_pairs_wrapper_is_pack2(self, checkpoints):
        _, _, _, tcfg, tp = checkpoints["bert"]
        ids, mask = _ragged(tcfg, 4, 4, 10)
        a = tb.encode_packed_pairs(tp, tcfg, _t(ids), torch.from_numpy(mask))
        b = tb.encode_packed_n(tp, tcfg, _t(ids), torch.from_numpy(mask), n=2)
        assert torch.equal(a, b)

    @pytest.mark.parametrize("B,S", [(8, 16), (6, 16), (5, 16), (7, 16), (3, 48),
                                     (8, 64)])
    def test_auto_equals_plain(self, checkpoints, B, S):
        """Whichever route _pack_plan picks (padding ragged batches with
        inert rows), encode_auto equals plain encode."""
        _, _, _, tcfg, tp = checkpoints["bert"]
        ids, mask = _ragged(tcfg, B * 1000 + S, B, S)
        plain = tb.encode(tp, tcfg, _t(ids), torch.from_numpy(mask))
        auto = tb.encode_auto(tp, tcfg, _t(ids), torch.from_numpy(mask))
        assert auto.shape == plain.shape
        np.testing.assert_allclose(auto.numpy(), plain.numpy(), atol=PACK_ATOL, rtol=0)

    @pytest.mark.parametrize("B,S", [(256, 64), (256, 32), (8, 16), (5, 16), (2, 16),
                                     (1, 16), (4, 100)])
    def test_pack_plan_is_plain_on_the_card(self, B, S):
        """The plan from the H100 gains in its docstring: packing never wins."""
        assert tb._pack_plan(B, S) == (1, 0)


class TestOps:
    @pytest.mark.parametrize("strategy", ["mean", "cls", "max", "last"])
    def test_pooling_matches_jax(self, strategy):
        rng = np.random.default_rng(5)
        hidden = rng.standard_normal((4, 9, 16)).astype(np.float32)
        mask = np.zeros((4, 9), np.int32)
        for b, n in enumerate((9, 4, 1, 6)):
            mask[b, :n] = 1
        want = np.asarray(jpool.pool(jpool.PoolingStrategy(strategy),
                                     jnp.asarray(hidden), jnp.asarray(mask)))
        got = tpool.pool(tpool.PoolingStrategy(strategy), torch.from_numpy(hidden),
                         torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)

    def test_gelu_is_tanh_on_bf16_and_erf_on_f32(self):
        x = np.linspace(-6, 6, 4001, dtype=np.float32)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        got_bf = tact.gelu(xb)
        assert got_bf.dtype == torch.bfloat16
        assert torch.equal(got_bf, torch.nn.functional.gelu(xb, approximate="tanh"))
        assert not torch.equal(got_bf, torch.nn.functional.gelu(xb))
        want_bf = np.asarray(jact.gelu(jnp.asarray(xb.float().numpy(), jnp.bfloat16)),
                             np.float32)
        # the same tanh form in both; XLA rounds each step to bf16 and torch
        # only the result, so they part by up to two bf16 ulps (2^-6 relative),
        # more in absolute terms where 1 + tanh cancels near zero
        got = got_bf.float().numpy()
        np.testing.assert_allclose(got, want_bf, rtol=2 ** -6, atol=4e-3)
        erf = torch.nn.functional.gelu(xb.float()).numpy()
        assert np.abs(got - erf).max() <= np.abs(want_bf - erf).max()
        np.testing.assert_allclose(tact.gelu(torch.from_numpy(x)).numpy(),
                                   np.asarray(jact.gelu(jnp.asarray(x))), atol=1e-6)

    @pytest.mark.parametrize("name", sorted(jact.ACTIVATIONS))
    def test_activation_matches_jax(self, name):
        x = np.linspace(-5, 5, 101, dtype=np.float32)
        np.testing.assert_allclose(tact.get_activation(name)(torch.from_numpy(x)).numpy(),
                                   np.asarray(jact.get_activation(name)(jnp.asarray(x))),
                                   atol=1e-6)

    def test_unknown_activation_is_refused(self):
        with pytest.raises(ValueError):
            tact.get_activation("mish")

    @pytest.mark.parametrize("with_bias", [True, False])
    def test_layer_norm_matches_jax(self, with_bias):
        rng = np.random.default_rng(6)
        x = rng.standard_normal((3, 7, 32)).astype(np.float32) * 3 + 1
        w = rng.standard_normal(32).astype(np.float32)
        b = rng.standard_normal(32).astype(np.float32) if with_bias else None
        want = np.asarray(jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                            None if b is None else jnp.asarray(b), 1e-5))
        got = tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                                None if b is None else torch.from_numpy(b), 1e-5)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        assert tnorms.layer_norm(xb, torch.from_numpy(w), None).dtype == torch.bfloat16

    def test_masks_match_jax(self):
        mask = np.array([[1, 1, 0, 0], [1, 1, 1, 1]], np.int32)
        np.testing.assert_array_equal(
            tmasks.padding_bias(torch.from_numpy(mask)).numpy(),
            np.asarray(jmasks.padding_bias(jnp.asarray(mask))))
        np.testing.assert_array_equal(tmasks.causal_mask(6).numpy(),
                                      np.asarray(jmasks.causal_mask(6)))
        np.testing.assert_array_equal(
            tmasks.causal_mask_with_offset(3, 8, 4).numpy(),
            np.asarray(jmasks.causal_mask_with_offset(3, 8, 4)))
        a, b = tmasks.causal_mask(4), tmasks.padding_bias(torch.from_numpy(mask))
        np.testing.assert_array_equal(
            tmasks.combine(a, None, b).numpy(),
            np.asarray(jmasks.combine(jmasks.causal_mask(4), None,
                                      jmasks.padding_bias(jnp.asarray(mask)))))
        assert tmasks.combine(None, None) is None
        assert tatt.NEG_INF == tmasks.NEG_INF == jmasks.NEG_INF

    @pytest.mark.parametrize("head_dim,length,theta", [(64, 8192, 1000.0),
                                                       (16, 64, 10000.0)])
    def test_rope_tables_are_exact(self, head_dim, length, theta):
        """Nomic's tables: f32 positions, so equal to the JAX package's bit
        for bit (llama.rope_cache's f64 positions would differ)."""
        jc, js = jrope.rope_tables(head_dim, length, theta=theta)
        tc, ts = trope.rope_tables(head_dim, length, theta=theta)
        assert tc.dtype == np.float32
        np.testing.assert_array_equal(tc, np.asarray(jc))
        np.testing.assert_array_equal(ts, np.asarray(js))

    def test_split_merge_heads_match_jax(self):
        x = np.arange(2 * 3 * 12, dtype=np.float32).reshape(2, 3, 12)
        got = tatt.split_heads(torch.from_numpy(x), 4)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jatt.split_heads(jnp.asarray(x), 4)))
        assert torch.equal(tatt.merge_heads(got), torch.from_numpy(x))

    def test_attention_with_padding_and_full_biases(self):
        """A [B, 1, 1, T] padding bias and a [1, H, S, T] bias give the same
        attention as the JAX package's."""
        rng = np.random.default_rng(7)
        q, k, v = (rng.standard_normal((2, 4, 6, 8)).astype(np.float32) for _ in range(3))
        mask = np.array([[1] * 6, [1] * 3 + [0] * 3], np.int32)
        pad = np.array(jmasks.padding_bias(jnp.asarray(mask)))
        full = rng.standard_normal((1, 4, 6, 6)).astype(np.float32)
        for bias in (pad, pad + full):
            want = np.asarray(jatt.attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), jnp.asarray(bias)))
            got = tatt.attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(bias))
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def _tree_equal(got, want, path=""):
    if want is None:
        assert got is None, path
        return
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _tree_equal(got[k], want[k], f"{path}.{k}")
        return
    assert got.dtype == want.dtype and torch.equal(got, want), path


class TestConvert:
    @pytest.mark.parametrize("flavor", FLAVORS)
    def test_jax_params_give_the_ports_own(self, checkpoints, flavor):
        """The JAX package's params carried across equal the port's
        load_params on the same dir, None leaves and f32 rope tables too."""
        d, jcfg, jp, tcfg, tp = checkpoints[flavor]
        _tree_equal(params_from_jax(jp), tp)
        if flavor == "nomic":
            bf = params_from_jax(jp, dtype=torch.bfloat16)
            assert bf["rope_cos"].dtype == torch.float32
            _tree_equal(bf, tb.load_params(ModelWeights(d), tcfg, torch.bfloat16))
