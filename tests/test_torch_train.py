"""The port's training step (kjarni_tpu_torch/parallel/train.py) against the
JAX package's (kjarni_tpu/parallel/train.py), on the CPU, in f32, at
`_random_llama`'s dryrun shapes (tests/test_parallel.py's tiny llama).

One process: JAX's `value_and_grad(causal_lm_loss)` and `sgd_train_step`
against `loss_and_grads` / `sgd_train_step` with a ragged mask, a tied head
(the port's view `embed.t()` against JAX's separate `embed.T` leaf) and the
rope tables' own gradients and step. Loss rel 1e-5; gradients rtol 1e-4 /
atol 1e-6; the updated params atol 1e-7, lr (1e-3) times the gradients'
atol, with rtol 1e-6 for the rounding of p - lr * g.

Ranks (gloo groups from tests/torch_dist.py, one per size): dp 2 x tp 4 on
8 ranks, dp 2 and tp 2 on 2 ranks, each against JAX's single-device step on
the whole batch, with a mask whose count differs across the dp rows; the
gradients and params are gathered whole (`gather_params`). gradcheck in
f64 of the Megatron collectives at world 2. Integer (quantized) params
raise TypeError, as `jax.value_and_grad` does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist as td
from __graft_entry__ import _random_llama
from kjarni_tpu.models import llama as jl
from kjarni_tpu.parallel import train as jtrain
from kjarni_tpu_torch.models import llama as tl
from kjarni_tpu_torch.parallel import train as ttrain
from kjarni_tpu_torch.weights.convert import params_from_jax

TINY = {"num_heads": 8, "num_kv_heads": 4, "head_dim": 16, "hidden_size": 128,
        "intermediate_size": 256, "vocab_size": 256, "max_seq_len": 64, "num_layers": 2}
LR = 1e-3


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory):
    g = td.RankGroup(8, tmp_path_factory.mktemp("ranks8"))
    yield g
    g.close()


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    g = td.RankGroup(2, tmp_path_factory.mktemp("ranks2"))
    yield g
    g.close()


def _llama(**over):
    cfg, params = _random_llama({**TINY, **over})
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(tl.DecoderConfig)}
    return cfg, params, kw


def _batch(B=4, S=16, seed=1):
    """ids, labels and a mask whose first half of rows is ragged (the
    second half all ones), so the dp ranks' counts differ."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TINY["vocab_size"], (B, S)).astype(np.int32)
    labels = rng.integers(0, TINY["vocab_size"], (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    for b in range(B // 2):
        mask[b, int(rng.integers(1, S)):] = 0
    return ids, labels, mask


def _flat(tree, pre=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, pre + (k,))
    else:
        yield pre, np.asarray(tree)


def _jax(params, cfg, ids, labels, mask):
    jp = jax.tree.map(jnp.asarray, params)
    args = (cfg, jnp.asarray(ids), jnp.asarray(labels), jnp.asarray(mask))
    loss, grads = jax.value_and_grad(jtrain.causal_lm_loss)(jp, *args)
    new, loss2 = jtrain.sgd_train_step(jp, *args, lr=LR)
    assert float(loss2) == float(loss)
    return float(loss), dict(_flat(grads)), dict(_flat(new))


def _assert_step(loss, grads, new, want):
    wloss, wgrads, wnew = want
    assert loss == pytest.approx(wloss, rel=1e-5)
    grads, new = dict(_flat(grads)), dict(_flat(new))
    assert grads.keys() == wgrads.keys() == new.keys() == wnew.keys()
    for k in wgrads:
        np.testing.assert_allclose(grads[k], wgrads[k], rtol=1e-4, atol=1e-6, err_msg=str(k))
        np.testing.assert_allclose(new[k], wnew[k], rtol=1e-6, atol=1e-7, err_msg=str(k))


def _numpy(tree):
    return {k: _numpy(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.numpy()


@pytest.mark.parametrize("tied", [False, True])
def test_one_process_step_equals_jax(tied):
    cfg, params, kw = _llama()
    if tied:   # JAX's tied head: a separate leaf holding embed.T
        params["lm_head"] = np.ascontiguousarray(params["embed"].T)
    ids, labels, mask = _batch()
    want = _jax(params, cfg, ids, labels, mask)
    tp_ = params_from_jax(params)
    if tied:   # the port's tied head: a view of the table (models/llama.py)
        tp_["lm_head"] = tp_["embed"].t()
    tcfg = tl.DecoderConfig(**kw)
    batch = [torch.from_numpy(a.astype(np.int64)) for a in (ids, labels, mask)]
    loss, grads = ttrain.loss_and_grads(tp_, tcfg, *batch)
    new, loss2 = ttrain.sgd_train_step(tp_, tcfg, *batch, lr=LR)
    assert float(loss2) == float(loss)
    _assert_step(float(loss), _numpy(grads), _numpy(new), want)
    # the rope tables take their gradient and their step, as JAX's leaves
    assert np.abs(want[1][("rope_cos",)]).max() > 1e-4
    assert not np.array_equal(new["rope_sin"].numpy(), params["rope_sin"])
    # the input params are left as they were; the head is no longer tied
    np.testing.assert_array_equal(tp_["embed"].numpy(), params["embed"])
    if tied:
        assert new["lm_head"].data_ptr() != new["embed"].data_ptr()


def test_all_masked_batch_takes_the_clamped_count():
    """max(sum(m), 1): a mask of zeros gives loss 0 and zero gradients."""
    cfg, params, kw = _llama()
    ids, labels, mask = _batch()
    mask[:] = 0
    want = _jax(params, cfg, ids, labels, mask)
    batch = [torch.from_numpy(a.astype(np.int64)) for a in (ids, labels, mask)]
    loss, grads = ttrain.loss_and_grads(params_from_jax(params), tl.DecoderConfig(**kw), *batch)
    assert float(loss) == want[0] == 0.0
    assert all(not np.any(g) for _, g in _flat(_numpy(grads)))


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_int_params_raise_type_error_as_jax(quantize):
    """jax.value_and_grad refuses integer leaves with TypeError; the port's
    step refuses them the same way before any forward."""
    cfg, params, kw = _llama()
    ids, labels, mask = _batch()
    jq = (jl.quantize_params_int8(jax.tree.map(jnp.asarray, params)) if quantize == "int8"
          else jl.quantize_params_int4(jax.tree.map(jnp.asarray, params), group_size=16))
    with pytest.raises(TypeError, match="grad requires"):
        jtrain.sgd_train_step(jq, cfg, jnp.asarray(ids), jnp.asarray(labels), jnp.asarray(mask))
    tq = params_from_jax(jax.tree.map(np.asarray, jq))
    batch = [torch.from_numpy(a.astype(np.int64)) for a in (ids, labels, mask)]
    with pytest.raises(TypeError, match="grad requires"):
        ttrain.sgd_train_step(tq, tl.DecoderConfig(**kw), *batch)


def test_dp2_tp4_step_equals_jax(ranks8):
    """JAX's dryrun layout (__graft_entry__.py): dp 2 x tp 4, B = 2 * dp."""
    cfg, params, kw = _llama()
    ids, labels, mask = _batch()
    want = _jax(params, cfg, ids, labels, mask)
    got = ranks8.run(td.train_step, params, kw, ids, labels, mask, 2, 4, LR)
    for r in got:
        assert r["loss"] == r["loss2"] == pytest.approx(want[0], rel=1e-5)
    _assert_step(got[0]["loss"], got[0]["grads"], got[0]["params"], want)


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2)])
def test_two_rank_steps_equal_jax(ranks2, dp, tp):
    cfg, params, kw = _llama()
    ids, labels, mask = _batch()
    want = _jax(params, cfg, ids, labels, mask)
    got = ranks2.run(td.train_step, params, kw, ids, labels, mask, dp, tp, LR)
    assert got[0]["loss"] == got[1]["loss"]
    _assert_step(got[0]["loss"], got[0]["grads"], got[0]["params"], want)


def test_collectives_gradcheck_and_inference_identity(ranks2):
    for r in ranks2.run(td.collective_gradchecks):
        assert r == {"f_gather": True, "f_g": True, "copy_in_is_x": True,
                     "reduce_out_in_place": True}
