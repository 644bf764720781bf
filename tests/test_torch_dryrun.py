"""The port's dry run (kjarni_tpu_torch/parallel/dryrun.py) on 8 gloo CPU
ranks against the JAX package's: its five phases and lines, and phase 1's
loss equal (rel 1e-5) to the JAX package's `causal_lm_loss` on the same
params and batch, computed here in-process rather than through
`__graft_entry__.dryrun_multichip`'s virtual-device subprocess. The port's
numpy recipe for the params is held to `_random_llama`'s, draw for draw.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from __graft_entry__ import _random_llama
from kjarni_tpu.parallel.train import causal_lm_loss
from kjarni_tpu_torch.parallel import dryrun


def _flat(tree, pre=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, pre + (k,))
    else:
        yield pre, np.asarray(tree)


@pytest.mark.parametrize("over", [dryrun.train_config(4), dryrun.STAGE_SHAPES])
def test_random_llama_is_the_jax_recipe(over):
    jcfg, jp = _random_llama(dict(over))
    tcfg, tp_ = dryrun.random_llama(dict(over))
    assert dataclasses.asdict(tcfg) == {k: v for k, v in dataclasses.asdict(jcfg).items()
                                        if k in dataclasses.asdict(tcfg)}
    want, got = dict(_flat(jp)), dict(_flat(tp_))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_dryrun_8_ranks_phases_and_jax_loss(capfd):
    loss = dryrun.dryrun_multichip(8, device="cpu")
    out = capfd.readouterr().out
    phases = [ln for ln in out.splitlines() if ln.startswith("dryrun")]
    assert phases == ["dryrun phase: train step (dp=2 tp=4)", "dryrun phase: train step ok",
                      "dryrun phase: sharded decode ok", "dryrun phase: pp ring decode ok",
                      "dryrun phase: sp prefill ok", "dryrun phase: product tp=4 ok",
                      f"dryrun_multichip ok: mesh dp=2 tp=4, loss={loss:.4f}, pp=ok sp=ok "
                      "product_tp=ok"]
    cfg, params = _random_llama(dryrun.train_config(4))
    ids, labels, mask = dryrun.train_inputs(cfg, 2)
    want = float(causal_lm_loss({k: v for k, v in params.items()}, cfg, jnp.asarray(ids),
                                jnp.asarray(labels), jnp.asarray(mask)))
    assert loss == pytest.approx(want, rel=1e-5)
