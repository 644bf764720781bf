"""kjarni_tpu_torch's sampling chain against the JAX package's, on the CPU.

Draws cannot match (jax.random vs torch.Generator), so the filter masks, the
penalised logits and the greedy choices are compared on the same numpy
inputs; the masked-out entries are NEG_INF in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kjarni_tpu.generate import sampling as js
from kjarni_tpu_torch.generate import sampling as ts


def logits(seed, V=1000, ties=False):
    x = np.random.default_rng(seed).standard_normal(V).astype(np.float32) * 3
    if ties:   # a run of equal values around the cutoffs
        x[10:40] = x.max()
        x[100:200] = np.round(x[100:200])
    return x


def both(fn_name, x, *args):
    j = np.asarray(getattr(js, fn_name)(jnp.asarray(x), *args))
    t = getattr(ts, fn_name)(torch.from_numpy(x), *args).numpy()
    return j, t


class TestFilterMasks:
    @pytest.mark.parametrize("k", [1, 5, 50, 999])
    @pytest.mark.parametrize("ties", [False, True])
    def test_top_k(self, k, ties):
        j, t = both("top_k_filter", logits(k, ties=ties), k)
        np.testing.assert_array_equal(t, j)

    @pytest.mark.parametrize("p", [0.01, 0.5, 0.9, 0.99])
    def test_top_p(self, p):
        j, t = both("top_p_filter", logits(int(p * 100)), p)
        np.testing.assert_array_equal(t > ts.NEG_INF / 2, j > js.NEG_INF / 2)

    @pytest.mark.parametrize("min_p", [0.0, 0.05, 0.5])
    def test_min_p(self, min_p):
        j, t = both("min_p_filter", logits(7), min_p)
        np.testing.assert_array_equal(t > ts.NEG_INF / 2, j > js.NEG_INF / 2)


class TestPenalties:
    def _history(self, seed, T=64, V=1000):
        h = np.random.default_rng(seed).integers(0, 50, T).astype(np.int32)
        return h, V

    @pytest.mark.parametrize("penalty", [1.3, 0.8])
    def test_repetition_penalty(self, penalty):
        h, V = self._history(1)
        valid = (np.arange(64) < 40).astype(np.int32)
        x = logits(2, V)
        j = js.apply_repetition_penalty(jnp.asarray(x), jnp.asarray(h),
                                        jnp.asarray(valid), penalty)
        t = ts.apply_repetition_penalty(torch.from_numpy(x), torch.from_numpy(h),
                                        torch.from_numpy(valid), penalty)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)

    @pytest.mark.parametrize("n,length", [(2, 30), (3, 40), (3, 1), (4, 64)])
    def test_no_repeat_ngram(self, n, length):
        h = np.tile(np.array([5, 6, 7, 5, 6], np.int32), 13)[:64]
        x = logits(3)
        j = js.apply_no_repeat_ngram(jnp.asarray(x), jnp.asarray(h), length, n)
        t = ts.apply_no_repeat_ngram(torch.from_numpy(x), torch.from_numpy(h),
                                     length, n)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)

    def test_process_logits_chain(self):
        h, _ = self._history(4)
        x = logits(5)
        j = js.process_logits(jnp.asarray(x), jnp.asarray(h), 50, 1.2, 3)
        t = ts.process_logits(torch.from_numpy(x), torch.from_numpy(h), 50, 1.2, 3)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)

    @pytest.mark.parametrize("penalty,n", [(1.2, 3), (0.8, 0), (1.0, 2)])
    def test_process_logits_batched_matches_jax_vmap(self, penalty, n):
        """[B, V] logits over [B, T] histories with a length per row, as
        generate_batch calls it, against the JAX package's vmap of the [V] form."""
        import jax
        h = np.stack([self._history(s)[0] for s in range(4)])
        h[2] = np.tile(np.array([5, 6, 7, 5, 6], np.int32), 13)[:64]
        x = np.stack([logits(10 + s) for s in range(4)])
        lengths = np.array([1, 17, 40, 64], np.int32)
        j = jax.vmap(lambda lg, t, k: js.process_logits(lg, t, k, penalty, n))(
            jnp.asarray(x), jnp.asarray(h), jnp.asarray(lengths))
        t = ts.process_logits(torch.from_numpy(x), torch.from_numpy(h),
                              torch.from_numpy(lengths).long(), penalty, n)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
        for r in range(4):   # each row as the [V] form alone
            one = ts.process_logits(torch.from_numpy(x[r]), torch.from_numpy(h[r]),
                                    int(lengths[r]), penalty, n)
            np.testing.assert_array_equal(t[r].numpy(), one.numpy())


class TestGreedy:
    @pytest.mark.parametrize("case", ["random", "ties", "all_equal", "last",
                                      "neg_inf_masked"])
    def test_argmax_first_occurrence(self, case):
        x = logits(6)
        if case == "ties":
            x[[17, 300, 999]] = x.max() + 1
        elif case == "all_equal":
            x[:] = 0.5
        elif case == "last":
            x[-1] = x.max() + 1
        elif case == "neg_inf_masked":
            x[:] = js.NEG_INF
            x[[42, 43]] = 1.0
        j = int(js.fast_argmax(jnp.asarray(x)))
        t = int(ts.sample_token(torch.from_numpy(x), None, ts.SamplingParams(), True))
        assert t == j

    def test_sampled_token_stays_in_filtered_set(self):
        x = logits(8)
        sp = ts.SamplingParams(temperature=0.9, top_k=20, top_p=0.9, min_p=0.05)
        keep = np.asarray(js.min_p_filter(js.top_p_filter(
            js.top_k_filter(jnp.asarray(x), 20), 0.9), 0.05)) > js.NEG_INF / 2
        g = torch.Generator().manual_seed(0)
        draws = {int(ts.sample_token(torch.from_numpy(x), g, sp, False))
                 for _ in range(200)}
        assert draws and all(keep[d] for d in draws)
