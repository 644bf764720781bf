"""Operations and bytes of the two kernels and of a request, against hand counts."""

import pytest

from kbench import lookup
from kbench.roofline import costs
from kbench.roofline.peaks import BF16_FLOP_PER_S, HBM_BYTES_PER_S


def _pairs_by_hand(S, T, causal, window, q_offset, kv_len):
    n = 0
    for s in range(S):
        pos = q_offset + s
        for t in range(min(T, kv_len)):
            if causal and t > pos:
                continue
            if window and t <= pos - window:
                continue
            n += 1
    return n


@pytest.mark.parametrize("S,T,causal,window,q_offset,kv_len", [
    (64, 64, True, None, 0, 64), (16, 80, True, None, 60, 76), (32, 32, False, None, 0, 32),
    (40, 40, True, 8, 0, 40), (10, 200, True, None, 100, 110), (5, 50, False, None, 0, 20)])
def test_attended_pairs(S, T, causal, window, q_offset, kv_len):
    assert costs.attended_pairs(S, T, causal, window, q_offset, kv_len) == \
        _pairs_by_hand(S, T, causal, window, q_offset, kv_len)


def test_flash_cost_by_hand():
    # Mistral-7B's flash wave: B 2 lanes, H 32, Hkv 8, S = T = 1024, D 128, causal
    flops, nbytes = costs.flash_cost(2, 32, 8, 1024, 1024, 128, True, None, 0, None)
    pairs = 1024 * 1025 // 2
    assert flops == 4 * 2 * 32 * pairs * 128
    assert nbytes == 2 * (2 * 2 * 32 * 1024 * 128 + 2 * 2 * 8 * 1024 * 128)
    # the bound of that launch is the operations'
    assert costs.bound_s(flops, nbytes) == flops / BF16_FLOP_PER_S
    # a reuse prefill reads keys only below kv_len
    _, nb = costs.flash_cost(1, 32, 8, 512, 2048, 128, True, None, 700, 1212)
    assert nb == 2 * (2 * 32 * 512 * 128 + 2 * 8 * 1212 * 128)


def test_int4_cost_by_hand():
    # one gate projection of Mistral-7B at M = 1: x bf16, w4 K/2 x N bytes,
    # one f32 scale per 128 rows and column, y bf16
    flops, nbytes = costs.int4_cost(1, 4096, 14336, 32)
    assert flops == 2 * 4096 * 14336
    assert nbytes == 4096 * 2 + 4096 * 14336 // 2 + 4 * 32 * 14336 + 14336 * 2
    assert costs.bound_s(flops, nbytes) == nbytes / HBM_BYTES_PER_S
    f2, _ = costs.int4_cost(1024, 4096, 14336, 32)
    assert costs.bound_s(f2, 0) == f2 / BF16_FLOP_PER_S


def test_useful_flops_by_hand():
    cfg = {"model_type": "llama", "hidden_size": 8, "intermediate_size": 16,
           "num_attention_heads": 2, "num_key_value_heads": 1, "num_hidden_layers": 3,
           "vocab_size": 10}
    # per layer: q 8x8, k and v 8x4 each, o 8x8, gate/up/down 3 x 8x16
    per_layer = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16
    assert lookup.architecture(cfg).matmul_params(cfg) == (3 * per_layer, 80)
    attn = 4 * 2 * 4 * 3          # 4 H D L per kept (query, key) pair
    prompt, new = 5, 3
    want = 2 * 3 * per_layer * 5 + attn * 15 + 2 * 80
    want += sum(2 * (3 * per_layer + 80) + attn * (prompt + j) for j in (1, 2))
    assert costs.useful_flops(cfg, prompt, new) == want
