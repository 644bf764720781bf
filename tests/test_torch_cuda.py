"""kjarni_tpu_torch's CUDA kernels against their plain versions, on the card.

int4 at M = 1 (the decode GEMV) and at Ms across the GEMM's row tiles, with
one group and with groups of 128, ragged K/2 and N, K split across blocks
and not, and bit-identical repeat calls; flash with batch > 1,
no GQA, D = 128 with a window and an offset. Skipped without a card; on the
machine with the card (which has no jax, hence --noconftest):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: flash atol 3e-2 (bf16 output, bf16 probabilities in the kernel);
int4 max error <= 2e-2 of the output's largest magnitude and cosine > 0.999,
against the plain version evaluated in f32 on the same bf16 inputs. The
kernel accumulates in f32 and rounds once; the difference grows with sqrt(K)
times the output's scale, not with each element's own size, so at K = 4096 a
per-element rtol would misfire on outputs near zero.
"""

import pytest
import torch

from kjarni_tpu_torch.models.llama import _quant_int4
from kjarni_tpu_torch.ops.kernels.flash_attention import (flash_attention,
                                                          flash_attention_plain)
from kjarni_tpu_torch.ops.kernels.int4_matvec import (int4_matvec, int4_matvec_plain,
                                                      launch_plan)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


# M = 1 (the GEMV) and Ms at the edges of the GEMM's row tiles (32, 64, 128),
# both scale layouts (one group of 128 rows, and G == 1), aligned and ragged
# N, and the Llama head
_EDGE = [(1, 192, 200, 192), (1, 200, 128, 200), (37, 512, 264, 128),
         (5, 4096, 1000, 128), (16, 256, 128, 16), (8, 2048, 1002, 128),
         (2, 512, 999, 128)]
_MS = (1, 2, 8, 33, 64, 128, 700, 1024)
_GRID = [(M, 2048, N, group) for M in _MS for group in (128, 2048)
         for N in (512, 1000, 2048, 8192)]
_HEAD = [(M, 2048, 128256, 128) for M in (1, 2, 8)]


def _int4_inputs(card, M, K, N, group):
    g = torch.Generator(device=card).manual_seed(M + K + N)
    w = torch.randn(K, N, generator=g, device=card) * 0.05
    w4, scale = _quant_int4(w, group)
    x = torch.randn(M, K, generator=g, device=card).to(torch.bfloat16)
    return x, w4, scale


@pytest.mark.parametrize("M,K,N,group", _EDGE + _GRID + _HEAD)
def test_int4_kernel_matches_plain(card, M, K, N, group):
    x, w4, scale = _int4_inputs(card, M, K, N, group)
    got = int4_matvec(x, w4, scale).float()
    # the plain version evaluated in f32 on the same bf16 inputs
    ref = int4_matvec_plain(x.float(), w4, scale)
    torch.cuda.synchronize()
    assert got.shape == (M, N) and torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    assert err <= 2e-2 * ref.abs().max().item(), err
    cos = torch.nn.functional.cosine_similarity(got.reshape(-1), ref.reshape(-1), dim=0)
    assert cos.item() > 0.999


@pytest.mark.parametrize("M,K,N,group", [(1, 8192, 2048, 128), (1, 2048, 512, 2048),
                                         (8, 8192, 1000, 128), (1024, 2048, 8192, 128),
                                         (1024, 2048, 512, 128)])
def test_int4_kernel_is_deterministic(card, M, K, N, group):
    """No float atomics: the GEMV sums its lanes in a fixed tree, and a GEMM
    split across K sums its splits in order. Repeated calls are bit-identical."""
    if M > 1 and N <= 1000:
        assert launch_plan(M, K, N, K // group).splits > 1
    x, w4, scale = _int4_inputs(card, M, K, N, group)
    first = int4_matvec(x, w4, scale)
    for _ in range(3):
        assert torch.equal(int4_matvec(x, w4, scale), first)


@pytest.mark.parametrize("B,H,Hkv,S,T,D,window,q_offset,kv_len", [
    (2, 4, 4, 100, 100, 64, None, 0, None),
    (1, 8, 2, 96, 384, 128, 40, 250, 346),
    (1, 6, 2, 1, 300, 64, None, 299, 300),
    (3, 4, 1, 130, 130, 32, 17, 0, None),
])
def test_flash_kernel_matches_plain(card, B, H, Hkv, S, T, D, window, q_offset,
                                    kv_len):
    g = torch.Generator(device=card).manual_seed(S + T + D)
    q = torch.randn(B, H, S, D, generator=g, device=card).to(torch.bfloat16)
    k = torch.randn(B, Hkv, T, D, generator=g, device=card).to(torch.bfloat16)
    v = torch.randn(B, Hkv, T, D, generator=g, device=card).to(torch.bfloat16)
    kw = dict(causal=True, window=window, q_offset=q_offset, kv_len=kv_len)
    got = flash_attention(q, k, v, **kw).float()
    ref = flash_attention_plain(q, k, v, **kw).float()
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=0, atol=3e-2)


def test_kernels_refuse_f32_on_the_card(card):
    q = torch.zeros(1, 2, 8, 64, device=card)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
    with pytest.raises(TypeError):
        int4_matvec(torch.zeros(1, 256, device=card),
                    torch.zeros(128, 64, dtype=torch.int8, device=card),
                    torch.ones(2, 64, device=card))
