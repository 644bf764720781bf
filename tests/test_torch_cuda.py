"""kjarni_tpu_torch's CUDA kernels against their plain versions, on the card.

Edge shapes that chip_smoke.py's main-path cases do not reach: one int4
group, ragged K/2 and N, several row tiles, split K; flash with batch > 1,
no GQA, D = 128 with a window and an offset. Skipped without a card; on the
machine with the card (which has no jax, hence --noconftest):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: flash atol 3e-2 (bf16 output, bf16 probabilities in the kernel);
int4 max error <= 2e-2 of the output's largest magnitude and cosine > 0.999.
The int4 plain version rounds each dequantized weight to bf16 and the kernel
does not, so their difference grows with sqrt(K) times the output's scale,
not with each element's own size: at K = 4096 a per-element rtol misfires
on outputs near zero.
"""

import pytest
import torch

from kjarni_tpu_torch.models.llama import _quant_int4
from kjarni_tpu_torch.ops.kernels.flash_attention import (flash_attention,
                                                          flash_attention_plain)
from kjarni_tpu_torch.ops.kernels.int4_matvec import int4_matvec, int4_matvec_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


@pytest.mark.parametrize("M,K,N,group", [(1, 192, 200, 192), (1, 200, 128, 200),
                                         (37, 512, 264, 128), (5, 4096, 1000, 128),
                                         (16, 256, 128, 16)])
def test_int4_kernel_matches_plain(card, M, K, N, group):
    g = torch.Generator(device=card).manual_seed(M + K + N)
    w = torch.randn(K, N, generator=g, device=card) * 0.05
    w4, scale = _quant_int4(w, group)
    x = torch.randn(M, K, generator=g, device=card).to(torch.bfloat16)
    got = int4_matvec(x, w4, scale).float()
    ref = int4_matvec_plain(x, w4, scale).float()
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    assert err <= 2e-2 * ref.abs().max().item(), err
    cos = torch.nn.functional.cosine_similarity(got.reshape(-1), ref.reshape(-1), dim=0)
    assert cos.item() > 0.999


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
