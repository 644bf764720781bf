"""kjarni_tpu_torch's CUDA kernels against their plain versions, on the card.

int4 at M = 1 (the decode GEMV) and at Ms across the GEMM's row tiles, with
one group and with groups of 128, ragged K/2 and N, K split across blocks
and not, and bit-identical repeat calls; the TMA / wgmma GEMM at Mistral-7B's
prefill shapes and ragged M, one launch a call; flash at D = 32, 64, 96 and 128 and G = 1, 3, 4, 6, 7
and 8 (the zoo's groups at their prefill and cache-reuse shapes), with batch > 1, S and T across several 64-key tiles with ragged edges,
every tile class (interior, causal diagonal, window left edge, kv_len edge
with a poisoned tail), q in the [B, S, H, D] storage that the model passes,
and bit-identical repeat calls. Also the encoder (the embed path, which has no
hand-written kernel): its bf16 embeddings against f32 on the card, and that it
launches neither kernel; and a tiny decoder's generation, batch, continuous
engine (flash admission forced by a shrunk score gate) and speculative
decoding on the card, each held against its plain kernels' forward. f32 on
the card: the f32 flash kernel over the same tile classes and head dims
(within 1e-5 of the largest output), its TF32-only control outside that
bound, int4 with f32 activations (rounded to bf16, f32 out) against the
plain version in that form, the decode GEMV's own rounding of f32 x
bit-identical to torch's cast plus the kernel and one kernel per call, f16
refused, Generator(dtype="f32") against the CPU's greedy ids, and the CLI's
generate against Generator's text. Skipped without a card; on the machine with the card
(which has no jax, hence --noconftest):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: flash atol 3e-2 (bf16 output, bf16 probabilities in the kernel);
int4 max error <= 2e-2 of the output's largest magnitude and cosine > 0.999,
against the plain version evaluated in f32 on the same bf16 inputs. The
kernel accumulates in f32 and rounds once; the difference grows with sqrt(K)
times the output's scale, not with each element's own size, so at K = 4096 a
per-element rtol would misfire on outputs near zero.
"""

import contextlib
import ctypes
import json

import pytest
import torch

from kjarni_tpu_torch.models.llama import _quant_int4
from kjarni_tpu_torch.ops.kernels import build
from kjarni_tpu_torch.ops.kernels.flash_attention import (flash_attention,
                                                          flash_attention_f32_tf32only,
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


# one rank of the tp decoder at Llama-3.2-1B's widths (chip_smoke.tp_shapes):
# q, k/v, gate/up and the head take N/tp columns, o and down K/tp rows (their
# groups of 128 regrouped per rank), at tp = 2 and 4, decode and prefill
_TP_SHARDS = [(2048, 1024), (2048, 256), (1024, 2048), (2048, 4096), (4096, 2048),
              (2048, 64128), (2048, 512), (2048, 128), (512, 2048), (2048, 2048),
              (2048, 32064)]


@pytest.mark.parametrize("M", [1, 1024])
@pytest.mark.parametrize("K,N", _TP_SHARDS)
def test_int4_kernel_at_tp_shard_shapes(card, M, K, N):
    test_int4_kernel_matches_plain(card, M, K, N, 128)


@pytest.mark.parametrize("H,Hkv", [(16, 4), (8, 2)], ids=["tp2", "tp4"])
def test_flash_kernel_at_tp_rank_heads(card, H, Hkv):
    """A tp rank's prefill attention: Llama-3.2-1B's heads split 2 and 4 ways."""
    test_flash_kernel_matches_plain(card, 1, H, Hkv, 1024, 1024, 64, None, 0, None)


@pytest.mark.parametrize("H", [6, 3], ids=["tp2", "tp4"])
def test_flash_kernel_at_whisper_tp_rank_heads(card, H):
    """A tp rank of whisper-small's encoder: 12 heads split 2 and 4 ways,
    S = T = 1500, non-causal."""
    test_flash_kernel_tile_classes(card, 1, H, H, 1500, 1500, 64, False, None, 0, None)


# the zoo's decoders (chip_smoke.py phase 19, zoo_flash_shapes): GQA groups
# 7 (Qwen2.5-0.5B, 14 / 2 heads, D 64), 6 (Qwen2.5-1.5B, 12 / 2, D 128) and 3
# (Llama-3.2-3B, 24 / 8, D 128), each at its 1024 prefill and its follow-up's
# cache reuse (S 1024 at q_offset over a kv bucket of 1792, the tail
# poisoned), a ragged S, and whisper-large-v3's encoder (20 heads)
_ZOO_TILES = [
    (1, 14, 2, 1024, 1024, 64, True, None, 0, None),
    (1, 14, 2, 1024, 1792, 64, True, None, 732, 1756),
    (1, 14, 2, 700, 700, 64, True, None, 0, None),
    (1, 12, 2, 1024, 1024, 128, True, None, 0, None),
    (1, 12, 2, 1024, 1792, 128, True, None, 732, 1756),
    (1, 12, 2, 333, 333, 128, True, None, 0, None),
    (1, 24, 8, 1024, 1024, 128, True, None, 0, None),
    (1, 24, 8, 1024, 1792, 128, True, None, 733, 1757),
    (2, 24, 8, 130, 130, 128, True, 40, 0, None),
    (1, 32, 32, 1024, 1792, 96, True, None, 732, 1756),
    (1, 20, 20, 1500, 1500, 64, False, None, 0, None),
]


@pytest.mark.parametrize("B,H,Hkv,S,T,D,causal,window,q_offset,kv_len", _ZOO_TILES)
def test_flash_kernel_at_zoo_shapes(card, B, H, Hkv, S, T, D, causal, window, q_offset,
                                    kv_len):
    test_flash_kernel_tile_classes(card, B, H, Hkv, S, T, D, causal, window, q_offset,
                                   kv_len)


@pytest.mark.parametrize("B,H,Hkv,S,T,D,causal,window,q_offset,kv_len", _ZOO_TILES)
def test_flash_f32_kernel_at_zoo_shapes(card, B, H, Hkv, S, T, D, causal, window,
                                        q_offset, kv_len):
    test_flash_f32_kernel_tile_classes(card, B, H, Hkv, S, T, D, causal, window,
                                       q_offset, kv_len)


# every int4 projection shape (K, N) of the zoo's decoders (chip_smoke.py
# zoo_int4_shapes): Qwen2.5-0.5B (K = 896: one scale per column), Qwen2.5-1.5B,
# Llama-3.2-3B and Phi-3.5-mini, Mistral-7B and Llama-3.1-8B; then their heads
_ZOO_INT4 = [(896, 896), (896, 128), (896, 4864), (4864, 896),
             (1536, 1536), (1536, 256), (1536, 8960), (8960, 1536),
             (3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072),
             (4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
_ZOO_HEADS = [(896, 151936), (1536, 151936), (3072, 128256), (3072, 32064),
              (4096, 32768), (4096, 128256)]


@pytest.mark.parametrize("M", [1, 1024])
@pytest.mark.parametrize("K,N", _ZOO_INT4)
def test_int4_kernel_at_zoo_shapes(card, M, K, N):
    test_int4_kernel_matches_plain(card, M, K, N, 128)


@pytest.mark.parametrize("K,N", _ZOO_HEADS)
def test_int4_kernel_at_zoo_heads(card, K, N):
    test_int4_kernel_matches_plain(card, 1, K, N, 128)


# a batched prefill: B = 8 rows at bucket 1024, every Llama-1B projection
@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)])
def test_int4_kernel_at_batch_times_bucket(card, K, N):
    test_int4_kernel_matches_plain(card, 8 * 1024, K, N, 128)


# Mistral-7B's projections (K, N): q and o, k and v, gate and up, down; and a
# Qwen2.5-0.5B width with one scale per column
_MISTRAL_INT4 = [(4096, 4096, 128), (4096, 1024, 128), (4096, 14336, 128),
                 (14336, 4096, 128), (896, 4864, 896)]


@pytest.mark.parametrize("M", [1000, 1024, 4096, 4097, 8192])
@pytest.mark.parametrize("K,N,group", _MISTRAL_INT4)
def test_int4_wgmma_kernel_at_prefill_shapes(card, M, K, N, group):
    """The TMA / wgmma GEMM at the prefill buckets and ragged M: the plan
    takes it, and it holds the plain version's bound."""
    assert launch_plan(M, K, N, K // group).path == "wgmma"
    before = int4_matvec.launches_by_path["wgmma"]
    test_int4_kernel_matches_plain(card, M, K, N, group)
    assert int4_matvec.launches_by_path["wgmma"] == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int4_wgmma_kernel_is_one_launch(card, dtype):
    """One call on the wgmma path launches exactly one kernel, named
    int4_gemm_kernel..., in bf16 and with f32 x (whose cast to bf16 is the
    wrapper's one elementwise kernel beside it)."""
    from torch.profiler import ProfilerActivity, profile
    x, w4, scale = _int4_inputs(card, 1024, 4096, 4096, 128)
    x = x.to(dtype)
    int4_matvec(x, w4, scale)                  # built and loaded outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        int4_matvec(x, w4, scale)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    ours = [k for k in kernels if "int4_gemm_kernel" in k]
    assert len(ours) == 1 and "sm90" in ours[0], kernels
    assert len(kernels) == (1 if dtype == torch.bfloat16 else 2), kernels


@pytest.mark.parametrize("M,K,N,group", [(1, 8192, 2048, 128), (1, 2048, 512, 2048),
                                         (8, 8192, 1000, 128), (1024, 2048, 8192, 128),
                                         (1024, 2048, 512, 128), (256, 2048, 512, 128),
                                         (8192, 14336, 4096, 128), (1000, 896, 4864, 896)])
def test_int4_kernel_is_deterministic(card, M, K, N, group):
    """No float atomics: the GEMV sums its lanes in a fixed tree, a GEMM
    split across K sums its splits in order, and the wgmma GEMM keeps K in
    one block. Repeated calls are bit-identical."""
    plan = launch_plan(M, K, N, K // group)
    if M > 1 and N <= 1000:
        assert plan.splits > 1 or plan.path == "wgmma"
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


# (B, H, Hkv, S, T, D, causal, window, q_offset, kv_len); kv_len cases poison
# the K/V tail past kv_len
_FLASH_TILES = [
    (1, 8, 8, 200, 200, 96, True, None, 0, None),       # G = 1, Phi-3's D
    (2, 16, 4, 333, 333, 64, True, None, 0, None),      # G = 4, batch 2
    (1, 32, 4, 130, 130, 128, True, None, 0, None),     # G = 8
    (1, 8, 1, 257, 257, 32, True, None, 0, None),       # G = 8, one KV head
    (1, 8, 2, 300, 300, 64, True, 100, 0, None),        # window left edge
    (1, 4, 4, 256, 256, 96, True, 70, 0, None),
    (1, 16, 4, 100, 512, 64, True, None, 300, 400),     # kv_len edge, offset
    (1, 8, 8, 70, 448, 96, True, None, 310, 380),
    (1, 16, 2, 64, 320, 128, True, 50, 200, 264),       # all three at once
    (1, 4, 2, 150, 190, 64, False, None, 0, 170),       # not causal
    (1, 32, 8, 1024, 1024, 64, True, None, 0, None),    # Llama-1B prefill
    (1, 12, 12, 1500, 1500, 64, False, None, 0, None),  # whisper-small's encoder:
    (4, 12, 12, 1500, 1500, 64, False, None, 0, None),  # 23 full key tiles + 28
]


@pytest.mark.parametrize("B,H,Hkv,S,T,D,causal,window,q_offset,kv_len", _FLASH_TILES)
def test_flash_kernel_tile_classes(card, B, H, Hkv, S, T, D, causal, window,
                                   q_offset, kv_len):
    g = torch.Generator(device=card).manual_seed(B + H + S + T + D)
    # q as the model passes it: [B, S, H, D] storage seen as [B, H, S, D]
    q = torch.randn(B, S, H, D, generator=g, device=card).to(torch.bfloat16)
    q = q.transpose(1, 2)
    k = torch.randn(B, Hkv, T, D, generator=g, device=card).to(torch.bfloat16)
    v = torch.randn(B, Hkv, T, D, generator=g, device=card).to(torch.bfloat16)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    ref = flash_attention_plain(q, k, v, **kw).float()
    if kv_len is not None:
        k[:, :, kv_len:], v[:, :, kv_len:] = 1e3, -1e3
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.shape == (B, H, S, D) and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), ref, rtol=0, atol=3e-2)
    assert torch.equal(flash_attention(q, k, v, **kw), got)


def test_flash_kernel_refuses_unsupported_head_dims(card):
    for D in (80, 256):
        q = torch.zeros(1, 2, 8, D, device=card, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            flash_attention(q, q, q)


@pytest.mark.parametrize("B,H,Hkv,S,T,D,causal,window,q_offset,kv_len", _FLASH_TILES)
def test_flash_f32_kernel_tile_classes(card, B, H, Hkv, S, T, D, causal, window,
                                       q_offset, kv_len):
    """The f32 kernel over the same tile classes and all four head dims:
    within 1e-5 of the plain output's largest magnitude (both compute in f32;
    they differ in the order of their sums), bit-identical on a repeat, and
    counted as the f32 kernel's launch."""
    g = torch.Generator(device=card).manual_seed(B + H + S + T + D + 1)
    q = torch.randn(B, S, H, D, generator=g, device=card).transpose(1, 2)
    k = torch.randn(B, Hkv, T, D, generator=g, device=card)
    v = torch.randn(B, Hkv, T, D, generator=g, device=card)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    ref = flash_attention_plain(q, k, v, **kw)
    if kv_len is not None:
        k[:, :, kv_len:], v[:, :, kv_len:] = 1e3, -1e3
    before = flash_attention.launches, flash_attention.launches_f32
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (B, H, S, D)
    assert (flash_attention.launches, flash_attention.launches_f32) == \
        (before[0], before[1] + 1)
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err
    assert torch.equal(flash_attention(q, k, v, **kw), got)


@pytest.mark.parametrize("M,K,N,group", [(1, 2048, 8192, 128), (1, 2048, 128256, 128),
                                         (1, 200, 128, 200), (8, 2048, 1002, 128),
                                         (8, 8192, 2048, 128), (33, 512, 264, 128),
                                         (1024, 2048, 8192, 128), (1024, 2048, 512, 2048),
                                         (1000, 4096, 1024, 128), (4097, 14336, 4096, 128)])
def test_int4_kernel_f32_activations(card, M, K, N, group):
    """An f32 x: the kernel rounds it to bf16 (as the Pallas body does) and
    writes f32, held to the plain version in the same form (x_as_bf16)
    within 1e-5 of its largest output (the two differ only in the order of
    their f32 sums); the same output stored through bf16 must fall outside
    that bound; a repeat is bit-identical."""
    x, w4, scale = _int4_inputs(card, M, K, N, group)
    x = x.float() + torch.randn(M, K, device=card) * 1e-3   # not already bf16
    got = int4_matvec(x, w4, scale)
    ref = int4_matvec_plain(x, w4, scale, x_as_bf16=True)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype == torch.float32 and got.shape == (M, N)
    tol = 1e-5 * ref.abs().max().item()
    err = (got - ref).abs().max().item()
    assert err <= tol, (err, tol)
    assert (got.to(torch.bfloat16).float() - ref).abs().max().item() > tol
    assert torch.equal(int4_matvec(x, w4, scale), got)


# the TF32-only control at the Llama-1B prefill and the D = 128 case of
# chip_smoke.py's f32 flash phase
_TF32_CONTROL = [(1, 32, 8, 1024, 1024, 64), (1, 16, 4, 512, 512, 128)]


@pytest.mark.parametrize("B,H,Hkv,S,T,D", _TF32_CONTROL)
def test_flash_f32_tf32_only_control_breaks_the_bound(card, B, H, Hkv, S, T, D):
    """The f32 kernel's accuracy comes from the split: with its small terms
    dropped (one TF32 product each) the same call falls outside the 1e-5
    bound that the kernel holds, by a TF32-sized error (under 1e-2 of the
    largest output, not a broken call), and is not counted as a launch."""
    g = torch.Generator(device=card).manual_seed(H + S + D)
    q = torch.randn(B, H, S, D, generator=g, device=card)
    k = torch.randn(B, Hkv, T, D, generator=g, device=card)
    v = torch.randn(B, Hkv, T, D, generator=g, device=card)
    ref = flash_attention_plain(q, k, v, causal=True)
    tol = 1e-5 * ref.abs().max().item()
    before = flash_attention.launches_f32
    bad = flash_attention_f32_tf32only(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches_f32 == before
    assert tol < (bad - ref).abs().max().item() < 1e3 * tol
    assert (flash_attention(q, k, v, causal=True) - ref).abs().max().item() <= tol


# every M = 1 case of test_int4_kernel_f32_activations, one decoded token's
# projections at Llama-1B width (q/o, k/v, gate/up, down) and its head
_F32_GEMV = [(1, 2048, 8192, 128), (1, 2048, 128256, 128), (1, 200, 128, 200),
             (1, 2048, 2048, 128), (1, 2048, 512, 128), (1, 8192, 2048, 128)]


def _int4_cast_then_kernel(x, w4, scale, plan):
    """The form that the GEMV's own f32 load replaced: x rounded to bf16 by
    torch, then the bf16-x, f32-output entry point."""
    xb = x.to(torch.bfloat16)
    M, K = x.shape
    N, G = w4.shape[1], scale.shape[0]
    y = torch.empty(M, N, dtype=torch.float32, device=x.device)
    lib = build.load("int4_matvec")
    fn = lib.kj_int4_matvec_bf16_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(xb.data_ptr(), w4.data_ptr(), scale.data_ptr(), y.data_ptr(), None, None,
             M, K, N, G, 0, plan.col_threads, plan.rows_per_lane, plan.row_tile,
             plan.splits, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "int4_matvec")
    return y


@pytest.mark.parametrize("M,K,N,group", _F32_GEMV)
def test_int4_gemv_takes_f32_x_bit_for_bit(card, M, K, N, group):
    """The GEMV rounds an f32 x to bf16 where it loads it: bit-identical to
    the wrapper's cast followed by the bf16-x, f32-output entry point."""
    x, w4, scale = _int4_inputs(card, M, K, N, group)
    x = x.float() + torch.randn(M, K, device=card) * 1e-3   # not already bf16
    plan = launch_plan(M, K, N, K // group)
    assert plan.path == "gemv"
    got = int4_matvec(x, w4, scale)
    cast = _int4_cast_then_kernel(x, w4, scale, plan)
    torch.cuda.synchronize()
    assert got.dtype == cast.dtype == torch.float32
    assert torch.equal(got, cast)


def test_int4_f32_gemv_is_one_kernel(card):
    """One call with f32 x at M = 1 launches exactly one kernel: no cast."""
    from torch.profiler import ProfilerActivity, profile
    x, w4, scale = _int4_inputs(card, 1, 2048, 8192, 128)
    x = x.float()
    int4_matvec(x, w4, scale)                  # built and loaded outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        int4_matvec(x, w4, scale)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    assert [e.name for e in kernels if "int4_gemv_kernel" in e.name] and len(kernels) == 1, \
        [e.name for e in kernels]


def test_kernels_refuse_f16_on_the_card(card):
    q = torch.zeros(1, 2, 8, 64, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
    with pytest.raises(TypeError):
        flash_attention(q.float(), q.float(), q)
    with pytest.raises(TypeError):
        int4_matvec(torch.zeros(1, 256, device=card, dtype=torch.float16),
                    torch.zeros(128, 64, dtype=torch.int8, device=card),
                    torch.ones(2, 64, device=card))


# a two-layer MiniLM-shaped BERT (chip_smoke.py writes the full-width one)
_TINY_BERT = {"model_type": "bert", "vocab_size": 30522, "hidden_size": 128,
              "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 512,
              "hidden_act": "gelu", "max_position_embeddings": 512, "type_vocab_size": 2,
              "layer_norm_eps": 1e-12, "pad_token_id": 0}


@pytest.fixture(scope="module")
def encoder_dir(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the encoder's entry points run on it")
    import chip_smoke
    d = tmp_path_factory.mktemp("tiny_bert")
    chip_smoke.write_encoder_dir(d, _TINY_BERT, seed=3)
    return d, chip_smoke._sentences(16, 5, 40, seed=4)


def test_embedder_bf16_matches_f32_on_the_card(encoder_dir):
    """Cosine >= 0.999 per row (BASELINE.json's parity bound) and unit norms."""
    import numpy as np
    from kjarni_tpu_torch import Embedder
    from kjarni_tpu_torch.models.encoder_models import SentenceEncoder
    d, texts = encoder_dir
    emb = Embedder(str(d))
    assert emb._encoder.params["layers"]["q"]["w"].dtype == torch.bfloat16
    got = emb.embed_batch(texts)
    want = SentenceEncoder(d, dtype="f32").encode_batch(texts)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert np.isfinite(got).all() and cos.min() >= 0.999, cos.min()
    assert np.abs(np.linalg.norm(got, axis=-1) - 1).max() <= 1e-3


def test_encoder_launches_no_hand_written_kernel(encoder_dir):
    from kjarni_tpu_torch.models.encoder_models import SentenceEncoder
    d, texts = encoder_dir
    before = flash_attention.launches, int4_matvec.launches
    SentenceEncoder(d).encode_batch(texts)
    torch.cuda.synchronize()
    assert (flash_attention.launches, int4_matvec.launches) == before


def test_encoder_device_none_is_the_card(encoder_dir):
    from kjarni_tpu_torch.models.encoder_models import SentenceEncoder
    enc = SentenceEncoder(encoder_dir[0], device=None)
    assert enc.device == torch.device("cuda")
    assert enc.params["layers"]["q"]["w"].device == torch.device("cuda", 0)
    assert enc.params["embeddings"]["word"].dtype == torch.bfloat16


# a two-layer Llama-shaped decoder (chip_smoke.py writes the full-width one)
_TINY_LLAMA = {"model_type": "llama", "vocab_size": 4096, "hidden_size": 256,
               "intermediate_size": 512, "num_hidden_layers": 2, "num_attention_heads": 4,
               "num_key_value_heads": 2, "head_dim": 64, "max_position_embeddings": 2048,
               "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
               "bos_token_id": 1, "eos_token_id": 2, "torch_dtype": "bfloat16"}


@pytest.fixture(scope="module")
def decoder_dir(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the decoder's entry points run on it")
    import chip_smoke
    d = tmp_path_factory.mktemp("tiny_llama")
    chip_smoke.write_model_dir(d, seed=5, c=_TINY_LLAMA)
    chip_smoke.write_tokenizer(d / "tokenizer.json", _TINY_LLAMA["vocab_size"])
    prompts = [chip_smoke._prompt(n, seed=6 + n, hi=4000) for n in (40, 90, 300, 600)]
    return d, prompts


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_tp2_forward_on_the_card_matches_tp1(decoder_dir, tmp_path, dtype):
    """DecoderLM(tp=2) as two gloo ranks sharing cuda:0 (tests/torch_dist.py),
    each with half the heads (flash on its own) and half the head's columns,
    against tp = 1 on the card: f32 logits within 1e-4 of the largest, bf16
    ones with tp = 2's top token within the 0.5-logit tie band of tp = 1's."""
    import numpy as np
    import torch_dist
    from kjarni_tpu_torch.models.decoder_lm import DecoderLM
    d, prompts = decoder_dir
    group = torch_dist.RankGroup(2, tmp_path)
    try:
        got = group.run(torch_dist.tp_prefill_on_the_card, str(d), prompts[3], dtype)
    finally:
        group.close()
    lm = DecoderLM(d, dtype=dtype)
    ids = lm.encode_prompt(prompts[3])
    assert len(ids) > 512      # the prefill takes flash
    import chip_smoke
    ref = chip_smoke.prefill_logits(lm, ids)[0].cpu().numpy()
    np.testing.assert_array_equal(got[0], got[1])
    if dtype == "f32":
        assert np.abs(got[0] - ref).max() <= 1e-4 * np.abs(ref).max()
    else:
        assert ref.max() - ref[got[0].argmax()] <= 0.5


def test_tp2_server_on_the_card(decoder_dir, tmp_path):
    """`serve --tp 2` under SPMD as two gloo ranks sharing cuda:0: two
    concurrent /v1/completions clients of rank 0's server, each greedy
    answer within the 0.5-logit tie band of tp = 1's teacher-forced plain
    forward on the card."""
    import chip_smoke
    import torch_dist
    from kjarni_tpu_torch.models.decoder_lm import DecoderLM
    d, prompts = decoder_dir
    body = {"prompt": prompts[3], "max_tokens": 8, "temperature": 0}
    group = torch_dist.RankGroup(2, tmp_path)
    try:
        got = group.run(torch_dist.on_the_card, "http_spmd", {"generate": str(d)},
                        {"tp": 2}, [("/v1/completions", body)] * 2)
    finally:
        group.close()
    assert got[1] == "followed"
    lm = DecoderLM(d)
    p_ids = lm.encode_prompt(prompts[3])
    for code, out in got[0]:
        toks = lm.tokenizer.encode(out["choices"][0]["text"], add_special_tokens=False)
        assert code == 200 and 1 <= len(toks) <= 8
        ref = chip_smoke._teacher_forced(lm, p_ids + toks[:-1],
                                         list(range(len(p_ids) - 1, len(p_ids) - 1 + len(toks))))
        assert max(chip_smoke._margins(ref, toks)) <= 0.5


def test_train_step_on_the_card_holds_f64(decoder_dir):
    """One sgd_train_step (parallel/train.py) of the tiny decoder in f32 on
    the card, TF32 off: the loss within 1e-5 (relative) and each leaf's
    gradient within 1e-4 of its largest |g| of the same step in f64; the
    step launches neither kernel."""
    import chip_smoke
    from kjarni_tpu_torch.parallel.train import loss_and_grads, sgd_train_step
    d, _ = decoder_dir
    before = chip_smoke._all_counts()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, p32 = chip_smoke._train_params(str(d), 2, torch.float32, "cuda")
    batch = [t.cuda() for t in chip_smoke._train_batch(cfg.vocab_size)]
    loss32, g32 = loss_and_grads(p32, cfg, *batch)
    new, loss = sgd_train_step(p32, cfg, *batch)
    assert float(loss) == float(loss32) and torch.isfinite(new["embed"]).all()
    loss64, g64 = loss_and_grads(chip_smoke._tree_map(lambda t: t.double(), p32), cfg,
                                 *batch)
    assert abs(float(loss32) - float(loss64)) <= 1e-5 * abs(float(loss64))
    want = dict(chip_smoke._tree_leaves(g64))
    for k, g in chip_smoke._tree_leaves(g32):
        top = want[k].abs().max().item()
        assert (g.double() - want[k]).abs().max().item() <= 1e-4 * top, k
    assert chip_smoke._all_counts() == before


def test_sampled_decoding_on_the_card(decoder_dir):
    """Seeded sampling, single-stream and batched: a seed repeats its
    stream, and every draw lies in its row's top-k / top-p / min-p set."""
    import chip_smoke
    from kjarni_tpu_torch import Generator
    d, prompts = decoder_dir
    gen = Generator(str(d))
    assert gen.lm.device.type == "cuda"
    with chip_smoke.DrawCheck() as dc:
        chip_smoke.sampled(gen, prompts)
    assert dc.draws > 0


@pytest.mark.parametrize("kw", [{}, dict(quantize="int4"), dict(quantize="int8"),
                                dict(kv_cache="int8")])
def test_generate_batch_on_the_card(decoder_dir, kw):
    """Greedy generate_batch on the card: one row per prompt, no flash (the
    padded batch takes the plain attention), int4 launches only under
    quantize="int4"."""
    from kjarni_tpu_torch import Generator
    d, prompts = decoder_dir
    gen = Generator(str(d), **kw)
    before = flash_attention.launches, int4_matvec.launches
    out = gen.generate_batch(prompts, preset="greedy", max_new_tokens=8, max_length=2048)
    assert len(out) == len(prompts) and all(isinstance(t, str) for t in out)
    assert flash_attention.launches == before[0]
    assert (int4_matvec.launches > before[1]) == (kw.get("quantize") == "int4")


def _engine_run(lm, prompts, quantize):
    """The tiny decoder's ContinuousEngine (4 slots, windows of 4) over
    `prompts` with every admission wave forced onto flash (a 1-byte score
    gate), the engine's admission and first decode logits captured."""
    import chip_smoke
    from kjarni_tpu_torch.generate.continuous import ContinuousEngine
    eng = ContinuousEngine(lm, slots=4, max_context=2048, steps_per_sync=4)
    eng._admit_score_limit = 1
    prompt_len, meta = {}, {}
    probe = chip_smoke.EngineProbe(eng, prompt_len, capture=True)
    for i, p in enumerate(prompts):
        ids = lm.encode_prompt(p)
        rid = eng.submit(token_ids=ids, max_new_tokens=8, defer_admit=i < 2)
        prompt_len[rid], meta[rid] = len(ids), (ids, False)
    done = {fr.request_id: fr for fr in eng.run()}
    return {"probe": probe, "done": done, "meta": meta}


@pytest.mark.parametrize("quantize", [None, "int4"])
def test_continuous_engine_on_the_card(decoder_dir, quantize):
    """Flash admission waves (forced by a shrunk score gate) and slot decode
    on the card, in bf16 and int4: the engine's admission and first decode
    logits hold cosine >= 0.998 against the teacher-forced single stream
    with the plain kernels, with the kernels and with the engine itself run
    on the plain kernels; the kernels' run launches flash (one launch per
    layer of each wave) and, under int4, int4 at M = slots."""
    import chip_smoke
    from kjarni_tpu_torch import Generator
    d, prompts = decoder_dir
    lm = Generator(str(d), quantize=quantize).lm
    before = flash_attention.launches, int4_matvec.launches
    with chip_smoke.int4_shapes({}) as shapes:
        run = _engine_run(lm, prompts, quantize)
    flash_n = flash_attention.launches - before[0]
    waves = run["probe"].modes.get("flash", 0)
    assert set(run["probe"].modes) == {"flash"} and flash_n == 2 * waves > 0
    assert (int4_matvec.launches > before[1]) == (quantize == "int4")
    if quantize == "int4":
        assert shapes.get(4, 0) > 0
    held = chip_smoke.hold_engine_rows(lm, run)
    assert held["min_cosine"] >= 0.998 and held["rows"] >= 4 * 5, held
    with chip_smoke.plain_kernels():
        plain = _engine_run(lm, prompts, quantize)
    assert flash_attention.launches - before[0] == flash_n
    held = chip_smoke.hold_engine_rows(lm, plain)
    assert held["min_cosine"] >= 0.998, held
    for rid, fr in run["done"].items():
        a, b = run["probe"].adm[rid], plain["probe"].adm[rid]
        assert torch.nn.functional.cosine_similarity(a, b, dim=0) >= 0.998


@pytest.mark.parametrize("quantize", [None, "int4"])
def test_speculative_on_the_card(decoder_dir, quantize):
    """A self-drafting SpeculativeGenerator on the card: flash prefills of
    the target and the draft, int4 at M = 5 (target pass) and 1 (draft
    steps), and every emitted token within 0.05 of the teacher-forced
    maximum of the plain kernels' forward (the bf16 tie band of this tiny
    model's logits); the same with the generator on the plain kernels."""
    import chip_smoke
    from kjarni_tpu_torch import Generator
    from kjarni_tpu_torch.generate.sampling import GenerationConfig
    from kjarni_tpu_torch.generate.speculative import SpeculativeGenerator
    d, prompts = decoder_dir
    lm = Generator(str(d), quantize=quantize).lm
    ids = lm.encode_prompt(prompts[3])
    cfg = GenerationConfig.greedy(max_new_tokens=24, max_length=2048)
    for plain in (False, True):
        spec = SpeculativeGenerator(lm, lm, num_tokens=4)
        before = flash_attention.launches
        with chip_smoke.plain_kernels() if plain else contextlib.nullcontext(), \
                chip_smoke.int4_shapes({}) as shapes:
            out = [st.id for st in spec.generate_stream(token_ids=ids, config=cfg)]
        if not plain:
            assert flash_attention.launches - before == 2 * 2   # target and draft prefills
            if quantize == "int4":
                assert shapes.get(5, 0) > 0 and shapes.get(1, 0) > 0, shapes
        ref = chip_smoke._teacher_forced(lm, ids + out,
                                         list(range(len(ids) - 1, len(ids) + len(out) - 1)))
        margins = chip_smoke._margins(ref, out)
        assert len(out) == 24 and max(margins) <= 0.05, margins
        assert spec.last_acceptance_rate >= 0.75


# tiny encoder-decoders in chip_smoke.py's checkpoint layouts (it writes the
# registry defaults at full width): BART with 2 + 1 layers, Whisper with
# 2 + 2 layers and head_dim 64 (the flash kernel's)
_TINY_BART = {"model_type": "bart", "vocab_size": 1000, "d_model": 64, "encoder_layers": 2,
              "decoder_layers": 1, "encoder_attention_heads": 2, "decoder_attention_heads": 2,
              "encoder_ffn_dim": 128, "decoder_ffn_dim": 128, "max_position_embeddings": 256,
              "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2,
              "decoder_start_token_id": 2, "forced_bos_token_id": 0, "forced_eos_token_id": 2,
              "task_specific_params": {"summarization": {
                  "early_stopping": True, "length_penalty": 2.0, "max_length": 24,
                  "min_length": 4, "no_repeat_ngram_size": 3, "num_beams": 3}}}
_TINY_WHISPER = {"model_type": "whisper", "vocab_size": 51865, "d_model": 128,
                 "encoder_layers": 2, "decoder_layers": 2, "encoder_attention_heads": 2,
                 "decoder_attention_heads": 2, "encoder_ffn_dim": 256, "decoder_ffn_dim": 256,
                 "num_mel_bins": 80, "max_source_positions": 1500,
                 "max_target_positions": 448}
_TIE_BAND = 0.5     # bf16 against f32 logits (chip_smoke.py's serve and whisper band)


@pytest.fixture(scope="module")
def encdec_dirs(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the encoder-decoders' entry points run on it")
    import chip_smoke
    bart = tmp_path_factory.mktemp("tiny_bart")
    chip_smoke.write_encdec_dir(bart, _TINY_BART, seed=7)
    chip_smoke.write_word_tokenizer(bart / "tokenizer.json", _TINY_BART["vocab_size"],
                                    {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3},
                                    "<s> $A </s>")
    whisper = tmp_path_factory.mktemp("tiny_whisper")
    chip_smoke.write_encdec_dir(whisper, _TINY_WHISPER, seed=8)
    chip_smoke.write_tokenizer(whisper / "tokenizer.json", _TINY_WHISPER["vocab_size"],
                               chip_smoke.whisper_specials())
    return bart, whisper


def _normalized_score(lm, text_ids, mask, tokens, lp):
    """The f32 model's length-normalized log-probability of one beam output."""
    fam, cfg = lm.family, lm.config
    with torch.inference_mode():
        _, ck, cv = lm._encode_and_cross(text_ids, mask)
        dec = [cfg.decoder_start_token_id] + tokens
        sk, sv = fam.init_self_cache(cfg, 1, 64, lm.dtype, lm.device)
        logits, _, _ = fam.decode_step(lm.params, cfg, torch.tensor([dec[:-1]]), sk, sv,
                                       ck, cv, mask, 0)
        logp = torch.log_softmax(logits[0].float(), -1)
        total = logp[torch.arange(len(tokens)), torch.tensor(tokens)].sum().item()
    return total / max(len(tokens), 1) ** lp


def test_bart_summarize_on_the_card_matches_the_cpu(encdec_dirs):
    """f32 on the card: the same beam tokens as the port's f32 CPU run of the
    same weights; bf16 (the default): a summary that the f32 model scores
    within the tie band of its own, and no kernel launch."""
    import chip_smoke
    from kjarni_tpu_torch import Summarizer
    from kjarni_tpu_torch.models.seq2seq_lm import Seq2SeqLM
    d = encdec_dirs[0]
    text = chip_smoke._words(60, 10, 990, seed=9)
    cpu = Summarizer(str(d), device="cpu")
    lm_cpu, lm32 = cpu._gen.lm, Seq2SeqLM(d, dtype="f32")
    assert lm32.device.type == "cuda"
    ids, mask = lm_cpu._encode_input(text)
    bs, _ = lm_cpu.beam_config(task="summarization")
    want = lm_cpu._generate_fused(bs, ids, mask)
    assert lm32._generate_fused(bs, ids.cuda(), mask.cuda()) == want
    assert lm32.generate(text, task="summarization") == cpu.summarize(text)
    before = flash_attention.launches, int4_matvec.launches
    bf16 = Summarizer(str(d))
    assert bf16._gen.lm.dtype == torch.bfloat16
    got = bf16._gen.lm._generate_fused(bs, ids.cuda(), mask.cuda())
    assert (flash_attention.launches, int4_matvec.launches) == before
    ref = _normalized_score(lm_cpu, ids, mask, want, bs.length_penalty)
    ours = _normalized_score(lm_cpu, ids, mask, got, bs.length_penalty)
    assert ours >= ref - _TIE_BAND, (ours, ref)
    assert isinstance(bf16.summarize(text), str)


def test_whisper_transcribe_on_the_card_matches_the_cpu(encdec_dirs):
    """f32 on the card: the CPU's greedy ids and text, serial and batched;
    bf16 with the flash encoder (the default): every token within the tie
    band of the f32 CPU model's teacher-forced logits."""
    import numpy as np
    import chip_smoke
    from kjarni_tpu_torch.models import whisper as kwhisper
    from kjarni_tpu_torch.models import whisper_transcriber as wt
    d = encdec_dirs[1]
    audio = chip_smoke._speech(65.0, seed=10)
    cfg = wt.WhisperTranscriberConfig(max_tokens_per_chunk=24)
    cpu = wt.WhisperModel(d, device="cpu")
    card32 = wt.WhisperModel(d, dtype="f32")
    assert card32.device.type == "cuda" and not card32.use_flash
    for cb in (1, 16):
        c = wt.WhisperTranscriberConfig(max_tokens_per_chunk=24, chunk_batch=cb)
        assert card32.transcribe(audio, c)[0] == cpu.transcribe(audio, c)[0]
    bf16 = wt.WhisperModel(d)
    assert bf16.use_flash and bf16.dtype == torch.bfloat16
    chunk = bf16.chunk_audio(audio)[0]
    prompt = bf16.build_prompt_tokens(cfg)
    cache_len, max_steps, allow = bf16._plan(prompt, cfg)
    f0 = flash_attention.launches
    ck, cv = bf16._encode_chunk(wt.audio_pcm16(chunk))
    assert flash_attention.launches - f0 == _TINY_WHISPER["encoder_layers"]
    ids, _ = bf16._decode_loop(prompt, ck, cv, allow, cache_len, 0.0, None, max_steps)
    cck, ccv = cpu._encode_chunk(wt.audio_pcm16(chunk))
    seq = torch.tensor([prompt + ids[:-1]])
    sk, sv = cpu._new_cache(1, seq.shape[1])
    with torch.inference_mode():
        logits, _, _ = kwhisper.decode_step(cpu.params, cpu.config, seq, sk, sv, cck, ccv,
                                            None, 0)
    ref = torch.where(allow.cpu(), logits[0, len(prompt) - 1:], float("-inf"))
    margins = [float(r.max() - r[t]) for r, t in zip(ref, ids)]
    assert max(margins) <= _TIE_BAND, margins
    text, _ = bf16.transcribe(audio, cfg)
    assert isinstance(text, str) and np.isfinite(max(margins))


def test_vector_store_on_the_card_matches_numpy_f64(card):
    """The device branch at 20,000 x 384: top-10 ids and scores against an
    exact numpy f64 top-k (chip_smoke.topk_agrees: scores within 1e-5, ties
    closer than that as a set), and scores that do not move when TF32 is
    allowed for matmuls."""
    import numpy as np
    import chip_smoke
    from kjarni_tpu_torch.search import vector
    rng = np.random.default_rng(50)
    emb = rng.standard_normal((20_000, 384)).astype(np.float32)
    store = vector.VectorStore(emb)
    assert store.device.type == "cuda"
    queries = rng.standard_normal((8, 384)).astype(np.float32)
    for q in queries:
        res = store.search(q, 10)
        ok, why = chip_smoke.topk_agrees([i for i, _ in res], [s for _, s in res],
                                         chip_smoke.f64_scores(emb, q), 10)
        assert ok, why
    assert store._device_matrix.is_cuda
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32 = store._scores(queries[0])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert np.array_equal(tf32, store._scores(queries[0]))


def test_offload_ends_on_the_card_holds_the_tie_band(decoder_dir):
    """offload_ends on the card: the table and head in host memory, flash
    prefill, and every greedy token within the 0.5-logit tie band of a
    teacher-forced device-plan forward."""
    import chip_smoke
    from kjarni_tpu_torch import Generator
    d, prompts = decoder_dir
    dev = Generator(str(d))
    off = Generator(str(d), execution_plan="offload_ends")
    assert off.lm.params["embed"].device.type == "cpu" and off.lm.config.lm_head_on_host
    req = chip_smoke._plan_request(off, prompts[3], "offload_ends", _TINY_LLAMA[
        "num_hidden_layers"])
    assert chip_smoke._tie_band(dev.lm, req) <= chip_smoke.SERVE_TIE_BAND


def test_int4_checkpoint_loads_to_the_card_bit_equal(decoder_dir, tmp_path):
    import chip_smoke
    from kjarni_tpu_torch.models.decoder_lm import DecoderLM
    from kjarni_tpu_torch.weights.checkpoint import convert_model
    d, _ = decoder_dir
    out = convert_model(d, tmp_path / "ckpt", quantize="int4")
    got, want = DecoderLM(out), DecoderLM(d, quantize="int4")
    assert got.params["layers"]["q"]["w4"].is_cuda
    assert chip_smoke._same_tree(got.params, want.params)


def test_searcher_on_the_card_matches_the_cpu(encoder_dir, tmp_path):
    """Indexer and Searcher on the card against device="cpu": keyword
    results equal, the query embeddings within cosine 0.999, semantic top-k
    against numpy f64 with the card's own query vector; and an index reader
    over a 5,000-row segment (the device branch) equal to the CPU's."""
    import numpy as np
    import chip_smoke
    from kjarni_tpu_torch import Indexer, Searcher
    from kjarni_tpu_torch.rag.index import IndexConfig, IndexReader, IndexWriter
    d, texts = encoder_dir
    chip_smoke.write_corpus(tmp_path / "docs", 40, seed=7, chars=1500)
    Indexer(str(d), quiet=True).create(tmp_path / "idx", [tmp_path / "docs"])
    emb = np.load(tmp_path / "idx" / "segment_000000" / "embeddings.npy")
    card, cpu = Searcher(str(d), quiet=True), Searcher(str(d), device="cpu", quiet=True)
    for q in texts[:4]:
        kw = [(r.document_id, r.score) for r in card.search(tmp_path / "idx", q, "keyword")]
        assert kw == [(r.document_id, r.score) for r in cpu.search(tmp_path / "idx", q,
                                                                    "keyword")]
        qe, qc = card.embedder.embed(q), cpu.embedder.embed(q)
        assert float(qe @ qc / np.linalg.norm(qe) / np.linalg.norm(qc)) >= 0.999
        sem = card.search(tmp_path / "idx", q, "semantic")
        ok, why = chip_smoke.topk_agrees([r.document_id for r in sem], [r.score for r in sem],
                                         chip_smoke.f64_scores(emb, qe), 10)
        assert ok, why
    rng = np.random.default_rng(51)
    vecs = rng.standard_normal((5000, 128)).astype(np.float32)
    w = IndexWriter.open(tmp_path / "big", IndexConfig())
    w.add_batch([f"w{i}" for i in range(5000)], vecs, [{} for _ in range(5000)])
    w.commit()
    on_card, on_cpu = IndexReader.open(tmp_path / "big"), IndexReader.open(tmp_path / "big",
                                                                           "cpu")
    for q in rng.standard_normal((4, 128)).astype(np.float32):
        a, b = on_card.search_semantic(q, 10), on_cpu.search_semantic(q, 10)
        assert [r.document_id for r in a] == [r.document_id for r in b]
        assert max(abs(x.score - y.score) for x, y in zip(a, b)) <= 1e-5
    assert on_card.segments[0].store._device_matrix.is_cuda


def _f32_ids_agree(cpu_lm, prompt_ids, card_ids, cpu_ids):
    """f32 greedy ids on the card against the CPU's: equal, or parting only
    where the CPU's top-2 logits lie within 1e-4 (sums in another order)."""
    import chip_smoke
    n = chip_smoke._common_prefix(card_ids, cpu_ids)
    if n < min(len(card_ids), len(cpu_ids)):
        ids = list(prompt_ids) + list(cpu_ids[:n])
        top2 = torch.topk(chip_smoke.prefill_logits(cpu_lm, ids, device="cpu")[0], 2)
        assert (top2.values[0] - top2.values[1]).item() < 1e-4, (n, card_ids, cpu_ids)
    else:
        assert card_ids == cpu_ids


def test_generator_f32_on_the_card_matches_the_cpu(decoder_dir):
    """Generator(dtype="f32") on the card against the CPU's f32 greedy ids:
    equal, or parting only where the CPU's top-2 logits lie within 1e-4. The
    300- and 600-word prompts (buckets 512 and 1024) prefill through the f32
    flash kernel (one launch per layer), and no bf16 flash launches."""
    import chip_smoke
    from kjarni_tpu_torch import Generator
    from kjarni_tpu_torch.core.bucketing import seq_bucket
    d, prompts = decoder_dir
    card = Generator(str(d), dtype="f32")
    cpu = Generator(str(d), device="cpu")
    assert card.lm._cache_dtype == cpu.lm._cache_dtype == torch.float32
    for text in prompts[2:]:
        before = flash_attention.launches, flash_attention.launches_f32
        kw = dict(preset="greedy", max_new_tokens=8, max_length=2048)
        card.generate(text, **kw)
        cpu.generate(text, **kw)
        n_prompt = len(cpu.lm.encode_prompt(text))
        a, b = card.lm._session_ids[n_prompt:], cpu.lm._session_ids[n_prompt:]
        flash = (flash_attention.launches - before[0], flash_attention.launches_f32 - before[1])
        bucket = seq_bucket(n_prompt, card.lm.max_context)
        assert flash == (0, _TINY_LLAMA["num_hidden_layers"] if bucket >= 512 else 0)
        _f32_ids_agree(cpu.lm, cpu.lm._session_ids[:n_prompt], a, b)


def test_generate_batch_f32_on_the_card_matches_the_cpu(decoder_dir):
    """generate_batch in f32 on the card (the padded batch: no flash, the
    plain attention with the pad mask) gives the CPU's f32 texts."""
    from kjarni_tpu_torch import Generator
    d, prompts = decoder_dir
    card = Generator(str(d), dtype="f32")
    cpu = Generator(str(d), device="cpu")
    kw = dict(preset="greedy", max_new_tokens=8, max_length=2048)
    before = flash_attention.launches, flash_attention.launches_f32
    got = card.generate_batch(prompts, **kw)
    assert (flash_attention.launches, flash_attention.launches_f32) == before
    assert got == cpu.generate_batch(prompts, **kw) and all(got)


def test_continuous_engine_f32_on_the_card_matches_the_cpu(decoder_dir):
    """The ContinuousEngine in f32 on the card, every admission wave forced
    onto flash: the waves run the f32 kernel (one launch per layer of each
    wave, no bf16 launch), and every request's greedy ids equal those of the
    same engine on the CPU."""
    from kjarni_tpu_torch import Generator
    d, prompts = decoder_dir
    card = Generator(str(d), dtype="f32").lm
    cpu = Generator(str(d), device="cpu").lm
    before = flash_attention.launches, flash_attention.launches_f32
    run = _engine_run(card, prompts, None)
    waves = run["probe"].modes.get("flash", 0)
    assert set(run["probe"].modes) == {"flash"} and waves > 0
    assert (flash_attention.launches - before[0], flash_attention.launches_f32 - before[1]) \
        == (0, _TINY_LLAMA["num_hidden_layers"] * waves)
    ref = _engine_run(cpu, prompts, None)
    assert sorted(run["done"]) == sorted(ref["done"])
    for rid, fr in run["done"].items():
        ids, _ = run["meta"][rid]
        _f32_ids_agree(cpu, ids, fr.token_ids, ref["done"][rid].token_ids)


def test_speculative_f32_on_the_card_matches_the_cpu(decoder_dir):
    """A self-drafting SpeculativeGenerator in f32 on the card: the target's
    and the draft's prefills run the f32 kernel, and the emitted ids equal
    the same generator's on the CPU."""
    from kjarni_tpu_torch import Generator
    from kjarni_tpu_torch.generate.sampling import GenerationConfig
    from kjarni_tpu_torch.generate.speculative import SpeculativeGenerator
    d, prompts = decoder_dir
    cfg = GenerationConfig.greedy(max_new_tokens=24, max_length=2048)
    out = {}
    for where in ("cuda", "cpu"):
        lm = Generator(str(d), dtype="f32", device=where).lm
        ids = lm.encode_prompt(prompts[3])
        spec = SpeculativeGenerator(lm, lm, num_tokens=4)
        before = flash_attention.launches, flash_attention.launches_f32
        out[where] = [st.id for st in spec.generate_stream(token_ids=ids, config=cfg)]
        got = (flash_attention.launches - before[0], flash_attention.launches_f32 - before[1])
        assert got == ((0, 2 * _TINY_LLAMA["num_hidden_layers"]) if where == "cuda" else (0, 0))
    assert len(out["cuda"]) == 24
    _f32_ids_agree(lm, ids, out["cuda"], out["cpu"])


def test_offload_ends_f32_on_the_card_matches_the_cpu(decoder_dir):
    """offload_ends in f32 on the card (the table and head in host memory,
    f32 flash prefill): greedy ids equal the CPU's."""
    from kjarni_tpu_torch import Generator
    d, prompts = decoder_dir
    off = Generator(str(d), dtype="f32", execution_plan="offload_ends")
    cpu = Generator(str(d), device="cpu")
    assert off.lm.params["embed"].device.type == "cpu" and off.lm.config.lm_head_on_host
    assert off.lm.params["embed"].dtype == torch.float32
    kw = dict(preset="greedy", max_new_tokens=8, max_length=2048)
    before = flash_attention.launches_f32
    off.generate(prompts[3], **kw)
    cpu.generate(prompts[3], **kw)
    assert flash_attention.launches_f32 - before == _TINY_LLAMA["num_hidden_layers"]
    n_prompt = len(cpu.lm.encode_prompt(prompts[3]))
    _f32_ids_agree(cpu.lm, cpu.lm._session_ids[:n_prompt], off.lm._session_ids[n_prompt:],
                   cpu.lm._session_ids[n_prompt:])


@pytest.mark.parametrize("quantize", [None, "int4"])
def test_f32_checkpoint_loads_to_the_card_bit_equal(decoder_dir, tmp_path, quantize):
    """convert_model in f32 (plain and int4) on the card: the checkpoint
    loads as f32, bit-equal to the model dir's f32 params."""
    import chip_smoke
    from kjarni_tpu_torch.models.decoder_lm import DecoderLM
    from kjarni_tpu_torch.weights.checkpoint import convert_model
    d, _ = decoder_dir
    out = convert_model(d, tmp_path / "ckpt", dtype="f32", quantize=quantize)
    got, want = DecoderLM(out), DecoderLM(d, dtype="f32", quantize=quantize)
    assert got._cache_dtype == torch.float32 and got.params["embed"].is_cuda
    assert chip_smoke._same_tree(got.params, want.params)


def test_chat_f32_on_the_card(decoder_dir):
    """Chat(dtype="f32") on the card: f32 weights, and a 600-word turn
    prefills through the f32 flash kernel (one launch per layer) and no bf16
    one; the reply joins the history. (Greedy ids against the CPU's are the
    Generator test's: the same DecoderLM.)"""
    from kjarni_tpu_torch import Chat
    d, prompts = decoder_dir
    chat = Chat(str(d), dtype="f32")
    assert chat._lm.params["embed"].dtype == torch.float32
    before = flash_attention.launches, flash_attention.launches_f32
    reply = chat.send(prompts[3], preset="greedy", max_new_tokens=8, max_length=2048)
    assert (flash_attention.launches - before[0], flash_attention.launches_f32 - before[1]) \
        == (0, _TINY_LLAMA["num_hidden_layers"])
    assert chat.conversation.messages[-1].content == reply


def test_cli_generate_on_the_card_matches_the_generator(decoder_dir, tmp_path, monkeypatch,
                                                        capsys):
    """The port's CLI in this process, on the card (no --device), under a
    kjarni.toml asking for int4: its text equals Generator's with the same
    options, and int4 launches."""
    from kjarni_tpu_torch import Generator
    from kjarni_tpu_torch.cli.main import main
    from kjarni_tpu_torch.tasks.generator import resolve_generation_config
    d, prompts = decoder_dir
    monkeypatch.delenv("KJARNI_CONFIG", raising=False)
    (tmp_path / "kjarni.toml").write_text(f'[models."{d}"]\nquantize = "int4"\n')
    monkeypatch.chdir(tmp_path)
    before = int4_matvec.launches
    assert main(["generate", prompts[0], "--model", str(d), "--max-tokens", "8",
                 "--preset", "greedy", "--format", "json"]) == 0
    got = json.loads(capsys.readouterr().out)["text"]
    assert int4_matvec.launches > before
    cfg = resolve_generation_config("greedy", None, max_new_tokens=8)
    want = Generator(str(d), quantize="int4").generate(prompts[0], config=cfg)
    assert got == want and got
