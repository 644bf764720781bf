"""The f32 flash kernel's 3xTF32 split, emulated on the CPU.

csrc/flash_attention_f32.cu runs both products of attention on the tensor
cores in TF32: each f32 operand x is split as big = tf32_rna(x) and
small = tf32_rna(x - big), and a product is summed in f32 as
small*big + big*small + big*big. The CPU tests have no card, so this
emulates the split with bit arithmetic, puts it in the plain flash's two
products, and holds the result to the JAX package's flash_attention (Pallas in
interpret mode) within the f32 bound of tests/test_torch_kernels.py (atol
2e-5). The same products in TF32 alone (big*big) must fall outside it: the
small terms are what the accuracy rests on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kjarni_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from kjarni_tpu_torch.ops.kernels.flash_attention import flash_attention_plain

from test_torch_kernels import FLASH_CASES, rand, to_torch

ATOL = 2e-5
# D = 128 beside FLASH_CASES (D = 32, 64 and 96): the kernel's fourth head dim
CASES = {**FLASH_CASES,
         "causal_d128_gqa": (1, 4, 2, 128, 128, 128, True, None, None, None, None, None)}


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from zero,
    as cvt.rna.tf32.f32: add half of the 13 dropped bits to the magnitude and
    clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel sums it: the small terms first, all in f32."""
    a_big, a_small = split(a.float())
    b_big, b_small = split(b.float())
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The TF32-only control: big * big alone."""
    return tf32_rna(a.float()) @ tf32_rna(b.float())


def _inputs(name):
    B, H, Hkv, S, T, D, causal, window, off, kv_len, bq, bk = CASES[name]
    seed = sorted(CASES).index(name) * 3 + 101
    q, k, v = rand(B, H, S, D, seed=seed), rand(B, Hkv, T, D, seed=seed + 1), \
        rand(B, Hkv, T, D, seed=seed + 2)
    jkw = dict(causal=causal, window=window, block_q=bq, block_k=bk, interpret=True)
    if off is not None:
        jkw.update(q_offset=jnp.int32(off), kv_len=jnp.int32(kv_len))
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw))
    kw = dict(causal=causal, window=window, q_offset=off or 0, kv_len=kv_len)
    return (to_torch(q), to_torch(k), to_torch(v)), kw, ref


def _plain_with(matmul, monkeypatch, qkv, kw) -> np.ndarray:
    """The plain flash with its two products (Q K^T and P V) taken by `matmul`."""
    with monkeypatch.context() as m:
        m.setattr(torch, "matmul", matmul)
        return flash_attention_plain(*qkv, **kw).numpy()


def test_split_is_exact_to_2_pow_minus_22():
    x = to_torch(rand(4096, seed=7)) * torch.logspace(-20, 20, 4096)
    big, small = split(x)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((small.view(torch.int32) & 0x1FFF) == 0).all()
    # x - big is exact in f32; what the small term's rounding drops is
    # under 2^-22 of |x|
    assert torch.equal((x - big) + big, x)
    assert ((big + small - x).abs() <= 2.0 ** -22 * x.abs()).all()
    assert ((big - x).abs() <= 2.0 ** -11 * x.abs()).all()


def test_tf32_rna_rounds_ties_away_from_zero():
    one = torch.tensor([1.0, -1.0])
    half_ulp = one + one.sign() * 2.0 ** -11      # exactly between two TF32 values
    assert torch.equal(tf32_rna(half_ulp), one + one.sign() * 2.0 ** -10)
    assert torch.equal(tf32_rna(one + one.sign() * 2.0 ** -12), one)


def test_3xtf32_product_is_f32_close():
    a, b = to_torch(rand(64, 256, seed=8)), to_torch(rand(256, 64, seed=9))
    exact = (a.double() @ b.double())
    scale = (a.abs().double() @ b.abs().double())
    assert ((matmul_3xtf32(a, b).double() - exact).abs() <= 2e-6 * scale).all()
    assert ((matmul_tf32(a, b).double() - exact).abs() > 2e-5 * scale).any()


@pytest.mark.parametrize("name", list(CASES))
def test_3xtf32_flash_matches_jax(name, monkeypatch):
    qkv, kw, ref = _inputs(name)
    got = _plain_with(matmul_3xtf32, monkeypatch, qkv, kw)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("name", ["full", "causal_d128_gqa", "causal_d96"])
def test_tf32_only_flash_falls_outside(name, monkeypatch):
    """D = 64, 128 and 96: one TF32 product each misses the f32 bound."""
    qkv, kw, ref = _inputs(name)
    assert np.abs(_plain_with(matmul_3xtf32, monkeypatch, qkv, kw) - ref).max() <= ATOL
    assert np.abs(_plain_with(matmul_tf32, monkeypatch, qkv, kw) - ref).max() > ATOL
