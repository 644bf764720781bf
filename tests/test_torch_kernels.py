"""kjarni_tpu_torch's kernel modules against the JAX package, on the CPU.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX side
runs the Pallas kernels in interpret mode. Inputs come from a numpy seed and
go through both. Tolerances: flash atol 2e-5 in f32 and 3e-2 in bf16 (the
JAX package's own flash tests); int4 rtol/atol 2e-2 and cosine > 0.9995
(0.999 for bf16 inputs), as tests/test_int4_matvec.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kjarni_tpu.models.llama import _mm as jax_mm
from kjarni_tpu.models.llama import pack_int4 as jax_pack_int4
from kjarni_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from kjarni_tpu.ops.pallas.int4_matvec import int4_matvec as jax_int4_matvec
from kjarni_tpu_torch.models.llama import pack_int4
from kjarni_tpu_torch.ops.kernels.flash_attention import (HEAD_DIMS, check_shapes,
                                                          flash_attention)
from kjarni_tpu_torch.ops.kernels.int4_matvec import int4_matvec, launch_plan, wgmma_takes


def rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def to_torch(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# every case of tests/test_flash_attention.py:
# (B, H, Hkv, S, T, D, causal, window, q_offset, kv_len, block_q, block_k)
FLASH_CASES = {
    "full": (1, 2, 2, 128, 128, 64, False, None, None, None, None, None),
    "causal": (1, 2, 2, 128, 128, 32, True, None, None, None, None, None),
    "multi_block_kv": (1, 1, 1, 128, 384, 32, False, None, None, None, None, 128),
    "unaligned": (1, 1, 1, 100, 200, 32, False, None, None, None, 64, 64),
    "gqa": (1, 4, 2, 64, 64, 32, False, None, None, None, 64, 64),
    "window": (1, 2, 2, 256, 256, 32, True, 64, None, None, 64, 64),
    "offset": (1, 2, 2, 128, 384, 32, True, None, 200, 328, 64, 64),
    "offset_zero": (1, 2, 2, 128, 128, 32, True, None, 0, 128, None, None),
    "offset_window": (1, 1, 1, 128, 256, 32, True, 48, 100, 228, 64, 64),
    "autotuned_gqa_offset": (1, 4, 2, 256, 640, 32, True, None, 384, 640, None, None),
    # Phi-3's head width (hidden 3072 / 32 heads), ragged S
    "causal_d96": (1, 2, 2, 100, 100, 96, True, None, None, None, None, None),
    # the zoo's GQA groups: G = 7 (Qwen2.5-0.5B, 14 / 2 heads, D 64), 6
    # (Qwen2.5-1.5B, 12 / 2, D 128) and 3 (Llama-3.2-3B, 24 / 8, D 128), causal
    # over a ragged S, and resuming a cache at q_offset over kv_len
    "zoo_g7_ragged": (1, 14, 2, 70, 70, 64, True, None, None, None, None, None),
    "zoo_g7_offset": (1, 7, 1, 70, 192, 64, True, None, 110, 180, 64, 64),
    "zoo_g6_ragged": (1, 12, 2, 70, 70, 128, True, None, None, None, None, None),
    "zoo_g6_offset": (1, 6, 1, 70, 192, 128, True, None, 100, 170, 64, 64),
    "zoo_g3_ragged": (1, 6, 2, 70, 70, 128, True, None, None, None, None, None),
    "zoo_g3_offset": (1, 3, 1, 50, 192, 128, True, None, 120, 170, 64, 64),
}


class TestFlashPlainVsJax:
    @pytest.mark.parametrize("name", list(FLASH_CASES))
    def test_f32_matches(self, name):
        B, H, Hkv, S, T, D, causal, window, off, kv_len, bq, bk = FLASH_CASES[name]
        seed = sorted(FLASH_CASES).index(name) * 3
        q, k, v = rand(B, H, S, D, seed=seed), rand(B, Hkv, T, D, seed=seed + 1), \
            rand(B, Hkv, T, D, seed=seed + 2)
        jkw = dict(causal=causal, window=window, block_q=bq, block_k=bk,
                   interpret=True)
        if off is not None:
            jkw.update(q_offset=jnp.int32(off), kv_len=jnp.int32(kv_len))
        ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw)
        got = flash_attention(to_torch(q), to_torch(k), to_torch(v), causal=causal,
                              window=window, q_offset=off or 0, kv_len=kv_len)
        assert got.dtype == torch.float32 and got.shape == (B, H, S, D)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)

    def test_bf16_matches(self):
        q, k, v = (rand(1, 1, 64, 32, seed=s) for s in (16, 17, 18))
        ref = jax_flash(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
                        block_q=64, block_k=64, interpret=True)
        got = flash_attention(*(to_torch(a, torch.bfloat16) for a in (q, k, v)))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, dtype=np.float32), atol=3e-2)

    def test_garbage_tail_ignored(self):
        S, T, off = 64, 256, 64
        q = to_torch(rand(1, 1, S, 32, seed=33))
        k, v = rand(1, 1, T, 32, seed=34), rand(1, 1, T, 32, seed=35)
        kv_len = off + S
        clean = flash_attention(q, to_torch(k), to_torch(v), causal=True,
                                q_offset=off, kv_len=kv_len)
        k[:, :, kv_len:], v[:, :, kv_len:] = 1e3, -1e3
        dirty = flash_attention(q, to_torch(k), to_torch(v), causal=True,
                                q_offset=off, kv_len=kv_len)
        np.testing.assert_allclose(dirty.numpy(), clean.numpy(), atol=1e-6)

    def test_cpu_runs_plain_without_counting(self):
        before = flash_attention.launches
        flash_attention(*(to_torch(rand(1, 2, 16, 32, seed=s)) for s in (1, 2, 3)))
        assert flash_attention.launches == before

    def test_other_devices_raise(self):
        q = torch.empty(1, 2, 16, 32, device="meta")
        with pytest.raises(ValueError):
            flash_attention(q, q, q)


class TestFlashShapes:
    """The kernel's shape rules, checked without a card (meta tensors)."""

    @pytest.mark.parametrize("D", [32, 64, 96, 128])
    def test_head_dims_accepted(self, D):
        assert D in HEAD_DIMS
        q = torch.empty(1, 32, 1024, D, device="meta", dtype=torch.bfloat16)
        kv = torch.empty(1, 8, 1024, D, device="meta", dtype=torch.bfloat16)
        check_shapes(q, kv, kv)

    @pytest.mark.parametrize("D", [80, 256])
    def test_head_dims_refused(self, D):
        q = torch.empty(1, 4, 64, D, device="meta", dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            check_shapes(q, q, q)

    @pytest.mark.parametrize("q_shape,k_shape,v_shape", [
        ((1, 6, 64, 64), (1, 4, 64, 64), (1, 4, 64, 64)),    # Hkv does not divide H
        ((1, 4, 64, 64), (1, 2, 64, 64), (1, 2, 32, 64)),    # k and v differ
        ((2, 4, 64, 64), (1, 2, 64, 64), (1, 2, 64, 64)),    # batch differs
        ((1, 4, 64, 64), (1, 2, 64, 32), (1, 2, 64, 32)),    # D differs
        ((1, 8, 9_000_000, 64), (1, 1, 64, 64), (1, 1, 64, 64)),  # grid too tall
    ])
    def test_mismatched_shapes_refused(self, q_shape, k_shape, v_shape):
        q, k, v = (torch.empty(s, device="meta") for s in (q_shape, k_shape, v_shape))
        with pytest.raises(ValueError):
            check_shapes(q, k, v)


def make_int4_case(B, K, N, g, seed=0):
    """(x, w4, scale, dequantized reference product), as test_int4_matvec.py."""
    rng = np.random.default_rng(seed)
    w32 = rng.standard_normal((K, N)).astype(np.float32) * 0.1
    G = K // g
    wg = w32.reshape(G, g, N)
    scale = (np.abs(wg).max(axis=1) / 7.0).astype(np.float32)
    q = np.clip(np.round(wg / scale[:, None, :]), -8, 7).reshape(K, N).astype(np.int8)
    x = rng.standard_normal((B, K)).astype(np.float32)
    deq = (q.astype(np.float32).reshape(G, g, N) * scale[:, None, :]).reshape(K, N)
    return x, jax_pack_int4(q), scale, q, x @ deq


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float32), np.ravel(b).astype(np.float32)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))


class TestInt4PlainVsJax:
    @pytest.mark.parametrize("B,K,N,g", [(1, 256, 512, 64), (4, 512, 512, 128),
                                         (8, 256, 1024, 64), (2, 256, 384, 64),
                                         (5, 512, 1000, 128), (2, 512, 1000, 128)])
    def test_matches_kernel_and_mm(self, B, K, N, g):
        x, w4, scale, _, ref = make_int4_case(B, K, N, g, seed=K + N + B)
        got = int4_matvec(to_torch(x), torch.from_numpy(w4), to_torch(scale)).numpy()
        assert got.shape == (B, N)
        jk = np.asarray(jax_int4_matvec(jnp.asarray(x), jnp.asarray(w4),
                                        jnp.asarray(scale), block_n=256,
                                        interpret=True))
        np.testing.assert_allclose(got, jk, rtol=2e-2, atol=2e-2)
        assert _cos(got, jk) > 0.9995
        np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)
        # in f32 the plain version is _mm's w4 branch
        mm = np.asarray(jax_mm(jnp.asarray(x), {"w4": jnp.asarray(w4),
                                                "scale": jnp.asarray(scale)}))
        np.testing.assert_allclose(got, mm, rtol=1e-5, atol=1e-5)

    def test_bf16_inputs(self):
        x, w4, scale, _, ref = make_int4_case(1, 256, 512, 128, seed=5)
        got = int4_matvec(to_torch(x, torch.bfloat16), torch.from_numpy(w4),
                          to_torch(scale))
        assert got.dtype == torch.bfloat16
        jk = jax_int4_matvec(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w4),
                             jnp.asarray(scale), block_n=512, interpret=True)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(jk, np.float32),
                                   rtol=2e-2, atol=2e-2)
        assert _cos(got.float().numpy(), ref) > 0.999

    # and Qwen2.5-1.5B's down projection, K = 8,960 (70 groups of 128), where
    # the bf16 rounding of x alone moves outputs of ~10 by ~0.04: past the
    # f32-x comparison's atol, so the kernel's form is the one held there
    @pytest.mark.parametrize("B,K,N,g", [(1, 256, 512, 64), (5, 512, 1000, 128),
                                         (1, 8960, 256, 128), (3, 8960, 512, 128)])
    def test_x_as_bf16_matches_the_pallas_kernel(self, B, K, N, g):
        """The kernel's form for f32 activations: the Pallas kernel rounds an
        f32 x to bf16, accumulates in f32 and writes f32; the plain version
        with x_as_bf16 computes the same, and the plain default does not
        round x."""
        from kjarni_tpu_torch.ops.kernels.int4_matvec import int4_matvec_plain
        x, w4, scale, _, ref = make_int4_case(B, K, N, g, seed=K + N + B + 1)
        got = int4_matvec_plain(to_torch(x), torch.from_numpy(w4), to_torch(scale),
                                x_as_bf16=True)
        assert got.dtype == torch.float32
        jk = np.asarray(jax_int4_matvec(jnp.asarray(x), jnp.asarray(w4),
                                        jnp.asarray(scale), block_n=256,
                                        interpret=True))
        assert jk.dtype == np.float32
        np.testing.assert_allclose(got.numpy(), jk, rtol=1e-5, atol=1e-5)
        assert _cos(got.numpy(), ref) > 0.999
        plain = int4_matvec_plain(to_torch(x), torch.from_numpy(w4), to_torch(scale))
        assert not torch.equal(plain, got)

    @pytest.mark.parametrize("B,K,N", [(1, 896, 896), (3, 896, 4864), (1, 896, 2000)])
    def test_single_group_at_qwen_width(self, B, K, N):
        """Qwen2.5-0.5B's K = 896 is no multiple of 256: quantize_params_int4
        takes one scale per column (G = 1). The Pallas kernel takes even G
        alone, so the JAX package runs G = 1 through _mm's w4 branch; the
        plain version equals it."""
        x, w4, scale, _, ref = make_int4_case(B, K, N, K, seed=K + N + B)
        assert scale.shape == (1, N)
        got = int4_matvec(to_torch(x), torch.from_numpy(w4), to_torch(scale)).numpy()
        mm = np.asarray(jax_mm(jnp.asarray(x), {"w4": jnp.asarray(w4),
                                                "scale": jnp.asarray(scale)}))
        np.testing.assert_allclose(got, mm, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)
        assert _cos(got, ref) > 0.9995

    def test_single_group_matches_mm(self):
        # K % 256 != 0: quantize_params_int4 falls back to one scale per column
        x, w4, scale, _, ref = make_int4_case(3, 192, 200, 192, seed=7)
        assert scale.shape == (1, 200)
        got = int4_matvec(to_torch(x), torch.from_numpy(w4), to_torch(scale)).numpy()
        mm = np.asarray(jax_mm(jnp.asarray(x), {"w4": jnp.asarray(w4),
                                                "scale": jnp.asarray(scale)}))
        np.testing.assert_allclose(got, mm, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)

    def test_pack_matches_jax(self):
        q = np.random.default_rng(3).integers(-8, 8, (2, 64, 48)).astype(np.int8)
        np.testing.assert_array_equal(pack_int4(torch.from_numpy(q)).numpy(),
                                      jax_pack_int4(q))

    def test_cpu_runs_plain_without_counting(self):
        x, w4, scale, _, _ = make_int4_case(1, 256, 128, 64)
        before = int4_matvec.launches, dict(int4_matvec.launches_by_path)
        int4_matvec(to_torch(x), torch.from_numpy(w4), to_torch(scale))
        assert (int4_matvec.launches, int4_matvec.launches_by_path) == before
        assert set(int4_matvec.launches_by_path) == {"gemv", "gemm", "wgmma"}

    @pytest.mark.parametrize("M,K,N", [
        (1, 2048, 2048), (1, 8192, 2048), (1, 2048, 128256), (1024, 2048, 8192),
        (3, 192, 200), (1, 2048, 512), (4, 2048, 8192), (5, 2048, 8192),
        (4, 65536, 1000), (2, 2048, 8192), (8, 2048, 512), (32, 2048, 2048),
        (128, 8192, 2048), (700, 4096, 1000), (1024, 2048, 512), (64, 192, 200)])
    def test_launch_plan_covers_k(self, M, K, N):
        G = K // 128 if K % 256 == 0 else 1
        plan = launch_plan(M, K, N, G)
        # each M goes to exactly one path: the GEMV takes M == 1 alone
        assert plan.path == "gemv" if M == 1 else plan.path in ("gemm", "wgmma")
        if plan.path == "wgmma":
            # fixed tiles, K whole: the kernel walks every stage of every tile
            assert (plan.col_threads, plan.rows_per_lane, plan.splits) == (0, 0, 1)
            assert plan.row_tile == 128 and wgmma_takes(M, K, N, G)
            return
        if plan.path == "gemm":
            assert plan.col_threads == plan.rows_per_lane == 0
            # a row tile the kernel has; a short prompt takes the smallest
            assert plan.row_tile in (32, 64, 128)
            assert M > 32 or plan.row_tile == 32
            # split z takes 64-row stages [z * per, (z + 1) * per): together
            # they cover K/2 exactly once, and none is empty
            stages = -(-(K // 2) // 64)
            per = -(-stages // plan.splits)
            covered = [st for z in range(plan.splits)
                       for st in range(z * per, min(stages, (z + 1) * per))]
            assert covered == list(range(stages))
            assert all(z * per < stages for z in range(plan.splits))
            assert 1 <= plan.splits <= 16
            # K is split only where the output tiles leave SMs of the H100 idle
            tiles = -(-N // 128) * -(-M // plan.row_tile)
            assert plan.splits == 1 or tiles < 132
            return
        # lane l walks packed rows [l * rows, (l + 1) * rows): the block's
        # lanes cover K/2 exactly once, in whole 8-row steps, with no lane
        # taking a step more than it needs; its columns tile N
        assert plan.row_tile == plan.splits == 0
        lanes = 256 // plan.col_threads
        rows = plan.rows_per_lane
        assert plan.col_threads in (2, 4, 8, 16, 32) and rows % 8 == 0
        assert (rows - 8) * lanes < K // 2 <= rows * lanes
        # at least one block per SM of the H100 where N allows
        assert -(-N // (8 * plan.col_threads)) >= min(132, -(-N // 16))


# Mistral-7B's projections (K, N): q and o, k and v, gate and up, down
_MISTRAL = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


@pytest.mark.parametrize("M,K,N,G,path", [
    # the single stream's prefill at every bucket of its prompts, and
    # admission waves of lanes x bucket
    *[(M, K, N, K // 128, "wgmma") for M in (1024, 2048, 4096, 8192, 4 * 1024, 3 * 2048)
      for K, N in _MISTRAL],
    # a Qwen width with one scale per column, and a tp shard
    (1024, 896, 4864, 1, "wgmma"), (8192, 2048, 512, 16, "wgmma"),
    # the engine's decode step over 40 slots, speculative verification
    *[(40, K, N, K // 128, "gemm") for K, N in _MISTRAL],
    (5, 4096, 4096, 32, "gemm"),
    # groups of 32 and 64 rows end inside the kernel's two-stage units; N not
    # a multiple of 16
    (8192, 4096, 4096, 128, "gemm"), (8192, 4096, 4096, 64, "gemm"),
    (8192, 4096, 1000, 32, "gemm"),
    # decode
    *[(1, K, N, K // 128, "gemv") for K, N in _MISTRAL],
])
def test_launch_plan_picks_the_path(M, K, N, G, path):
    """Which kernel each call takes, by shape alone: the wgmma GEMM at the
    prefill and admission shapes, the mma.sync GEMM at small M and at
    shapes TMA or its stages do not take, the GEMV at M = 1."""
    assert launch_plan(M, K, N, G).path == path


def test_bf16_cast_matches_ml_dtypes():
    """Weights cross between the packages as f32: torch's bf16 rounding is
    ml_dtypes' (round to nearest even)."""
    a = rand(4096, seed=11) * 3
    np.testing.assert_array_equal(
        torch.from_numpy(a).to(torch.bfloat16).float().numpy(),
        a.astype(ml_dtypes.bfloat16).astype(np.float32))
