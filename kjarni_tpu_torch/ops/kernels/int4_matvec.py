"""int4 matvec: a hand-written Hopper kernel and its plain PyTorch version.

Replaces kjarni_tpu/ops/pallas/int4_matvec.py::int4_matvec. In the port it is
the "w4" branch of models/llama.py::_mm, for decode (M = 1) and prefill
(M = bucket) alike. The CUDA source is csrc/int4_matvec.cu; its header says
what bounds it on the H100 (the packed weight bytes at decode) and what the
design does about that.

`int4_matvec` launches the kernel for CUDA tensors and raises on what the
kernel does not take; it runs the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_BN, _BM, _BKP = 128, 16, 64   # the kernel's column, row and K-stage tiles
_TARGET_BLOCKS = 2 * 132       # two blocks per H100 SM


def unpack_int4(w4: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[K/2, N] int8 -> (low, high) nibbles, sign-extended, as int16 in [-8, 7].
    HALF-SPLIT layout: low holds rows 0..K/2, high rows K/2..K."""
    w = w4.to(torch.int16)
    return ((w & 0xF) ^ 8) - 8, w >> 4


def int4_matvec_plain(x: torch.Tensor, w4: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """The same function in plain torch ops, computed in x's dtype with the
    products accumulated in f32 (models/llama.py::_mm's w4 branch in the JAX
    package): x [M, K], w4 [K/2, N], scale [G, N] -> [M, N]."""
    K2, N = w4.shape
    G = scale.shape[0]
    lo, hi = (t.to(x.dtype) for t in unpack_int4(w4))
    s = scale.to(x.dtype)
    if G == 1:
        w_lo, w_hi = lo * s[0], hi * s[0]
    else:
        g, G2 = (2 * K2) // G, G // 2
        w_lo = (lo.reshape(G2, g, N) * s[:G2, None, :]).reshape(K2, N)
        w_hi = (hi.reshape(G2, g, N) * s[G2:, None, :]).reshape(K2, N)
    return x[..., :K2] @ w_lo + x[..., K2:] @ w_hi


def split_plan(M: int, K: int, N: int) -> tuple[int, int]:
    """(splits, packed rows per split): split K across blocks until the grid
    has about two blocks per SM. Splits start on stage boundaries."""
    K2 = K // 2
    blocks = -(-N // _BN) * -(-M // _BM)
    stages = -(-K2 // _BKP)
    want = max(1, min(-(-_TARGET_BLOCKS // blocks), stages))
    rows = -(-stages // want) * _BKP
    return -(-K2 // rows), rows


def int4_matvec(x: torch.Tensor, w4: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ half-split packed w4 [K/2, N] with scales [G, N] -> [M, N].

    G is 1 (one scale per column) or even; on the card each group of
    g = K/G rows is a multiple of 16 and K/2 is too when G > 1.
    """
    if x.device.type == "cpu":
        return int4_matvec_plain(x, w4, scale)
    M, K = x.shape
    K2, N = w4.shape
    G = scale.shape[0]
    if x.device.type != "cuda" or w4.device != x.device or scale.device != x.device:
        raise ValueError(f"int4_matvec: tensors on {x.device}/{w4.device}/"
                         f"{scale.device}; the kernel takes one CUDA device")
    if x.dtype != torch.bfloat16 or w4.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError(f"int4_matvec kernel takes bf16 x, int8 w4, f32 scale; "
                        f"got {x.dtype}, {w4.dtype}, {scale.dtype}")
    g = K // G if G else 0
    if 2 * K2 != K or scale.shape[1] != N or G < 1 or g * G != K or \
            (G > 1 and (G % 2 or g % 16 or K2 % 16)):
        raise ValueError(f"int4_matvec: unsupported shapes x {tuple(x.shape)} "
                         f"w4 {tuple(w4.shape)} scale {tuple(scale.shape)}")
    if not (w4.is_contiguous() and scale.is_contiguous()):
        # a copy here would move the whole weight on every call
        raise ValueError("int4_matvec: w4 and scale must be contiguous")
    x = x.contiguous()
    y = torch.empty(M, N, dtype=x.dtype, device=x.device)
    splits, rows = split_plan(M, K, N)
    partial = (torch.empty(splits, M, N, dtype=torch.float32, device=x.device)
               if splits > 1 else y)
    lib = build.load("int4_matvec")
    fn = lib.kj_int4_matvec_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), w4.data_ptr(), scale.data_ptr(), partial.data_ptr(),
             y.data_ptr(), M, K, N, G, splits, rows,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "int4_matvec")
    int4_matvec.launches += 1
    return y


int4_matvec.launches = 0
