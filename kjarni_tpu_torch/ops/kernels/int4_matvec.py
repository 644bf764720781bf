"""int4 matvec: a hand-written Hopper kernel and its plain PyTorch version.

Replaces kjarni_tpu/ops/pallas/int4_matvec.py::int4_matvec. In the port it is
the "w4" branch of models/llama.py::_mm, for decode (M = 1) and prefill
(M = bucket) alike. `launch_plan` picks the kernel by shape: a GEMV that
streams the packed bytes for decode (M == 1); for M >= 128, where TMA takes
the shape, a TMA-fed, warp-specialised wgmma GEMM ("wgmma") wherever the
plan's model times it faster; else the mma.sync GEMM ("gemm"), with a row
tile and a split of K sized to the grid. The CUDA source is
csrc/int4_matvec.cu; its header says what bounds each path on the H100 and
what the design does about it. `int4_matvec.launches` counts launches and
`int4_matvec.launches_by_path` counts them by path.

`int4_matvec` launches the kernel for CUDA tensors and raises on what the
kernel does not take; it runs the plain version only for tensors on the CPU.
As the Pallas kernel, it takes x in bf16 or f32 and answers in x's dtype: an
f32 x is rounded to bf16 (the Pallas body's first step) and the kernel
writes its f32 sums as f32. The decode GEMV rounds an f32 x itself where it
loads it (one launch, no M x K temporary); the GEMM takes x cast to bf16 by
the wrapper.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build

_GEMV_THREADS = 256     # a GEMV block: col_threads across its columns x the rest down K
_GEMV_COLS = 8          # columns (packed bytes) per GEMV thread
_GEMV_STEP = 8          # packed rows per GEMV step
_GEMM_COLS = 128        # output columns per GEMM block
_GEMM_STAGE = 64        # packed rows per GEMM stage
_GEMM_MAX_SPLITS = 16
# the plan's cost model, fitted to chip_smoke.py's int4 lines on an H100 SXM
# (M = 1 to 1024): microseconds per 64-row stage of a block by its row tile,
# and the rate at which one block sums split partials from L2
_GEMM_STAGE_US = {32: 1.3, 64: 2.0, 128: 3.5}
_SUM_BYTES_PER_US = 60e3
_SMS = 132              # H100 SXM
# the TMA / wgmma GEMM ("wgmma"): 128-column by 128-row output tiles, 64 packed
# rows a stage, one persistent block per SM; its time per stage of a tile and
# the least M it takes (launch_plan says where they come from)
_WGMMA_COLS = 128
_WGMMA_ROWS = 128
_WGMMA_STAGE_US = 1.0
_WGMMA_MIN_M = 128
_PATHS = {"gemv": 0, "gemm": 1, "wgmma": 2}     # the C entry points' `path`
# (x's dtype as the kernel reads it, y's dtype) -> the C entry point; the
# GEMM reads bf16 x only
_ENTRIES = {(torch.bfloat16, torch.bfloat16): "kj_int4_matvec_bf16",
            (torch.bfloat16, torch.float32): "kj_int4_matvec_bf16_f32",
            (torch.float32, torch.float32): "kj_int4_matvec_f32"}
_X_DTYPES = (torch.bfloat16, torch.float32)


class Plan(NamedTuple):
    """How one call launches: `path` "gemv", "gemm" or "wgmma". For the GEMV,
    the threads across each block's 8 * col_threads columns and the packed
    rows each of the block's other threads walks down K (the block covers all
    of K). For the GEMM, the x rows per block and the blocks that split K for
    each output tile. The wgmma GEMM's tiles are fixed (128 x rows, splits 1)."""
    path: str
    col_threads: int = 0
    rows_per_lane: int = 0
    row_tile: int = 0
    splits: int = 0


def gemm_plan(M: int, K: int, N: int) -> Plan:
    """The mma.sync GEMM's grid (`_gemm_best`)."""
    return _gemm_best(M, K, N)[1]


@functools.lru_cache(maxsize=256)
def _gemm_best(M: int, K: int, N: int) -> tuple[float, Plan]:
    """The GEMM's grid: the row tile (32, 64 or 128 rows of x) and the split
    of K's 64-row stages across blocks, chosen together as the cheapest by a
    model fitted to the H100 (one block per SM): waves x stages per split x
    the row tile's time per stage, plus, where K is split, the last block's
    read of every split's f32 partial. K is split only where the output
    tiles leave SMs idle; on a tie, the fewer splits. No split is left
    empty. Cached: a forward calls it once per projection."""
    stages = max(1, -(-(K // 2) // _GEMM_STAGE))
    best = None
    for row_tile, stage_us in _GEMM_STAGE_US.items():
        tiles = -(-N // _GEMM_COLS) * -(-M // row_tile)
        most = 1 if tiles >= _SMS else min(_GEMM_MAX_SPLITS, stages)
        for s in range(1, most + 1):
            per = -(-stages // s)
            splits = -(-stages // per)
            us = -(-tiles * splits // _SMS) * per * stage_us
            if splits > 1:
                us += splits * min(M, row_tile) * _GEMM_COLS * 4 / _SUM_BYTES_PER_US
            if best is None or (us, splits) < best[:2]:
                best = (us, splits, row_tile)
    return best[0], Plan("gemm", row_tile=best[2], splits=best[1])


def wgmma_us(M: int, K: int, N: int) -> float:
    """The wgmma GEMM's time by the same model: the persistent blocks' turns
    over the output tiles x stages a tile x the time of a stage."""
    tiles = -(-N // _WGMMA_COLS) * -(-M // _WGMMA_ROWS)
    return -(-tiles // _SMS) * -(-(K // 2) // _GEMM_STAGE) * _WGMMA_STAGE_US


def wgmma_takes(M: int, K: int, N: int, G: int) -> bool:
    """Shapes the wgmma GEMM takes: M at or above _WGMMA_MIN_M, 16-byte rows
    of x, w4 and the scales for TMA (K and N multiples of 16), and groups
    that end only between pairs of 64-row stages (G == 1, or g % 128 == 0)."""
    return (M >= _WGMMA_MIN_M and K % 16 == 0 and N % 16 == 0
            and (G == 1 or (K // G) % (2 * _GEMM_STAGE) == 0))


def launch_plan(M: int, K: int, N: int, G: int) -> Plan:
    """Pick the kernel by M and size its grid. Decode (M == 1) takes the GEMV
    with the widest blocks that still give two per SM; where N is too small
    for that, 32-column blocks (one 32-byte sector of each packed row), or
    16-column ones where even those leave SMs idle. Every other M takes the
    wgmma GEMM where it takes the shape and the model times it below the
    mma.sync GEMM's best grid (`gemm_plan`), else that grid. The wgmma GEMM's
    threshold (M >= 128) and time per tile-stage (1.0 us) come from
    chip_smoke.py's int4 lines on an H100 SXM: at M = 128 it beat the mma.sync
    GEMM at three of Mistral-7B's four projection shapes, and at M = 1024 and
    8192 a tile-stage took 0.92-1.09 us."""
    if M > 1:
        us, plan = _gemm_best(M, K, N)
        if wgmma_takes(M, K, N, G) and wgmma_us(M, K, N) < us:
            return Plan("wgmma", row_tile=_WGMMA_ROWS, splits=1)
        return plan

    def blocks(ct):
        return -(-N // (_GEMV_COLS * ct))
    ct = next((c for c in (32, 16, 8, 4) if blocks(c) >= 2 * _SMS), 4)
    if blocks(ct) < _SMS:
        ct = 2
    lanes = _GEMV_THREADS // ct
    rows = -(-max(1, K // 2) // (lanes * _GEMV_STEP)) * _GEMV_STEP
    return Plan("gemv", col_threads=ct, rows_per_lane=rows)


_COUNTERS: dict[int, torch.Tensor] = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """The split GEMM's arrival counts, one per output tile: zeros, kept per
    device, which the kernel leaves zero. Launches on one device share them,
    so they run on one stream at a time."""
    c = _COUNTERS.get(device.index)
    if c is None or c.numel() < n:
        c = _COUNTERS[device.index] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                                  device=device)
    return c


def unpack_int4(w4: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[K/2, N] int8 -> (low, high) nibbles, sign-extended, as int16 in [-8, 7].
    HALF-SPLIT layout: low holds rows 0..K/2, high rows K/2..K."""
    w = w4.to(torch.int16)
    return ((w & 0xF) ^ 8) - 8, w >> 4


def int4_matvec_plain(x: torch.Tensor, w4: torch.Tensor,
                      scale: torch.Tensor, x_as_bf16: bool = False) -> torch.Tensor:
    """The same function in plain torch ops, computed in x's dtype with the
    products accumulated in f32 (models/llama.py::_mm's w4 branch in the JAX
    package): x [M, K], w4 [K/2, N], scale [G, N] -> [M, N].

    x_as_bf16: the kernel's form instead, as the Pallas kernel computes it:
    x rounded to bf16, the product in f32, the result in x's dtype."""
    if x_as_bf16:
        y = int4_matvec_plain(x.to(torch.bfloat16).float(), w4, scale)
        return y.to(x.dtype)
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
    if x.dtype not in _X_DTYPES or w4.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError(f"int4_matvec kernel takes bf16 or f32 x, int8 w4, f32 "
                        f"scale; got {x.dtype}, {w4.dtype}, {scale.dtype}")
    g = K // G if G else 0
    if 2 * K2 != K or scale.shape[1] != N or G < 1 or g * G != K or \
            (G > 1 and (G % 2 or g % 16 or K2 % 16)):
        raise ValueError(f"int4_matvec: unsupported shapes x {tuple(x.shape)} "
                         f"w4 {tuple(w4.shape)} scale {tuple(scale.shape)}")
    if not (w4.is_contiguous() and scale.is_contiguous()):
        # a copy here would move the whole weight on every call
        raise ValueError("int4_matvec: w4 and scale must be contiguous")
    x = x.contiguous()
    plan = launch_plan(M, K, N, G)
    if plan.path == "wgmma" and (x.data_ptr() % 16 or w4.data_ptr() % 16
                                 or scale.data_ptr() % 16):
        plan = gemm_plan(M, K, N)      # TMA reads 16-byte aligned bases only
    return _launch(x, w4, scale, plan)


def _launch(x: torch.Tensor, w4: torch.Tensor, scale: torch.Tensor,
            plan: Plan) -> torch.Tensor:
    """One launch of the kernel by `plan`, on inputs int4_matvec has checked:
    the output in x's dtype. The GEMV takes an f32 x as it is; the GEMM gets
    it rounded to bf16 here."""
    M, K = x.shape
    N, G = w4.shape[1], scale.shape[0]
    y = torch.empty(M, N, dtype=x.dtype, device=x.device)
    if plan.path != "gemv":
        x = x.to(torch.bfloat16)
    symbol = _ENTRIES[(x.dtype, y.dtype)]
    ws = counters = None
    if plan.path == "gemm" and plan.splits > 1:
        ws = torch.empty(plan.splits * M * N, dtype=torch.float32, device=x.device)
        counters = _counters(x.device, -(-N // _GEMM_COLS) * -(-M // plan.row_tile))
    lib = build.load("int4_matvec")
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), w4.data_ptr(), scale.data_ptr(), y.data_ptr(),
             None if ws is None else ws.data_ptr(),
             None if counters is None else counters.data_ptr(),
             M, K, N, G, _PATHS[plan.path], plan.col_threads, plan.rows_per_lane,
             plan.row_tile, plan.splits, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "int4_matvec")
    int4_matvec.launches += 1
    int4_matvec.launches_by_path[plan.path] += 1
    return y


int4_matvec.launches = 0
int4_matvec.launches_by_path = dict.fromkeys(_PATHS, 0)
