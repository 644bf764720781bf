"""Flash attention: a hand-written Hopper kernel and its plain PyTorch version.

Replaces kjarni_tpu/ops/pallas/flash_attention.py::flash_attention, at both
dtypes the Pallas kernel takes. Two CUDA sources: csrc/flash_attention.cu
(bf16, wgmma) and csrc/flash_attention_f32.cu (f32, 3xTF32 wgmma: each f32
operand split into two TF32 parts and three tensor-core products summed in
f32, within 1e-5 of the plain f32 output's largest magnitude); each header
says what bounds it on the H100 and what its design does about that. The f32
kernel's split is its own: `torch.backends.cuda.matmul.allow_tf32` does not
reach it, and its accuracy does not depend on it.

`flash_attention` launches the kernel of its inputs' dtype for CUDA tensors
(bf16 or f32; anything else raises TypeError) and raises on what the kernel
does not take (`check_shapes` holds the shape rules); it runs the plain
version only for tensors on the CPU. `flash_attention.launches` counts the
bf16 kernel's launches, `flash_attention.launches_f32` the f32 kernel's.
`flash_attention_f32_tf32only` is a control for the tests and chip_smoke.py
(the f32 kernel with the split's small terms dropped); nothing else calls it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

NEG_INF = -1e30  # the kernel's mask value, as in the Pallas kernel
HEAD_DIMS = (32, 64, 96, 128)
_BLOCK_ROWS = 64        # query rows per block (4 warps x 16)
_MAX_GRID_Y = 65535     # row blocks per (batch, KV head)
# dtype -> (kernel library in csrc/, its C entry point)
_KERNELS = {torch.bfloat16: ("flash_attention", "kj_flash_attention_bf16"),
            torch.float32: ("flash_attention_f32", "kj_flash_attention_f32")}
_F32_CONTROL = "kj_flash_attention_f32_tf32only"


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = False, scale: Optional[float] = None,
                          window: Optional[int] = None, q_offset: int = 0,
                          kv_len: Optional[int] = None) -> torch.Tensor:
    """The same function in plain torch ops, in f32: q [B,H,S,D], k/v
    [B,Hkv,T,D] -> [B,H,S,D] in q's dtype. Queries sit at absolute positions
    q_offset..q_offset+S-1 and attend K/V positions below kv_len."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = H // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    kv_len = T if kv_len is None else kv_len
    qf = q.float().reshape(B, Hkv, G * S, D)
    s = torch.matmul(qf, k.float().transpose(-1, -2)) * scale   # [B,Hkv,G*S,T]
    row = q_offset + torch.arange(G * S, device=q.device) % S
    col = torch.arange(T, device=q.device)
    keep = (col < kv_len)[None, :].expand(G * S, T)
    if causal:
        keep = keep & (col[None, :] <= row[:, None])
    if window is not None:
        keep = keep & (col[None, :] > row[:, None] - window)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.matmul(p, v.float()) / p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    return out.reshape(B, H, S, D).to(q.dtype)


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """t itself when the kernel can read it through its strides (unit D
    stride, 16-byte aligned rows), else a contiguous copy."""
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s % 8 == 0 for s in t.stride()[:-1]))
    return t if ok else t.contiguous()


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ValueError unless the kernel takes these shapes: q [B, H, S, D],
    k and v [B, Hkv, T, D] alike, D in HEAD_DIMS, Hkv dividing H, and no more
    row blocks than a grid holds. Reads shapes only (CPU or meta tensors do)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q and k must be 4-d, got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if D not in HEAD_DIMS or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D or Hkv < 1 or H % Hkv \
            or -(-(H // Hkv) * S // _BLOCK_ROWS) > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: unsupported shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)} (D in {HEAD_DIMS})")


def _launch(q, k, v, symbol: str, causal, scale, window, q_offset, kv_len) -> torch.Tensor:
    """One call of the C entry point `symbol` on inputs flash_attention has
    checked: the output, [B, S, H, D] storage seen as [B, H, S, D]."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    kv_len = T if kv_len is None else int(kv_len)
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    # [B, S, H, D] storage: merge_heads of the result is then a free view
    o = torch.empty(B, S, H, D, dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, o)
                                      for s in t.stride()[:3]))
    name = _KERNELS[q.dtype][0]
    lib = build.load(name)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int64)] + \
            [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
             B, H, Hkv, S, T, D, int(q_offset), kv_len, int(causal), int(window or 0),
             float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, name)
    return o


def _checked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: tensors on {q.device}/{k.device}/"
                         f"{v.device}; the kernel takes one CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNELS:
        raise TypeError(f"flash_attention kernels take bf16 or f32 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    check_shapes(q, k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    window: Optional[int] = None, q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q [B, H, S, D], k/v [B, Hkv, T, D] -> [B, H, S, D].

    q_offset (default 0) is the absolute position of q[:, :, 0]; queries
    attend K/V positions below kv_len (default T): the cache-resume form.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     window=window, q_offset=q_offset,
                                     kv_len=kv_len)
    _checked(q, k, v)
    o = _launch(q, k, v, _KERNELS[q.dtype][1], causal, scale, window, q_offset, kv_len)
    if q.dtype == torch.float32:
        flash_attention.launches_f32 += 1
    else:
        flash_attention.launches += 1
    return o


def flash_attention_f32_tf32only(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                 causal: bool = False, scale: Optional[float] = None,
                                 window: Optional[int] = None, q_offset: int = 0,
                                 kv_len: Optional[int] = None) -> torch.Tensor:
    """The f32 kernel with the split's small terms dropped (one TF32 product
    each), on f32 CUDA tensors: a control that must fall outside the f32
    kernel's bound. Not counted; the port never calls it."""
    _checked(q, k, v)
    if q.dtype != torch.float32:
        raise TypeError(f"the TF32-only control takes f32, got {q.dtype}")
    return _launch(q, k, v, _F32_CONTROL, causal, scale, window, q_offset, kv_len)


flash_attention.launches = 0
flash_attention.launches_f32 = 0
