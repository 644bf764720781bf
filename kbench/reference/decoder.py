"""The plain reference of the benchmark's decoders: float32 PyTorch, TF32 off.

`logits_at` runs the forward of the configuration's architecture module
(`kbench/arch/<family>.py`, found by `model_type`; a new architecture is a new
file there, with no edit here), written from the published model code with no
kernel, cache or batching. Weights are drawn again from the seed
(`kbench/weights.py`), one kind at a time; the model runs layer by layer over
every sequence, so it fits beside what the card still holds.

This file holds what every architecture's reference shares. `quant="int4"`
applies its own frozen copy of the int4 scheme the configuration states:
groups of 128 along the input dimension, scale = absmax / 7 in float32,
values rounded half to even and clamped to [-8, 7], on every projection and
the head, not the embedding.

`precision="fp8"` is the control: every linear layer's input rounded to fp8
e4m3 with one scale per row (amax / 448), and, where the weights are not
already int4, the weights to e4m3 with one scale per output channel. It is
the nearest step below bf16, the one a later change might take.

Imports nothing of the program and takes nothing the program made.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from .. import lookup

INT4_GROUP = 128
FP8_MAX = 448.0
PRECISIONS = ("f32", "fp8")


def int4_dequant(w: torch.Tensor) -> torch.Tensor:
    """A [N, K] weight (out, in) quantized to int4 in groups of 128 along K,
    returned dequantized in f32 as [K, N] for x @ w. One scale per column
    where K is not a multiple of two groups."""
    w32 = w.float().t().contiguous()
    K, N = w32.shape
    g = INT4_GROUP if K % (2 * INT4_GROUP) == 0 else K
    wg = w32.reshape(K // g, g, N)
    scale = wg.abs().amax(dim=1).clamp_min(1e-8) / 7.0
    q = torch.clamp(torch.round(wg / scale[:, None, :]), -8, 7)
    return (q * scale[:, None, :]).reshape(K, N)


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 with one scale per row (last dim), back in f32."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def weight(w: torch.Tensor, quant: Optional[str], precision: str) -> torch.Tensor:
    """A [N, K] bf16 weight as the f32 [K, N] the reference multiplies by."""
    if quant == "int4":
        return int4_dequant(w)
    wt = w.float().t().contiguous()
    if precision == "fp8":
        wt = fp8_rows(wt.t()).t().contiguous()    # one scale per output channel
    return wt


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    return (fp8_rows(x) if precision == "fp8" else x) @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w.float()


@torch.no_grad()
def logits_at(cfg: dict, seed: int, seqs: list, rows: list, device, *,
              quant: Optional[str] = None, precision: str = "f32",
              kroot: Path = lookup.KROOT) -> list:
    """The reference's f32 logits of each sequence at the given rows.

    seqs: token id lists, each a whole sequence (prompt and served tokens);
    rows: for each, the positions whose next-token logits are wanted.
    Returns one [len(rows_i), V] f32 tensor per sequence."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown reference precision {precision!r}")
    forward = lookup.architecture(cfg, kroot).logits_at
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return forward(cfg, seed, seqs, rows, torch.device(device), quant=quant,
                       precision=precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
