"""Activation functions (port of kjarni_tpu/ops/activations.py).

The gelu/gelu_new distinction matters for parity: BERT uses erf-gelu, GPT-2
the tanh approximation. `gelu` takes the tanh form on bf16 inputs and keeps
erf on f32, as the JAX package does: the two differ by < 5e-4, below one bf16
ulp over the practical range, and the f32 path stays exact for parity tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, HF "gelu"; the tanh form on bf16 inputs."""
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x, approximate="none")


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximate GELU, HF "gelu_new"/"gelu_pytorch_tanh" (GPT-2)."""
    return F.gelu(x, approximate="tanh")


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


ACTIVATIONS = {
    "gelu": gelu,
    "gelu_new": gelu_new,
    "gelu_pytorch_tanh": gelu_new,
    "gelu_fast": gelu_new,
    "relu": relu,
    "silu": silu,
    "swish": silu,
    "tanh": tanh,
}


def get_activation(name: str):
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"Unknown activation '{name}' (known: {sorted(ACTIVATIONS)})")
