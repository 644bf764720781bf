"""Param dicts from the JAX package's layout to the port's tensors."""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params: dict, device: torch.device | str = "cpu",
                    dtype: torch.dtype = torch.float32) -> dict:
    """Convert a JAX llama param dict (numpy or jax arrays, passed as numpy)
    into the port's tensors in the same layout ([K, N] for x @ w).

    Float weights become `dtype`; the rope tables stay f32; int4 entries
    {"w4": int8, "scale": f32} keep their types.
    """
    def conv(key: str, a):
        if isinstance(a, dict):
            return {k: conv(k, v) for k, v in a.items()}
        arr = np.asarray(a)
        if key == "w4":
            return torch.from_numpy(np.ascontiguousarray(arr, np.int8)).to(device)
        t = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(device)
        return t if key in ("scale", "rope_cos", "rope_sin") else t.to(dtype)

    return {k: conv(k, v) for k, v in params.items()}
