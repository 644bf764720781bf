"""Param dicts from the JAX package's layout to the port's tensors."""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params: dict, device: torch.device | str = "cpu",
                    dtype: torch.dtype = torch.float32) -> dict:
    """Convert a JAX llama, gpt2 or encoder param dict (numpy or jax arrays,
    passed as numpy) into the port's tensors in the same layout and under
    the same names ([K, N] for x @ w).

    Float weights become `dtype`; the rope tables and quantization scales
    stay f32; int8 arrays keep their type: int4 {"w4": int8, "scale": f32}
    and int8 {"w": int8, "scale": f32} entries come across as stored. The
    encoder's absent parts (`pooler`, `rel_bias`, `token_type`, `position`)
    stay None.
    """
    def conv(key: str, a):
        if a is None:
            return None
        if isinstance(a, dict):
            return {k: conv(k, v) for k, v in a.items()}
        quantized = np.asarray(a).dtype == np.int8
        arr = np.ascontiguousarray(a, np.int8 if quantized else np.float32)
        if not arr.flags.writeable:   # a JAX array seen through numpy: own a copy
            arr = arr.copy()
        t = torch.from_numpy(arr).to(device)
        return t if quantized or key in ("scale", "rope_cos", "rope_sin") else t.to(dtype)

    return {k: conv(k, v) for k, v in params.items()}
