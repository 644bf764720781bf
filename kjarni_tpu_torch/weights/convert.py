"""Param dicts from the JAX package's layout to the port's tensors."""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params: dict, device: torch.device | str = "cpu",
                    dtype: torch.dtype = torch.float32) -> dict:
    """Convert a JAX param dict of any family the port has (llama, gpt2, the
    BERT encoders, BART, T5, Whisper; numpy or jax arrays, passed as numpy)
    into the port's tensors in the same layout and under the same names
    ([K, N] for x @ w, layers stacked on a leading axis).

    Float weights become `dtype`, whatever their rank: Whisper's conv
    weights [C_out, C_in, K] and T5's relative-position tables
    [num_buckets, H] as stored, a transposed view (a tied `lm_head`) as a
    contiguous copy. The rope tables and quantization scales stay f32; int8
    arrays keep their type: int4 {"w4": int8, "scale": f32} and int8
    {"w": int8, "scale": f32} entries come across as stored. The encoder's
    absent parts (`pooler`, `rel_bias`, `token_type`, `position`) stay None.
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
