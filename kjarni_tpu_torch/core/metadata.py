"""Model metadata shared across the engine.

Copy of kjarni_tpu/core/metadata.py, with `Device` naming the CUDA card
instead of the TPU. The port's entry points run on the card unless the caller
asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Device(str, enum.Enum):
    """Where compute runs. `AUTO` and `CUDA` mean the card; `CPU` must be
    asked for."""

    AUTO = "auto"
    CPU = "cpu"
    CUDA = "cuda"

    @staticmethod
    def resolve(value: "Device | str | None") -> "Device":
        if value is None:
            return Device.AUTO
        if isinstance(value, Device):
            return value
        v = value.lower()
        # accept the reference's "gpu" spelling for the accelerator
        if v in ("cuda", "gpu", "accelerator"):
            return Device.CUDA
        if v == "cpu":
            return Device.CPU
        if v == "auto":
            return Device.AUTO
        raise ValueError(f"Unknown device '{value}' (expected auto/cpu/cuda)")

    @property
    def torch_name(self) -> str:
        """The torch device: the CPU only when asked for, else the card."""
        return "cpu" if self is Device.CPU else "cuda"


class NormStrategy(str, enum.Enum):
    LAYER_NORM = "layer_norm"
    RMS_NORM = "rms_norm"


class NormPlacement(str, enum.Enum):
    PRE = "pre"    # pre-norm (Llama and friends)
    POST = "post"  # post-norm (BERT, GPT-2 is pre but legacy-handled separately)


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """RoPE frequency scaling (llama3 style), cf. models/base.rs:14 RopeScalingConfig."""

    rope_type: str = "llama3"
    factor: float = 32.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclasses.dataclass(frozen=True)
class ModelMetadata:
    """Structural hyperparameters every model exposes (cf. traits.rs:55)."""

    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    vocab_size: int
    max_seq_len: int
    intermediate_size: int
    norm_strategy: NormStrategy = NormStrategy.LAYER_NORM
    norm_placement: NormPlacement = NormPlacement.POST
    norm_eps: float = 1e-12
    rope_theta: Optional[float] = None
    rope_scaling: Optional[RopeScaling] = None
    tie_word_embeddings: bool = False

    @property
    def is_gqa(self) -> bool:
        return self.num_kv_heads != self.num_heads
