"""Embedder task API (port of kjarni_tpu/tasks/embedder.py; cf.
kjarni/src/embedder model.rs:33-230): embed / embed_batch / similarity /
similarities / rank_by_similarity / cosine_similarity over SentenceEncoder."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..models.encoder_models import SentenceEncoder
from ..ops.pooling import PoolingStrategy
from ..registry import ModelTask
from .common import Device, DownloadPolicy, resolve_model_dir

_EMBEDDER_TASKS = (ModelTask.EMBEDDING,)


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    """Cf. embedder/model.rs:247."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    denom = float(np.linalg.norm(a) * np.linalg.norm(b))
    if denom == 0.0:
        return 0.0
    return float(a @ b / denom)


class Embedder:
    """Text embedding task (cf. embedder/model.rs:33).

    `device=None` means the CUDA card and raises when there is none; pass
    `device="cpu"` to run on the CPU.
    """

    def __init__(self, model: str = "minilm-l6-v2", *,
                 device: Device | str | None = None,
                 cache_dir: Optional[Path] = None,
                 pooling: PoolingStrategy | str = PoolingStrategy.MEAN,
                 normalize: bool = True,
                 dp: Optional[int] = None,
                 offline: bool = False,
                 quiet: bool = False):
        self.device = Device.resolve(device)
        policy = DownloadPolicy.OFFLINE if offline else DownloadPolicy.ALLOW
        model_dir, info = resolve_model_dir(
            model, cache_dir, policy, quiet, _EMBEDDER_TASKS, "embedding")
        self.model_info = info
        self.model_id = info.cli_name if info else str(model)
        self._encoder = SentenceEncoder(model_dir, device=self.device.torch_name, dp=dp)
        self.pooling = pooling
        self.normalize = normalize

    @property
    def dim(self) -> int:
        return self._encoder.hidden_size

    def embed(self, text: str) -> np.ndarray:
        return self._encoder.encode(text, pooling=self.pooling, normalize=self.normalize)

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        return self._encoder.encode_batch(texts, pooling=self.pooling,
                                          normalize=self.normalize)

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.embed_batch([a, b])
        return cosine_similarity(va, vb)

    def similarities(self, query: str, texts: Sequence[str]) -> list[float]:
        if not texts:
            return []
        vecs = self.embed_batch([query, *texts])
        q, rest = vecs[0], vecs[1:]
        return [cosine_similarity(q, v) for v in rest]

    def rank_by_similarity(self, query: str,
                           texts: Sequence[str]) -> list[tuple[int, float]]:
        sims = self.similarities(query, texts)
        order = sorted(range(len(sims)), key=lambda i: -sims[i])
        return [(i, sims[i]) for i in order]


def embed(text: str, model: str = "minilm-l6-v2") -> np.ndarray:
    """One-liner (cf. kjarni/src/lib.rs:117)."""
    return Embedder(model).embed(text)
