"""Reranker task API (port of kjarni_tpu/tasks/reranker.py; cf.
kjarni/src/reranker model.rs:214-315): score / score_pairs / rerank /
rerank_top_k / rerank_with_threshold over CrossEncoder."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence

from ..models.encoder_models import CrossEncoder
from ..registry import ModelTask
from .common import Device, DownloadPolicy, resolve_model_dir

_RERANKER_TASKS = (ModelTask.RERANKING,)


@dataclasses.dataclass
class RerankResult:
    index: int
    score: float
    text: str


class Reranker:
    """Query-document reranking task (cf. reranker/model.rs).

    `device=None` means the CUDA card and raises when there is none; pass
    `device="cpu"` to run on the CPU.
    """

    def __init__(self, model: str = "minilm-l6-v2-cross-encoder", *,
                 device: Device | str | None = None,
                 cache_dir: Optional[Path] = None,
                 dp: Optional[int] = None,
                 offline: bool = False,
                 quiet: bool = False):
        self.device = Device.resolve(device)
        policy = DownloadPolicy.OFFLINE if offline else DownloadPolicy.ALLOW
        model_dir, info = resolve_model_dir(
            model, cache_dir, policy, quiet, _RERANKER_TASKS, "reranking")
        self.model_info = info
        self.model_id = info.cli_name if info else str(model)
        self._ce = CrossEncoder(model_dir, device=self.device.torch_name, dp=dp)

    def score(self, query: str, document: str) -> float:
        return self._ce.predict_pair(query, document)

    def score_pairs(self, pairs: Sequence[tuple[str, str]]) -> list[float]:
        return self._ce.predict_pairs(pairs).tolist()

    def rerank(self, query: str, documents: Sequence[str]) -> list[RerankResult]:
        ranked = self._ce.rerank(query, documents)
        return [RerankResult(i, s, documents[i]) for i, s in ranked]

    def rerank_top_k(self, query: str, documents: Sequence[str],
                     k: int) -> list[RerankResult]:
        return self.rerank(query, documents)[:k]

    def rerank_with_threshold(self, query: str, documents: Sequence[str],
                              threshold: float) -> list[RerankResult]:
        return [r for r in self.rerank(query, documents) if r.score >= threshold]
