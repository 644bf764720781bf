"""Classifier task API (port of kjarni_tpu/tasks/classifier.py; cf.
kjarni/src/classifier model.rs:52,299,375): classify / classify_batch /
classify_scores / classify_top_k, single- or multi-label (softmax or
sigmoid) from the config's problem_type unless overridden."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence

from ..core.errors import TaskValidationError
from ..models.encoder_models import SequenceClassifier
from ..registry import ModelTask
from .common import Device, DownloadPolicy, resolve_model_dir

_CLASSIFIER_TASKS = (ModelTask.CLASSIFICATION, ModelTask.SENTIMENT_ANALYSIS,
                     ModelTask.ZERO_SHOT_CLASSIFICATION)


@dataclasses.dataclass
class ClassificationResult:
    label: str
    score: float
    all_scores: list[tuple[str, float]]

    def __str__(self) -> str:  # "POSITIVE (100.0%)" like the README quick start
        return f"{self.label} ({self.score * 100:.1f}%)"

    def to_detailed_string(self) -> str:
        return "\n".join(f"  {l}: {s * 100:.1f}%" for l, s in self.all_scores)


class Classifier:
    """Text classification task (cf. classifier/model.rs:52).

    `device=None` means the CUDA card and raises when there is none; pass
    `device="cpu"` to run on the CPU.
    """

    def __init__(self, model: str = "distilbert-sentiment", *,
                 device: Device | str | None = None,
                 cache_dir: Optional[Path] = None,
                 labels: Optional[Sequence[str]] = None,
                 multi_label: Optional[bool] = None,
                 dp: Optional[int] = None,
                 offline: bool = False,
                 quiet: bool = False):
        self.device = Device.resolve(device)
        policy = DownloadPolicy.OFFLINE if offline else DownloadPolicy.ALLOW
        model_dir, info = resolve_model_dir(
            model, cache_dir, policy, quiet, _CLASSIFIER_TASKS, "classification")
        self.model_info = info
        self.model_id = info.cli_name if info else str(model)
        self._clf = SequenceClassifier(model_dir, device=self.device.torch_name, dp=dp)
        if labels is not None:
            expected = len(self._clf.labels or [])
            if expected and len(labels) != expected:
                raise TaskValidationError(
                    f"Model expects {expected} labels but {len(labels)} provided")
            self._clf.labels = list(labels)
        self._multi_label = multi_label  # None -> auto from problem_type

    @property
    def labels(self) -> list[str]:
        return list(self._clf.labels or [])

    @property
    def is_multi_label(self) -> bool:
        if self._multi_label is not None:
            return self._multi_label
        return self._clf.is_multi_label

    def classify_scores(self, text: str) -> list[float]:
        return self._clf.classify_scores_batch([text], self.is_multi_label)[0].tolist()

    def classify(self, text: str) -> ClassificationResult:
        return self.classify_batch([text])[0]

    def classify_batch(self, texts: Sequence[str]) -> list[ClassificationResult]:
        if not texts:
            return []
        scores = self._clf.classify_scores_batch(texts, self.is_multi_label)
        labels = self._clf.labels or [f"LABEL_{i}" for i in range(scores.shape[1])]
        out = []
        for row in scores:
            ranked = sorted(zip(labels, row.tolist()), key=lambda t: -t[1])
            out.append(ClassificationResult(
                label=ranked[0][0], score=float(ranked[0][1]),
                all_scores=[(l, float(s)) for l, s in ranked]))
        return out

    def classify_top_k(self, text: str, k: int) -> list[tuple[str, float]]:
        return self.classify(text).all_scores[:k]

    def classify_with_threshold(self, text: str,
                                threshold: float) -> list[tuple[str, float]]:
        return [(l, s) for l, s in self.classify(text).all_scores if s >= threshold]


def classify(text: str, model: str = "distilbert-sentiment") -> ClassificationResult:
    """One-liner (cf. kjarni/src/classifier one-liner fn)."""
    return Classifier(model).classify(text)
