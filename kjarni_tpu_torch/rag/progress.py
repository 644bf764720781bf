"""Progress reporting for indexing, cf. kjarni-rag/src/progress.rs (a copy of
kjarni_tpu/rag/progress.py)."""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional


class ProgressStage(enum.IntEnum):
    SCANNING = 0
    LOADING = 1
    EMBEDDING = 2
    WRITING = 3
    COMMITTING = 4
    SEARCHING = 5
    RERANKING = 6


@dataclasses.dataclass
class Progress:
    stage: ProgressStage
    current: int
    total: Optional[int] = None
    message: str = ""

    @staticmethod
    def scanning(current: int) -> "Progress":
        return Progress(ProgressStage.SCANNING, current)

    @staticmethod
    def loading(current: int, total: Optional[int] = None) -> "Progress":
        return Progress(ProgressStage.LOADING, current, total)

    @staticmethod
    def embedding(current: int, total: Optional[int] = None) -> "Progress":
        return Progress(ProgressStage.EMBEDDING, current, total)

    @staticmethod
    def writing(current: int, total: Optional[int] = None) -> "Progress":
        return Progress(ProgressStage.WRITING, current, total)

    @staticmethod
    def committing() -> "Progress":
        return Progress(ProgressStage.COMMITTING, 0)


ProgressCallback = Callable[[Progress], None]
