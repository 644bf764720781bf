"""Core search/RAG types, cf. kjarni-search/src/types.rs (a copy of
kjarni_tpu/search/types.py, which imports no JAX)."""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Optional


def _uuid_simple() -> str:
    return f"{time.time_ns():032x}"


@dataclasses.dataclass
class ChunkMetadata:
    source: Optional[str] = None
    chunk_index: Optional[int] = None
    total_chunks: Optional[int] = None
    page: Optional[int] = None
    sections: list[str] = dataclasses.field(default_factory=list)
    custom: dict[str, str] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict[str, str]:
        out: dict[str, str] = {}
        if self.source is not None:
            out["source"] = self.source
        if self.chunk_index is not None:
            out["chunk_index"] = str(self.chunk_index)
        if self.total_chunks is not None:
            out["total_chunks"] = str(self.total_chunks)
        if self.page is not None:
            out["page"] = str(self.page)
        if self.sections:
            out["sections"] = " > ".join(self.sections)
        out.update(self.custom)
        return out


@dataclasses.dataclass
class Chunk:
    text: str
    id: str = dataclasses.field(default_factory=_uuid_simple)
    metadata: ChunkMetadata = dataclasses.field(default_factory=ChunkMetadata)

    def with_source(self, source: str) -> "Chunk":
        self.metadata.source = source
        return self


@dataclasses.dataclass
class SearchResult:
    score: float
    document_id: int
    text: str
    metadata: dict[str, str] = dataclasses.field(default_factory=dict)


class SearchMode(str, enum.Enum):
    KEYWORD = "keyword"
    SEMANTIC = "semantic"
    HYBRID = "hybrid"

    @staticmethod
    def parse(s: str) -> "SearchMode":
        v = s.lower()
        if v in ("keyword", "bm25"):
            return SearchMode.KEYWORD
        if v in ("semantic", "vector"):
            return SearchMode.SEMANTIC
        if v == "hybrid":
            return SearchMode.HYBRID
        raise ValueError(
            f"Unknown search mode: '{s}'. Use: keyword, semantic, hybrid")
