"""In-memory SearchIndex: docs + metadata + BM25 + vectors in one object.

Rebuild of kjarni-rag/src/search_index.rs:14 (search_hybrid_weighted :248,
save_binary :129, remove_by_source :43). Serialization is JSON (with a gzip
"binary" variant standing in for the reference's bincode).

Port of kjarni_tpu/rag/search_index.py with the same JSON form, so a file
saved by either package loads in the other. The vectors are scored on the
index's device (`device=None`: the card; see search/vector.py).
"""

from __future__ import annotations

import gzip
import json
from collections import defaultdict
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..search.bm25 import Bm25Index
from ..search.hybrid import RRF_K, hybrid_search
from ..search.types import SearchResult
from ..search.vector import VectorStore


def hybrid_search_weighted(keyword_results, semantic_results, limit,
                           keyword_weight: float, semantic_weight: float):
    """Weighted reciprocal-rank fusion (search_index.rs:248)."""
    combined: dict[int, float] = defaultdict(float)
    for rank, (idx, _s) in enumerate(keyword_results):
        combined[idx] += keyword_weight / (RRF_K + rank + 1)
    for rank, (idx, _s) in enumerate(semantic_results):
        combined[idx] += semantic_weight / (RRF_K + rank + 1)
    out = sorted(combined.items(), key=lambda t: -t[1])
    return out[:limit]


class SearchIndex:
    def __init__(self, dimension: int = 0, device=None):
        self.device = device
        self.documents: list[str] = []
        self.metadata: list[dict[str, str]] = []
        self.bm25 = Bm25Index()
        self.vectors = VectorStore(dimension=dimension, device=device)

    # building ---------------------------------------------------------------

    @classmethod
    def build(cls, documents: Sequence[str], embeddings,
              metadata: Optional[Sequence[dict]] = None,
              device=None) -> "SearchIndex":
        idx = cls(device=device)
        idx.add_documents(documents, embeddings, metadata)
        return idx

    def add_document(self, text: str, embedding,
                     metadata: Optional[dict] = None) -> int:
        doc_id = len(self.documents)
        self.documents.append(text)
        self.metadata.append(dict(metadata or {}))
        self.bm25.add_document(doc_id, text)
        self.vectors.add(embedding)
        return doc_id

    def add_documents(self, texts: Sequence[str], embeddings,
                      metadata: Optional[Sequence[dict]] = None) -> list[int]:
        embeddings = np.asarray(embeddings, dtype=np.float32)
        return [self.add_document(t, embeddings[i],
                                  metadata[i] if metadata else None)
                for i, t in enumerate(texts)]

    def remove_by_source(self, source: str) -> int:
        """Drop all docs whose metadata source matches; rebuilds sub-indexes
        (search_index.rs:43)."""
        keep = [i for i, md in enumerate(self.metadata)
                if md.get("source") != source]
        removed = len(self.documents) - len(keep)
        if removed == 0:
            return 0
        docs = [self.documents[i] for i in keep]
        meta = [self.metadata[i] for i in keep]
        embs = self.vectors.matrix[keep] if len(keep) else None
        self.documents, self.metadata = [], []
        self.bm25 = Bm25Index()
        self.vectors = VectorStore(dimension=self.vectors.dimension,
                                   device=self.device)
        if docs:
            self.add_documents(docs, embs, meta)
        return removed

    # search -----------------------------------------------------------------

    def _format(self, scored) -> list[SearchResult]:
        out = []
        for idx, score in scored:
            if idx < len(self.documents):
                out.append(SearchResult(score=float(score), document_id=idx,
                                        text=self.documents[idx],
                                        metadata=self.metadata[idx]))
        return out

    def search_keywords(self, query: str, limit: int) -> list[SearchResult]:
        return self._format(self.bm25.search(query, limit))

    def search_semantic(self, query_embedding, limit: int) -> list[SearchResult]:
        return self._format(self.vectors.search(query_embedding, limit))

    def search_hybrid(self, query: str, query_embedding,
                      limit: int) -> list[SearchResult]:
        kw = self.bm25.search(query, limit * 2)
        sem = self.vectors.search(query_embedding, limit * 2)
        return self._format(hybrid_search(kw, sem, limit))

    def search_hybrid_weighted(self, query: str, query_embedding, limit: int,
                               keyword_weight: float,
                               semantic_weight: float) -> list[SearchResult]:
        kw = self.bm25.search(query, limit * 2)
        sem = self.vectors.search(query_embedding, limit * 2)
        return self._format(hybrid_search_weighted(
            kw, sem, limit, keyword_weight, semantic_weight))

    # accessors ---------------------------------------------------------------

    def get_document(self, doc_id: int) -> Optional[str]:
        return self.documents[doc_id] if doc_id < len(self.documents) else None

    def get_metadata(self, doc_id: int) -> Optional[dict]:
        return self.metadata[doc_id] if doc_id < len(self.metadata) else None

    def __len__(self) -> int:
        return len(self.documents)

    @property
    def dimension(self) -> int:
        return self.vectors.dimension

    # serialization -----------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({
            "documents": self.documents,
            "metadata": self.metadata,
            "bm25": self.bm25.to_dict(),
            "vectors": self.vectors.to_dict(),
        })

    @classmethod
    def from_json(cls, data: str, device=None) -> "SearchIndex":
        d = json.loads(data)
        idx = cls(device=device)
        idx.documents = list(d["documents"])
        idx.metadata = [dict(m) for m in d["metadata"]]
        idx.bm25 = Bm25Index.from_dict(d["bm25"])
        idx.vectors = VectorStore.from_dict(d["vectors"], device=device)
        return idx

    def save_to_file(self, path: str | Path) -> None:
        """gzip-compressed JSON (the reference's bincode analogue)."""
        with gzip.open(path, "wt") as f:
            f.write(self.to_json())

    @classmethod
    def load_from_file(cls, path: str | Path, device=None) -> "SearchIndex":
        with gzip.open(path, "rt") as f:
            return cls.from_json(f.read(), device)
