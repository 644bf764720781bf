"""BM25 keyword index.

Rebuild of kjarni-search/src/bm25.rs:44 with the same parameters (k1=1.2,
b=0.75, eps=0.25), tokenization (lowercase alnum split, len>=2), and IDF
formula ln((N - df + 0.5)/(df + 0.5) + 1). JSON-serializable (the reference is
serde-serializable). A copy of kjarni_tpu/search/bm25.py.
"""

from __future__ import annotations

import dataclasses
import math
import re
from collections import Counter, defaultdict

_TOKEN_RE = re.compile(r"[^0-9a-z]+")


def tokenize(text: str) -> list[str]:
    """Lowercase, split on non-alphanumeric, drop tokens shorter than 2 chars."""
    return [t for t in _TOKEN_RE.split(text.lower()) if len(t) >= 2]


@dataclasses.dataclass
class Bm25Params:
    k1: float = 1.2
    b: float = 0.75
    epsilon: float = 0.25


class Bm25Index:
    def __init__(self, params: Bm25Params | None = None):
        self.params = params or Bm25Params()
        self.doc_frequencies: dict[str, int] = defaultdict(int)
        self.doc_lengths: list[int] = []
        self.avg_doc_length = 0.0
        self.total_docs = 0
        self.inverted_index: dict[str, list[tuple[int, int]]] = defaultdict(list)
        self.total_length = 0

    def add_document(self, doc_id: int, text: str) -> None:
        tokens = tokenize(text)
        if doc_id >= len(self.doc_lengths):
            self.doc_lengths.extend([0] * (doc_id + 1 - len(self.doc_lengths)))
        self.doc_lengths[doc_id] = len(tokens)
        for term, count in Counter(tokens).items():
            self.inverted_index[term].append((doc_id, count))
            self.doc_frequencies[term] += 1
        self.total_docs = max(self.total_docs, doc_id + 1)
        self.total_length += len(tokens)
        self.avg_doc_length = self.total_length / self.total_docs

    def search(self, query: str, limit: int) -> list[tuple[int, float]]:
        if self.total_docs == 0:
            return []
        q_terms = tokenize(query)
        if not q_terms:
            return []
        k1, b = self.params.k1, self.params.b
        scores: dict[int, float] = defaultdict(float)
        N = self.total_docs
        for term in q_terms:
            postings = self.inverted_index.get(term)
            if not postings:
                continue
            df = self.doc_frequencies[term]
            idf = math.log((N - df + 0.5) / (df + 0.5) + 1.0)
            for doc_id, tf in postings:
                length_norm = 1.0 - b + b * (self.doc_lengths[doc_id] /
                                             self.avg_doc_length)
                scores[doc_id] += idf * (tf * (k1 + 1.0)) / (tf + k1 * length_norm)
        results = [(d, s) for d, s in scores.items() if s > 0.0]
        results.sort(key=lambda t: -t[1])
        return results[:limit]

    # serialization ---------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "params": dataclasses.asdict(self.params),
            "doc_frequencies": dict(self.doc_frequencies),
            "doc_lengths": self.doc_lengths,
            "avg_doc_length": self.avg_doc_length,
            "total_docs": self.total_docs,
            "inverted_index": {t: p for t, p in self.inverted_index.items()},
            "total_length": self.total_length,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Bm25Index":
        idx = cls(Bm25Params(**d["params"]))
        idx.doc_frequencies = defaultdict(int, d["doc_frequencies"])
        idx.doc_lengths = list(d["doc_lengths"])
        idx.avg_doc_length = d["avg_doc_length"]
        idx.total_docs = d["total_docs"]
        idx.inverted_index = defaultdict(
            list, {t: [tuple(p) for p in ps] for t, ps in d["inverted_index"].items()})
        idx.total_length = d.get("total_length", sum(idx.doc_lengths))
        return idx
