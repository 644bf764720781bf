"""Reciprocal-rank fusion (k=60), cf. kjarni-search/src/hybrid.rs:3-31 (a copy
of kjarni_tpu/search/hybrid.py)."""

from __future__ import annotations

from collections import defaultdict

RRF_K = 60.0


def hybrid_search(keyword_results: list[tuple[int, float]],
                  semantic_results: list[tuple[int, float]],
                  limit: int) -> list[tuple[int, float]]:
    combined: dict[int, float] = defaultdict(float)
    for rank, (idx, _score) in enumerate(keyword_results):
        combined[idx] += 1.0 / (RRF_K + rank + 1)
    for rank, (idx, _score) in enumerate(semantic_results):
        combined[idx] += 1.0 / (RRF_K + rank + 1)
    out = sorted(combined.items(), key=lambda t: -t[1])
    return out[:limit]
