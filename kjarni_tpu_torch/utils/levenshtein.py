"""Levenshtein distance + similarity helpers (cf. kjarni-transformers/src/utils/levenshtein)."""

from __future__ import annotations


def distance(a: str, b: str) -> int:
    if a == b:
        return 0
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def similarity(a: str, b: str) -> float:
    """1 - normalized edit distance, in [0, 1]."""
    if not a and not b:
        return 1.0
    d = distance(a.lower(), b.lower())
    return 1.0 - d / max(len(a), len(b))


def find_similar(query: str, candidates: list[str], limit: int = 3,
                 min_similarity: float = 0.4) -> list[tuple[str, float]]:
    scored = [(c, similarity(query, c)) for c in candidates]
    scored = [t for t in scored if t[1] >= min_similarity]
    scored.sort(key=lambda t: -t[1])
    return scored[:limit]
