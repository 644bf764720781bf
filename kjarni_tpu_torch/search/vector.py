"""Flat vector store with cosine top-k (port of kjarni_tpu/search/vector.py).

Rebuild of kjarni-search/src/vector.rs:5. The reference loops
cosine_similarity per document on the CPU; here the store is one [N, D]
matrix and a search is one matrix-vector product plus a top-k.

Below _DEVICE_MIN_ROWS rows the scores are computed in numpy, as the JAX
package computes them. From there on the row-normalized f32 matrix is kept
on the store's device (built once, dropped by `add` and `normalize`) and a
search is one f32 `torch.mv` against it. Either way the scores come back to
the host and the same argpartition / argsort picks the top k, so ties break
as in the JAX package. Scores stay f32: TF32 or bf16 would reorder rankings
whose scores lie 1e-5 apart.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.placement import resolve_device

# Device offload threshold: below this, numpy beats the dispatch overhead.
_DEVICE_MIN_ROWS = 4096


def _device_scores(matrix: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Scores of every row of the normalized [N, D] matrix against the
    normalized [D] query: one f32 matrix-vector product on the device."""
    return torch.mv(matrix, query)


class VectorStore:
    """`device=None` means the CUDA card and raises when there is none; pass
    `device="cpu"` to keep the device branch on the CPU."""

    def __init__(self, embeddings: Optional[Sequence[Sequence[float]]] = None,
                 dimension: int = 0, device=None):
        self.device = resolve_device(device)
        if embeddings is not None and len(embeddings) > 0:
            self._matrix = np.asarray(embeddings, dtype=np.float32)
            if self._matrix.ndim != 2:
                raise ValueError("embeddings must be a 2-D [n, dim] collection")
            self.dimension = self._matrix.shape[1]
        else:
            self._matrix = np.zeros((0, dimension), dtype=np.float32)
            self.dimension = dimension
        self._device_matrix: Optional[torch.Tensor] = None  # normalized copy

    def __len__(self) -> int:
        return self._matrix.shape[0]

    @property
    def is_empty(self) -> bool:
        return len(self) == 0

    @property
    def matrix(self) -> np.ndarray:
        return self._matrix

    def add(self, embedding: Sequence[float]) -> int:
        emb = np.asarray(embedding, dtype=np.float32)[None, :]
        if self.dimension == 0:
            self.dimension = emb.shape[1]
            self._matrix = np.zeros((0, self.dimension), dtype=np.float32)
        elif emb.shape[1] != self.dimension:
            raise ValueError(
                f"Embedding has dimension {emb.shape[1]} but store expects "
                f"{self.dimension}")
        self._matrix = np.concatenate([self._matrix, emb], axis=0)
        self._device_matrix = None
        return len(self) - 1

    def add_batch(self, embeddings: Sequence[Sequence[float]]) -> list[int]:
        start = len(self)
        for e in embeddings:
            self.add(e)
        return list(range(start, len(self)))

    def get(self, index: int) -> Optional[np.ndarray]:
        if 0 <= index < len(self):
            return self._matrix[index]
        return None

    def normalize(self) -> None:
        norms = np.linalg.norm(self._matrix, axis=1, keepdims=True)
        np.divide(self._matrix, np.maximum(norms, 1e-9), out=self._matrix)
        self._device_matrix = None

    @staticmethod
    def cosine_similarity(a: Sequence[float], b: Sequence[float]) -> float:
        a = np.asarray(a, dtype=np.float32)
        b = np.asarray(b, dtype=np.float32)
        if a.shape != b.shape:
            return 0.0
        denom = max(float(np.linalg.norm(a) * np.linalg.norm(b)), 1e-9)
        return float(a @ b / denom)

    @staticmethod
    def dot_product(a, b) -> float:
        a = np.asarray(a, dtype=np.float32)
        b = np.asarray(b, dtype=np.float32)
        if a.shape != b.shape:
            return 0.0
        return float(a @ b)

    @staticmethod
    def euclidean_distance(a, b) -> float:
        a = np.asarray(a, dtype=np.float32)
        b = np.asarray(b, dtype=np.float32)
        if a.shape != b.shape:
            return float(np.finfo(np.float32).max)
        return float(np.linalg.norm(a - b))

    def device_matrix(self) -> torch.Tensor:
        """The row-normalized matrix on the store's device, normalized on the
        host as the JAX package does it, and cached until the rows change."""
        if self._device_matrix is None:
            m = self._matrix
            m_norms = np.maximum(np.linalg.norm(m, axis=1), 1e-9)
            self._device_matrix = torch.from_numpy(m / m_norms[:, None]).to(self.device)
        return self._device_matrix

    def _scores(self, query: np.ndarray) -> np.ndarray:
        """Cosine scores against every stored vector, on the host."""
        q_norm = max(float(np.linalg.norm(query)), 1e-9)
        if len(self) >= _DEVICE_MIN_ROWS:
            q = torch.from_numpy(query / q_norm).to(self.device)
            return _device_scores(self.device_matrix(), q).cpu().numpy()
        m = self._matrix
        m_norms = np.maximum(np.linalg.norm(m, axis=1), 1e-9)
        return (m @ query) / (m_norms * q_norm)

    def search(self, query_embedding: Sequence[float],
               limit: int) -> list[tuple[int, float]]:
        query = np.asarray(query_embedding, dtype=np.float32)
        if self.is_empty or query.shape[0] != self.dimension:
            return []
        scores = self._scores(query)
        k = min(limit, len(self))
        top = np.argpartition(-scores, k - 1)[:k] if k < len(self) else \
            np.arange(len(self))
        top = top[np.argsort(-scores[top])]
        return [(int(i), float(scores[i])) for i in top]

    def search_with_threshold(self, query_embedding, limit: int,
                              min_similarity: float) -> list[tuple[int, float]]:
        return [(i, s) for i, s in self.search(query_embedding, limit)
                if s >= min_similarity]

    # serialization ---------------------------------------------------------
    def to_dict(self) -> dict:
        return {"embeddings": self._matrix.tolist(), "dimension": self.dimension}

    @classmethod
    def from_dict(cls, d: dict, device=None) -> "VectorStore":
        return cls(d["embeddings"], d.get("dimension", 0), device=device)
