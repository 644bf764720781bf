"""Segmented on-disk search index: IndexWriter / IndexReader / MetadataFilter.

Rebuild of kjarni-rag/src/{index_writer,index_reader,segment}.rs. The reference
flushes bincode segments; this rebuild uses a documented layout per segment —
`embeddings.npy` (float32 [n, dim]) + `docs.json` + `meta.json` + `bm25.json` —
under a root `manifest.json`. Commit is atomic: segments build in a temp dir
and the manifest is replaced last (index_writer.rs:152 commit()).

Port of kjarni_tpu/rag/index.py with the same on-disk layout, so an index
written by either package reads in the other. A reader scores each segment
with its own VectorStore on the reader's device (`device=None`: the card):
a segment of 4,096 rows or more on the device, a smaller one in numpy.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import shutil
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..core.errors import IndexError_
from ..core.placement import resolve_device
from ..search.bm25 import Bm25Index
from ..search.hybrid import hybrid_search
from ..search.types import SearchResult
from ..search.vector import VectorStore

MANIFEST = "manifest.json"
DEFAULT_SEGMENT_SIZE = 10_000


@dataclasses.dataclass
class IndexConfig:
    dimension: int = 0
    model: str = ""
    max_docs_per_segment: int = DEFAULT_SEGMENT_SIZE


class MetadataFilter:
    """Cf. index_reader.rs:15 — source glob + must/must_not key-value terms."""

    def __init__(self):
        self._source_pattern: Optional[str] = None
        self._must: list[tuple[str, str]] = []
        self._must_not: list[tuple[str, str]] = []

    def source(self, pattern: str) -> "MetadataFilter":
        self._source_pattern = pattern
        return self

    def must(self, key: str, value: str) -> "MetadataFilter":
        self._must.append((key, value))
        return self

    def must_not(self, key: str, value: str) -> "MetadataFilter":
        self._must_not.append((key, value))
        return self

    def matches(self, metadata: dict[str, str]) -> bool:
        if self._source_pattern is not None:
            src = metadata.get("source", "")
            if not (fnmatch.fnmatch(src, self._source_pattern)
                    or self._source_pattern in src):
                return False
        for k, v in self._must:
            if metadata.get(k) != v:
                return False
        for k, v in self._must_not:
            if metadata.get(k) == v:
                return False
        return True


class _Segment:
    """One immutable on-disk segment (cf. segment.rs:195)."""

    def __init__(self, path: Path, device=None):
        self.path = Path(path)
        self.device = device
        self.embeddings = np.load(self.path / "embeddings.npy", mmap_mode="r")
        self.docs: list[str] = json.loads((self.path / "docs.json").read_text())
        self.meta: list[dict] = json.loads((self.path / "meta.json").read_text())
        self.bm25 = Bm25Index.from_dict(
            json.loads((self.path / "bm25.json").read_text()))
        self._store: Optional[VectorStore] = None

    def __len__(self) -> int:
        return len(self.docs)

    @property
    def store(self) -> VectorStore:
        if self._store is None:
            self._store = VectorStore(np.asarray(self.embeddings, dtype=np.float32),
                                      device=self.device)
        return self._store

    def search_vectors(self, query, limit: int) -> list[tuple[int, float]]:
        return self.store.search(query, limit)

    def search_keywords(self, query: str, limit: int) -> list[tuple[int, float]]:
        return self.bm25.search(query, limit)


class _SegmentBuilder:
    """Accumulates docs, flushes one segment dir (cf. segment.rs:22)."""

    def __init__(self, dimension: int, max_docs: int):
        self.dimension = dimension
        self.max_docs = max_docs
        self.embeddings: list[np.ndarray] = []
        self.docs: list[str] = []
        self.meta: list[dict] = []
        self.bm25 = Bm25Index()

    def add(self, text: str, embedding: np.ndarray, metadata: dict) -> None:
        emb = np.asarray(embedding, dtype=np.float32)
        if self.dimension and emb.shape[0] != self.dimension:
            raise IndexError_(
                f"embedding dim {emb.shape[0]} != index dim {self.dimension}")
        doc_id = len(self.docs)
        self.embeddings.append(emb)
        self.docs.append(text)
        self.meta.append(dict(metadata))
        self.bm25.add_document(doc_id, text)

    @property
    def is_full(self) -> bool:
        return len(self.docs) >= self.max_docs

    def __len__(self) -> int:
        return len(self.docs)

    def flush(self, segment_dir: Path) -> dict:
        segment_dir.mkdir(parents=True, exist_ok=True)
        mat = (np.stack(self.embeddings) if self.embeddings
               else np.zeros((0, self.dimension), dtype=np.float32))
        np.save(segment_dir / "embeddings.npy", mat)
        (segment_dir / "docs.json").write_text(json.dumps(self.docs))
        (segment_dir / "meta.json").write_text(json.dumps(self.meta))
        (segment_dir / "bm25.json").write_text(json.dumps(self.bm25.to_dict()))
        return {"id": segment_dir.name, "num_docs": len(self.docs)}


class IndexWriter:
    """Cf. index_writer.rs:12: open/add/commit with atomic manifest swap."""

    def __init__(self, root: Path, config: IndexConfig):
        self.root = Path(root)
        self.config = config
        self._tmp = Path(tempfile.mkdtemp(prefix="kjarni-index-"))
        self._segments: list[dict] = []
        self._builder = _SegmentBuilder(config.dimension, config.max_docs_per_segment)
        self._committed = False

    @classmethod
    def open(cls, root: Path, config: Optional[IndexConfig] = None) -> "IndexWriter":
        return cls(root, config or IndexConfig())

    def add(self, text: str, embedding, metadata: Optional[dict] = None) -> None:
        emb = np.asarray(embedding, dtype=np.float32)
        if self._builder.dimension == 0:
            self._builder.dimension = emb.shape[0]
            self.config.dimension = emb.shape[0]
        self._builder.add(text, emb, metadata or {})
        if self._builder.is_full:
            self._flush_segment()

    def add_batch(self, texts: Sequence[str], embeddings,
                  metadatas: Optional[Sequence[dict]] = None) -> None:
        embeddings = np.asarray(embeddings, dtype=np.float32)
        for i, text in enumerate(texts):
            md = metadatas[i] if metadatas is not None else {}
            self.add(text, embeddings[i], md)

    def _flush_segment(self) -> None:
        if len(self._builder) == 0:
            return
        seg_id = f"segment_{len(self._segments):06d}"
        meta = self._builder.flush(self._tmp / seg_id)
        self._segments.append(meta)
        self._builder = _SegmentBuilder(self.config.dimension,
                                        self.config.max_docs_per_segment)

    def __len__(self) -> int:
        return sum(s["num_docs"] for s in self._segments) + len(self._builder)

    @property
    def dimension(self) -> int:
        return self.config.dimension

    def commit(self) -> None:
        """Finalize: flush remaining docs, move segments, write manifest last."""
        if self._committed:
            raise IndexError_("IndexWriter already committed")
        self._flush_segment()
        self.root.mkdir(parents=True, exist_ok=True)
        for seg in self._segments:
            dest = self.root / seg["id"]
            if dest.exists():
                shutil.rmtree(dest)
            shutil.move(str(self._tmp / seg["id"]), str(dest))
        manifest = {
            "version": 1,
            "dimension": self.config.dimension,
            "model": self.config.model,
            "total_docs": sum(s["num_docs"] for s in self._segments),
            "segments": self._segments,
        }
        tmp_manifest = self.root / (MANIFEST + ".tmp")
        tmp_manifest.write_text(json.dumps(manifest, indent=2))
        tmp_manifest.replace(self.root / MANIFEST)
        shutil.rmtree(self._tmp, ignore_errors=True)
        self._committed = True


class IndexReader:
    """Cf. index_reader.rs:104: merges per-segment results, metadata filters.

    `device=None` means the CUDA card and raises when there is none; pass
    `device="cpu"` to score on the CPU."""

    def __init__(self, root: Path, device=None):
        self.root = Path(root)
        self.device = resolve_device(device)
        manifest_path = self.root / MANIFEST
        if not manifest_path.exists():
            raise IndexError_(f"no index manifest found at {manifest_path}")
        self.manifest = json.loads(manifest_path.read_text())
        self.segments = [_Segment(self.root / s["id"], self.device)
                         for s in self.manifest["segments"]]
        self._offsets: list[int] = []
        off = 0
        for seg in self.segments:
            self._offsets.append(off)
            off += len(seg)
        self._total = off

    @classmethod
    def open(cls, root: Path, device=None) -> "IndexReader":
        return cls(root, device)

    def __len__(self) -> int:
        return self._total

    @property
    def dimension(self) -> int:
        return self.manifest["dimension"]

    @property
    def model(self) -> str:
        return self.manifest.get("model", "")

    def segment_count(self) -> int:
        return len(self.segments)

    def _global_id(self, seg_idx: int, local_id: int) -> int:
        return self._offsets[seg_idx] + local_id

    def _local(self, global_id: int) -> tuple[int, int]:
        for i in reversed(range(len(self._offsets))):
            if global_id >= self._offsets[i]:
                return i, global_id - self._offsets[i]
        raise IndexError_(f"document id {global_id} out of range")

    def get_document(self, global_id: int) -> str:
        seg, local = self._local(global_id)
        return self.segments[seg].docs[local]

    def get_metadata(self, global_id: int) -> dict:
        seg, local = self._local(global_id)
        return self.segments[seg].meta[local]

    def _to_results(self, scored: list[tuple[int, float]],
                    filter: Optional[MetadataFilter] = None,
                    limit: Optional[int] = None) -> list[SearchResult]:
        out = []
        for gid, score in scored:
            md = self.get_metadata(gid)
            if filter is not None and not filter.matches(md):
                continue
            out.append(SearchResult(score=score, document_id=gid,
                                    text=self.get_document(gid), metadata=md))
            if limit is not None and len(out) >= limit:
                break
        return out

    def _search_semantic_ids(self, query_embedding, limit: int):
        scored: list[tuple[int, float]] = []
        for i, seg in enumerate(self.segments):
            for local, score in seg.search_vectors(query_embedding, limit):
                scored.append((self._global_id(i, local), score))
        scored.sort(key=lambda t: -t[1])
        return scored[:limit]

    def _search_keyword_ids(self, query: str, limit: int):
        scored: list[tuple[int, float]] = []
        for i, seg in enumerate(self.segments):
            for local, score in seg.search_keywords(query, limit):
                scored.append((self._global_id(i, local), score))
        scored.sort(key=lambda t: -t[1])
        return scored[:limit]

    def search_semantic(self, query_embedding, limit: int,
                        filter: Optional[MetadataFilter] = None
                        ) -> list[SearchResult]:
        over = limit * 4 if filter is not None else limit
        return self._to_results(self._search_semantic_ids(query_embedding, over),
                                filter, limit)

    def search_keywords(self, query: str, limit: int,
                        filter: Optional[MetadataFilter] = None
                        ) -> list[SearchResult]:
        over = limit * 4 if filter is not None else limit
        return self._to_results(self._search_keyword_ids(query, over),
                                filter, limit)

    def search_hybrid(self, query: str, query_embedding, limit: int,
                      filter: Optional[MetadataFilter] = None
                      ) -> list[SearchResult]:
        kw = self._search_keyword_ids(query, limit * 2)
        sem = self._search_semantic_ids(query_embedding, limit * 2)
        fused = hybrid_search(kw, sem, limit * 4 if filter else limit)
        return self._to_results(fused, filter, limit)
