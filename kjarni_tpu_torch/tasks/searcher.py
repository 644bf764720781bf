"""Searcher task API: semantic / keyword / hybrid search + optional rerank.

Rebuild of kjarni/src/searcher (model.rs:8, search_with_options :96). Port of
kjarni_tpu/tasks/searcher.py: the Embedder, the Reranker and the index
readers' vector scoring run on `device` (None: the card).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

from ..rag.index import IndexReader, MetadataFilter
from ..search.types import SearchMode, SearchResult
from .common import Device
from .embedder import Embedder
from .reranker import Reranker


@dataclasses.dataclass
class SearchOptions:
    mode: SearchMode = SearchMode.HYBRID
    top_k: int = 10
    rerank: bool = False
    min_score: Optional[float] = None
    filter: Optional[MetadataFilter] = None


class Searcher:
    """Index search task (cf. searcher/model.rs:8).

    `device=None` means the CUDA card and raises when there is none; pass
    `device="cpu"` to run on the CPU.
    """

    def __init__(self, model: str = "minilm-l6-v2", *,
                 reranker_model: Optional[str] = None,
                 device: Device | str | None = None,
                 cache_dir: Optional[Path] = None,
                 offline: bool = False,
                 quiet: bool = False):
        self.device = Device.resolve(device)
        self.embedder = Embedder(model, device=device, cache_dir=cache_dir,
                                 offline=offline, quiet=quiet)
        self.reranker = (Reranker(reranker_model, device=device,
                                  cache_dir=cache_dir, offline=offline,
                                  quiet=quiet)
                         if reranker_model else None)
        self._readers: dict[str, IndexReader] = {}

    def _reader(self, index_path: str | Path) -> IndexReader:
        key = str(Path(index_path).resolve())
        r = self._readers.get(key)
        if r is None:
            r = IndexReader.open(Path(index_path), self.device.torch_name)
            self._readers[key] = r
        return r

    def search(self, index_path: str | Path, query: str,
               mode: SearchMode | str = SearchMode.HYBRID,
               top_k: int = 10) -> list[SearchResult]:
        return self.search_with_options(
            index_path, query,
            SearchOptions(mode=SearchMode.parse(mode) if isinstance(mode, str)
                          else mode, top_k=top_k,
                          rerank=self.reranker is not None))

    def search_with_options(self, index_path: str | Path, query: str,
                            options: SearchOptions) -> list[SearchResult]:
        reader = self._reader(index_path)
        mode = options.mode
        limit = options.top_k

        if mode == SearchMode.KEYWORD:
            results = reader.search_keywords(query, limit, options.filter)
        else:
            q_emb = self.embedder.embed(query)
            if mode == SearchMode.SEMANTIC:
                results = reader.search_semantic(q_emb, limit, options.filter)
            else:
                results = reader.search_hybrid(query, q_emb, limit, options.filter)

        if options.rerank and self.reranker is not None and results:
            scores = self.reranker.score_pairs([(query, r.text) for r in results])
            for r, s in zip(results, scores):
                r.score = s
            results.sort(key=lambda r: -r.score)

        if options.min_score is not None:
            results = [r for r in results if r.score >= options.min_score]
        return results[:limit]
