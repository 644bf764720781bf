"""Indexer task API: files -> chunks -> embeddings -> segmented index.

Rebuild of kjarni/src/indexer (model.rs:13, create_internal :168-297, add :464,
create_with_callback :303): walk paths, load + split documents, embed in
batches, write segments, commit — with progress callbacks and cancellation.
Port of kjarni_tpu/tasks/indexer.py: the Embedder runs on `device`
(None: the card), and the index on disk is the JAX package's layout.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence

from ..core.cancellation import CancellationToken
from ..core.errors import CancelledError
from ..rag.index import IndexConfig, IndexWriter
from ..rag.loader import DocumentLoader, LoaderConfig
from ..rag.progress import Progress, ProgressCallback
from ..rag.splitter import SplitterConfig
from .common import Device
from .embedder import Embedder


@dataclasses.dataclass
class IndexStats:
    documents: int
    chunks: int
    bytes: int

    def __str__(self) -> str:
        kb = self.bytes / 1024
        return f"Indexed {self.documents} documents ({kb:.2f} KB)"


class Indexer:
    """Document indexing task (cf. indexer/model.rs:13).

    `device=None` means the CUDA card and raises when there is none; pass
    `device="cpu"` to run on the CPU.
    """

    def __init__(self, model: str = "minilm-l6-v2", *,
                 device: Device | str | None = None,
                 cache_dir: Optional[Path] = None,
                 chunk_size: int = 1000,
                 chunk_overlap: int = 200,
                 batch_size: int = 32,
                 quiet: bool = False,
                 offline: bool = False):
        self.embedder = Embedder(model, device=device, cache_dir=cache_dir,
                                 offline=offline, quiet=quiet)
        self.batch_size = batch_size
        self.quiet = quiet
        self.loader_config = LoaderConfig(
            splitter=SplitterConfig(chunk_size=chunk_size,
                                    chunk_overlap=chunk_overlap))

    def create(self, index_path: str | Path, paths: Sequence[str | Path], *,
               progress: Optional[ProgressCallback] = None,
               cancellation: Optional[CancellationToken] = None) -> IndexStats:
        """Build a fresh index at `index_path` from files/dirs (model.rs:168)."""
        def report(p: Progress):
            if progress is not None:
                progress(p)

        def check_cancel():
            if cancellation is not None and cancellation.is_cancelled:
                raise CancelledError("indexing cancelled")

        loader = DocumentLoader(self.loader_config)
        report(Progress.scanning(0))
        chunks = loader.load_paths([Path(p) for p in paths])
        check_cancel()
        report(Progress.loading(len(chunks), len(chunks)))

        writer = IndexWriter.open(Path(index_path), IndexConfig(
            dimension=self.embedder.dim, model=self.embedder.model_id))
        sources = set()
        total_bytes = 0
        for i in range(0, len(chunks), self.batch_size):
            check_cancel()
            batch = chunks[i:i + self.batch_size]
            embs = self.embedder.embed_batch([c.text for c in batch])
            writer.add_batch([c.text for c in batch], embs,
                             [c.metadata.to_dict() for c in batch])
            for c in batch:
                if c.metadata.source:
                    sources.add(c.metadata.source)
                total_bytes += len(c.text.encode())
            report(Progress.embedding(min(i + self.batch_size, len(chunks)),
                                      len(chunks)))
        report(Progress.committing())
        writer.commit()
        stats = IndexStats(documents=len(sources), chunks=len(chunks),
                           bytes=total_bytes)
        if not self.quiet:
            print(f"✓ {stats}")
        return stats

    def add(self, index_path: str | Path, paths: Sequence[str | Path], *,
            progress: Optional[ProgressCallback] = None,
            cancellation: Optional[CancellationToken] = None) -> IndexStats:
        """Incrementally add documents: re-read existing index, merge, rewrite.

        The reference appends segments (index_writer.rs open_existing); the
        segmented layout here supports the same append by writing new segments
        and extending the manifest.
        """
        from ..rag.index import MANIFEST
        import json
        index_path = Path(index_path)
        if not (index_path / MANIFEST).exists():
            return self.create(index_path, paths, progress=progress,
                               cancellation=cancellation)

        manifest = json.loads((index_path / MANIFEST).read_text())
        loader = DocumentLoader(self.loader_config)
        chunks = loader.load_paths([Path(p) for p in paths])

        writer = IndexWriter.open(index_path, IndexConfig(
            dimension=manifest["dimension"], model=manifest.get("model", "")))
        # offset new segment ids past the existing ones
        writer._segments = []
        base = len(manifest["segments"])
        total_bytes = 0
        sources = set()
        for i in range(0, len(chunks), self.batch_size):
            if cancellation is not None and cancellation.is_cancelled:
                raise CancelledError("indexing cancelled")
            batch = chunks[i:i + self.batch_size]
            embs = self.embedder.embed_batch([c.text for c in batch])
            writer.add_batch([c.text for c in batch], embs,
                             [c.metadata.to_dict() for c in batch])
            for c in batch:
                if c.metadata.source:
                    sources.add(c.metadata.source)
                total_bytes += len(c.text.encode())
        writer._flush_segment()
        # renumber the new segments after the existing ones
        import shutil
        for j, seg in enumerate(writer._segments):
            new_id = f"segment_{base + j:06d}"
            shutil.move(str(writer._tmp / seg["id"]), str(index_path / new_id))
            seg["id"] = new_id
        manifest["segments"].extend(writer._segments)
        manifest["total_docs"] += sum(s["num_docs"] for s in writer._segments)
        (index_path / MANIFEST).write_text(json.dumps(manifest, indent=2))
        shutil.rmtree(writer._tmp, ignore_errors=True)
        writer._committed = True
        return IndexStats(documents=len(sources), chunks=len(chunks),
                          bytes=total_bytes)
