"""Document loading + chunking, cf. kjarni-rag/src/loader.rs (a copy of
kjarni_tpu/rag/loader.py)."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence

from ..search.types import Chunk, ChunkMetadata
from .splitter import SplitterConfig, TextSplitter

TEXT_EXTENSIONS = (
    # documents
    "txt", "md", "markdown", "rst", "org",
    # data
    "json", "yaml", "yml", "toml", "xml", "csv",
    # web
    "html", "htm", "css",
    # code
    "rs", "py", "js", "ts", "go", "java", "c", "cpp", "h", "hpp",
    "cs", "rb", "sh", "bash", "zsh", "fish", "ps1",
    "sql", "r", "scala", "kt", "swift", "m", "mm",
    "lua", "pl", "php", "ex", "exs", "clj", "hs",
)


@dataclasses.dataclass
class LoaderConfig:
    splitter: SplitterConfig = dataclasses.field(default_factory=SplitterConfig)
    recursive: bool = True
    extensions: list[str] = dataclasses.field(default_factory=list)
    exclude_patterns: list[str] = dataclasses.field(default_factory=list)
    include_hidden: bool = False


class DocumentLoader:
    def __init__(self, config: Optional[LoaderConfig] = None):
        self.config = config or LoaderConfig()
        self.splitter = TextSplitter(self.config.splitter)

    def is_supported_extension(self, path: Path) -> bool:
        ext = path.suffix.lstrip(".").lower()
        if not ext:
            return False
        if self.config.extensions:
            return ext in self.config.extensions
        return ext in TEXT_EXTENSIONS

    def _excluded(self, path: Path) -> bool:
        s = str(path)
        if not self.config.include_hidden and any(
                part.startswith(".") for part in path.parts):
            return True
        return any(pat in s for pat in self.config.exclude_patterns)

    def load_file(self, path: Path) -> list[Chunk]:
        path = Path(path)
        content = path.read_text(errors="replace")
        texts = self.splitter.split(content)
        total = len(texts)
        return [
            Chunk(text=t, metadata=ChunkMetadata(
                source=str(path), chunk_index=i, total_chunks=total))
            for i, t in enumerate(texts)
        ]

    def load_directory(self, directory: Path) -> list[Chunk]:
        directory = Path(directory)
        chunks: list[Chunk] = []
        it = directory.rglob("*") if self.config.recursive else directory.glob("*")
        for p in sorted(it):
            if not p.is_file() or self._excluded(p.relative_to(directory)):
                continue
            if not self.is_supported_extension(p):
                continue
            try:
                chunks.extend(self.load_file(p))
            except OSError:
                continue
        return chunks

    def load_paths(self, paths: Sequence[Path]) -> list[Chunk]:
        chunks: list[Chunk] = []
        for p in paths:
            p = Path(p)
            if p.is_dir():
                chunks.extend(self.load_directory(p))
            elif p.is_file():
                chunks.extend(self.load_file(p))
        return chunks


def load_documents(paths: Sequence[str],
                   config: Optional[LoaderConfig] = None) -> list[Chunk]:
    return DocumentLoader(config).load_paths([Path(p) for p in paths])
