"""Text splitter for document chunking, cf. kjarni-rag/src/splitter.rs (a copy
of kjarni_tpu/rag/splitter.py)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SplitterConfig:
    chunk_size: int = 1000
    chunk_overlap: int = 200
    separator: str = "\n\n"

    @staticmethod
    def with_chunk_size(chunk_size: int) -> "SplitterConfig":
        return SplitterConfig(chunk_size=chunk_size, chunk_overlap=chunk_size // 5)

    def validate(self) -> None:
        if self.chunk_size <= 0:
            raise ValueError("chunk_size must be greater than 0")
        if self.chunk_overlap >= self.chunk_size:
            raise ValueError("chunk_overlap must be less than chunk_size")


class TextSplitter:
    """Separator-based chunking with overlap (splitter.rs:69 split)."""

    def __init__(self, config: SplitterConfig | None = None):
        self.config = config or SplitterConfig()
        self.config.validate()

    def split(self, text: str) -> list[str]:
        if not text:
            return []
        cfg = self.config
        chunks: list[str] = []
        current = ""
        for section in text.split(cfg.separator):
            if not section:
                continue
            if len(section) > cfg.chunk_size:
                if current:
                    chunks.append(current)
                    current = ""
                chunks.extend(self._split_large(section))
                continue
            would_be = len(section) if not current else \
                len(current) + len(cfg.separator) + len(section)
            if would_be > cfg.chunk_size and current:
                chunks.append(current)
                current = self._overlap_suffix(current) if cfg.chunk_overlap else ""
            if current:
                current += cfg.separator
            current += section
        if current:
            chunks.append(current)
        return chunks

    def split_with_metadata(self, text: str,
                            base_metadata: dict[str, str]) -> list[tuple[str, dict]]:
        chunks = self.split(text)
        out = []
        for i, c in enumerate(chunks):
            md = dict(base_metadata)
            md["chunk_index"] = str(i)
            md["total_chunks"] = str(len(chunks))
            out.append((c, md))
        return out

    def _overlap_suffix(self, text: str) -> str:
        if len(text) <= self.config.chunk_overlap:
            return text
        return text[len(text) - self.config.chunk_overlap:]

    def _split_large(self, text: str) -> list[str]:
        cfg = self.config
        chunks = []
        step = (cfg.chunk_size - cfg.chunk_overlap
                if 0 < cfg.chunk_overlap < cfg.chunk_size else cfg.chunk_size)
        start = 0
        while start < len(text):
            end = min(start + cfg.chunk_size, len(text))
            chunks.append(text[start:end])
            if end >= len(text):
                break
            start += max(step, 1)
        return chunks
