"""Streamed token types + incremental detokenization.

Cf. kjarni-transformers/src/common/stream.rs:3-14. The reference decodes each
token id alone (generator.rs:352); we decode the accumulated ids and emit the
delta so BPE byte-merge boundaries produce clean UTF-8.
"""

from __future__ import annotations

import dataclasses
import enum


class TokenType(str, enum.Enum):
    PROMPT = "prompt"
    GENERATED = "generated"


@dataclasses.dataclass
class StreamedToken:
    text: str
    id: int
    token_type: TokenType = TokenType.GENERATED


class StreamDecoder:
    """Incremental decoder: holds generated ids, emits text deltas."""

    def __init__(self, tokenizer, skip_special_tokens: bool = True):
        self.tokenizer = tokenizer
        self.skip_special = skip_special_tokens
        self.ids: list[int] = []
        self._emitted = ""

    def push(self, token_id: int) -> str:
        self.ids.append(token_id)
        text = self.tokenizer.decode(self.ids, skip_special_tokens=self.skip_special)
        # hold back while the tail is an incomplete UTF-8 sequence
        if text.endswith("�"):
            return ""
        delta = text[len(self._emitted):]
        self._emitted = text
        return delta

    @property
    def text(self) -> str:
        return self._emitted
