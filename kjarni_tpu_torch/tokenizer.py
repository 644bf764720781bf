"""Tokenizer wrapper over HF `tokenizers` with bucketed padding.

Copy of kjarni_tpu/tokenizer.py. `tokenizers` is imported inside
`from_file`, so importing the port needs only torch and numpy.
"""

from __future__ import annotations

from pathlib import Path
from typing import Literal, Sequence

import numpy as np

from .core.bucketing import batch_bucket, seq_bucket
from .core.errors import TokenizationError


class KjarniTokenizer:
    def __init__(self, tokenizer, pad_token_id: int = 0):
        self.tk = tokenizer
        self.pad_token_id = pad_token_id

    @classmethod
    def from_file(cls, path: Path, pad_token_id: int = 0) -> "KjarniTokenizer":
        path = Path(path)
        if not path.exists():
            raise TokenizationError(f"tokenizer file not found: {path}")
        from tokenizers import Tokenizer
        return cls(Tokenizer.from_file(str(path)), pad_token_id)

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        return self.tk.encode(text, add_special_tokens=add_special_tokens).ids

    def encode_pair(self, a: str, b: str) -> list[int]:
        return self.tk.encode(a, b).ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self.tk.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def token_to_id(self, token: str) -> int | None:
        return self.tk.token_to_id(token)

    def encode_batch(
        self,
        texts: Sequence[str],
        *,
        pairs: Sequence[str] | None = None,
        max_len: int | None = None,
        padding: Literal["left", "right"] = "right",
        bucket: bool = True,
        pad_batch: bool = False,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Tokenize + pad to a static bucket. Returns (input_ids, attention_mask).

        `padding="left"` is used for decoder batches (models/base.rs:289);
        encoders pad right. With `bucket=True` the target length is the seq
        bucket of the longest sequence (truncated to max_len).
        """
        if pairs is not None:
            encs = self.tk.encode_batch(list(zip(texts, pairs)))
        else:
            encs = self.tk.encode_batch(list(texts))
        id_lists = [e.ids for e in encs]
        if max_len is not None:
            id_lists = [ids[:max_len] for ids in id_lists]
        longest = max((len(ids) for ids in id_lists), default=1)
        longest = max(longest, 1)
        target = seq_bucket(longest, max_len) if bucket else longest

        n = len(id_lists)
        rows = batch_bucket(n) if pad_batch else n
        input_ids = np.full((rows, target), self.pad_token_id, dtype=np.int32)
        mask = np.zeros((rows, target), dtype=np.int32)
        for i, ids in enumerate(id_lists):
            L = len(ids)
            if padding == "right":
                input_ids[i, :L] = ids
                mask[i, :L] = 1
            else:
                input_ids[i, target - L:] = ids
                mask[i, target - L:] = 1
        return input_ids, mask
