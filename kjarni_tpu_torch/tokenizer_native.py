"""Byte-level BPE tokenizer (GPT-2 style), with no HF runtime.

Copy of the BPE part of kjarni_tpu/tokenizer_native.py, and of
`bpe_from_gguf_metadata`, which builds it from the vocabulary and merges a
GGUF file embeds (a GGUF-only model dir has no tokenizer.json). `regex` is
imported inside `encode`, so building a tokenizer and decoding need neither
`regex` nor `tokenizers`.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Optional, Sequence

# GPT-2 pre-tokenization pattern (bpe.rs)
_GPT2_PATTERN = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")


@lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(ord("¡"), ord("¬") + 1)) +
          list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class BPETokenizer:
    """Byte-level BPE (cf. tokenizer/bpe.rs:20)."""

    def __init__(self, vocab: dict[str, int], merges: Sequence[tuple[str, str]],
                 special_tokens: Optional[dict[str, int]] = None):
        self.vocab = dict(vocab)
        self.id_to_token = {v: k for k, v in self.vocab.items()}
        self.merge_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.special_tokens = dict(special_tokens or {})
        for tok, tid in self.special_tokens.items():
            self.id_to_token.setdefault(tid, tok)
        self._byte_encoder = bytes_to_unicode()
        self._byte_decoder = {v: k for k, v in self._byte_encoder.items()}
        self._cache: dict[str, list[str]] = {}

    @classmethod
    def from_files(cls, vocab_path: Path, merges_path: Path) -> "BPETokenizer":
        vocab = json.loads(Path(vocab_path).read_text())
        merges = []
        for line in Path(merges_path).read_text().splitlines():
            if line.startswith("#") or not line.strip():
                continue
            a, _, b = line.partition(" ")
            merges.append((a, b))
        return cls(vocab, merges)

    def _bpe(self, token: str) -> list[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.merge_ranks.get(p, 1 << 30))
            if best not in self.merge_ranks:
                break
            a, b = best
            out: list[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        self._cache[token] = word
        return word

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        import regex
        # chat templates embed special tokens as literal text (<|eot_id|> ...);
        # split them out so they map to their ids, not byte-BPE pieces
        specials = sorted(self.special_tokens, key=len, reverse=True)
        segments = ([text] if not specials else regex.split(
            "(" + "|".join(regex.escape(t) for t in specials) + ")", text))
        ids: list[int] = []
        for seg in segments:
            if not seg:
                continue
            if seg in self.special_tokens:
                ids.append(self.special_tokens[seg])
                continue
            for piece in regex.findall(_GPT2_PATTERN, seg):
                mapped = "".join(self._byte_encoder[b]
                                 for b in piece.encode("utf-8"))
                for sub in self._bpe(mapped):
                    tid = self.vocab.get(sub)
                    if tid is not None:
                        ids.append(tid)
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        special_ids = set(self.special_tokens.values())
        parts = []
        for i in ids:
            if skip_special_tokens and i in special_ids:
                continue
            tok = self.id_to_token.get(int(i))
            if tok is not None:
                parts.append(tok)
        text = "".join(parts)
        data = bytes(self._byte_decoder.get(c, ord(" ")) for c in text)
        return data.decode("utf-8", errors="replace")

    def token_to_id(self, token: str) -> Optional[int]:
        tid = self.special_tokens.get(token)
        return tid if tid is not None else self.vocab.get(token)


def bpe_from_gguf_metadata(metadata: dict) -> Optional[BPETokenizer]:
    """A BPE tokenizer from GGUF tokenizer.ggml.* metadata, or None when the
    file embeds no vocabulary and merges."""
    tokens = metadata.get("tokenizer.ggml.tokens")
    merges = metadata.get("tokenizer.ggml.merges")
    if not tokens or merges is None:
        return None
    vocab = {t: i for i, t in enumerate(tokens)}
    merge_pairs = []
    for m in merges:
        a, _, b = m.partition(" ")
        merge_pairs.append((a, b))
    specials = {}
    for key in ("tokenizer.ggml.bos_token_id", "tokenizer.ggml.eos_token_id"):
        tid = metadata.get(key)
        if tid is not None and tid < len(tokens):
            specials[tokens[tid]] = tid
    # control tokens (token_type 3 in ggml, or <|...|> shaped) act as specials
    types = metadata.get("tokenizer.ggml.token_type")
    if types:
        for i, t in enumerate(types):
            if t == 3 and i < len(tokens):
                specials[tokens[i]] = i
    else:
        for i, tok in enumerate(tokens):
            if tok.startswith("<|") and tok.endswith("|>"):
                specials[tok] = i
    return BPETokenizer(vocab, merge_pairs, specials)
