"""Generation statistics (prefill/decode token counters + TPS).

Mirrors the reference GenerationStats (kjarni-transformers/src/stats.rs:11): a
globally togglable counter printed after generation.
"""

from __future__ import annotations

import dataclasses
import time

_ENABLED = False


def enable_stats(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def stats_enabled() -> bool:
    return _ENABLED


@dataclasses.dataclass
class GenerationStats:
    prompt_tokens: int = 0
    generated_tokens: int = 0
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    _t0: float = dataclasses.field(default=0.0, repr=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def mark_prefill(self, n_tokens: int) -> None:
        now = time.perf_counter()
        self.prefill_seconds = now - self._t0
        self.prompt_tokens = n_tokens
        self._t0 = now

    def mark_decode_done(self, n_tokens: int) -> None:
        self.decode_seconds = time.perf_counter() - self._t0
        self.generated_tokens = n_tokens

    @property
    def prefill_tps(self) -> float:
        return self.prompt_tokens / self.prefill_seconds if self.prefill_seconds > 0 else 0.0

    @property
    def decode_tps(self) -> float:
        return self.generated_tokens / self.decode_seconds if self.decode_seconds > 0 else 0.0

    def print_summary(self) -> None:
        if not _ENABLED:
            return
        print(
            f"[kjarni] prefill: {self.prompt_tokens} tok in {self.prefill_seconds:.3f}s "
            f"({self.prefill_tps:.1f} tok/s) | decode: {self.generated_tokens} tok in "
            f"{self.decode_seconds:.3f}s ({self.decode_tps:.1f} tok/s)"
        )
