"""Cooperative cancellation, mirroring common/cancellation.rs:8 in the reference."""

from __future__ import annotations

import threading


class CancellationToken:
    """Thread-safe cancel flag checked between decode steps (cf. generator.rs:313)."""

    def __init__(self) -> None:
        self._event = threading.Event()

    def cancel(self) -> None:
        self._event.set()

    @property
    def is_cancelled(self) -> bool:
        return self._event.is_set()

    def cancel_after(self, seconds: float) -> threading.Timer:
        """Schedule cancellation after a delay (cf. cancellation.rs:127)."""
        t = threading.Timer(seconds, self.cancel)
        t.daemon = True
        t.start()
        return t
