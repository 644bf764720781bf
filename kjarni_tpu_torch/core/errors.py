"""Error taxonomy for kjarni-tpu.

Mirrors the reference's typed error taxonomy (kjarni/src/common/error.rs:8) with a
Python exception hierarchy instead of a Rust enum.
"""

from __future__ import annotations


class KjarniError(Exception):
    """Base error for all kjarni-tpu failures."""


class ModelNotFoundError(KjarniError):
    """Unknown model name; carries suggestions like registry.rs:720 resolve()."""

    def __init__(self, name: str, suggestions: list[str] | None = None):
        self.name = name
        self.suggestions = suggestions or []
        if self.suggestions:
            msg = f"Unknown model '{name}'. Did you mean: {', '.join(self.suggestions)}?"
        else:
            msg = f"Unknown model '{name}'"
        super().__init__(msg)


class ModelNotDownloadedError(KjarniError):
    """Model files are missing from the cache and downloads are disabled."""


class WeightLoadError(KjarniError):
    """Failed to load or map model weights."""


class TokenizationError(KjarniError):
    """Failed to tokenize input text."""


class InvalidConfigError(KjarniError):
    """Bad model config or incompatible builder options."""


class TaskValidationError(KjarniError):
    """Model is incompatible with the requested task (cf. */validation.rs)."""


class GenerationError(KjarniError):
    """Failure during autoregressive generation."""


class AudioError(KjarniError):
    """Failed to load or process audio input."""


class IndexError_(KjarniError):
    """Failure reading or writing a search index."""


class CancelledError(KjarniError):
    """Operation was cancelled via a CancellationToken."""


class DeviceTimeoutError(KjarniError):
    """A device sync exceeded its deadline (cf. gpu_ops/timeout.rs:12
    GpuTimeoutConfig + poll_with_timeout — the reference aborts wedged GPU
    polls instead of hanging forever; we do the same for TPU syncs)."""
