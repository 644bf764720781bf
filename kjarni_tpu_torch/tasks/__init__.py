"""The task APIs. The encoder-decoder tasks are exported here lazily, so that
importing the package imports no torch."""

_EXPORTS = {
    "Seq2SeqGenerator": "seq2seq", "Seq2SeqOverrides": "seq2seq",
    "Summarizer": "summarizer", "Translator": "translator",
    "Transcriber": "transcriber", "TranscriptionResult": "transcriber",
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(f"module 'kjarni_tpu_torch.tasks' has no attribute '{name}'")


__all__ = list(_EXPORTS)
