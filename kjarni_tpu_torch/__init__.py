"""kjarni-tpu's PyTorch and CUDA port, for one NVIDIA H100.

The JAX package `kjarni_tpu` is the reference; this package computes the same
functions in PyTorch, with hand-written Hopper kernels where the JAX package
had Pallas kernels (`ops/kernels/`, sources in `csrc/`). It imports torch and
numpy, never jax, and nothing of `kjarni_tpu`. Entry points run on the card
unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"

from .core.errors import KjarniError  # noqa: F401
from .core.metadata import Device  # noqa: F401


def __getattr__(name):
    # lazy, so that `import kjarni_tpu_torch` does not import torch
    if name == "Generator":
        from .tasks.generator import Generator
        return Generator
    if name in ("Chat", "chat_send"):
        from .tasks import chat
        return getattr(chat, name)
    if name == "Embedder":
        from .tasks.embedder import Embedder
        return Embedder
    if name == "Classifier":
        from .tasks.classifier import Classifier
        return Classifier
    if name == "Reranker":
        from .tasks.reranker import Reranker
        return Reranker
    if name == "Indexer":
        from .tasks.indexer import Indexer
        return Indexer
    if name == "Searcher":
        from .tasks.searcher import Searcher
        return Searcher
    if name in _TASKS:
        from . import tasks
        return getattr(tasks, name)
    raise AttributeError(f"module 'kjarni_tpu_torch' has no attribute '{name}'")


_TASKS = ("Summarizer", "Translator", "Seq2SeqGenerator", "Seq2SeqOverrides",
          "Transcriber", "TranscriptionResult")

__all__ = ["Generator", "Chat", "chat_send", "Embedder", "Classifier", "Reranker",
           "Indexer", "Searcher", *_TASKS, "Device", "KjarniError"]
