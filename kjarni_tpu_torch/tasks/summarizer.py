"""Summarizer task API (port of kjarni_tpu/tasks/summarizer.py; cf.
kjarni/src/summarizer/model.rs:15,76)."""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from .common import Device
from .seq2seq import Seq2SeqGenerator, Seq2SeqOverrides


class Summarizer:
    """`device=None` means the CUDA card and raises when there is none; pass
    `device="cpu"` to run on the CPU."""

    def __init__(self, model: str = "distilbart-cnn", *,
                 device: Device | str | None = None,
                 cache_dir: Optional[Path] = None,
                 offline: bool = False,
                 quiet: bool = False):
        self._gen = Seq2SeqGenerator(model, device=device, cache_dir=cache_dir,
                                     offline=offline, quiet=quiet,
                                     task_name="summarization")
        # T5 needs a "summarize: " prefix; BART does not (model.rs:110)
        self._needs_prefix = self._gen.is_t5

    @property
    def model_id(self) -> str:
        return self._gen.model_id

    def _format(self, text: str) -> str:
        return f"summarize: {text}" if self._needs_prefix else text

    def summarize(self, text: str,
                  overrides: Optional[Seq2SeqOverrides] = None) -> str:
        return self._gen.generate(self._format(text), task="summarization",
                                  overrides=overrides)

    def stream(self, text: str, overrides: Optional[Seq2SeqOverrides] = None):
        """Yield decoded text pieces as the best beam advances."""
        tokens: list[int] = []
        emitted = [""]
        out: list[str] = []

        def cb(tok: int):
            tokens.append(tok)
            text_now = self._gen.lm.tokenizer.decode(tokens)
            delta = text_now[len(emitted[0]):]
            if delta and not text_now.endswith("�"):
                emitted[0] = text_now
                out.append(delta)

        final = self._gen.generate(self._format(text), task="summarization",
                                   overrides=overrides, stream_callback=cb)
        # stream deltas first, then reconcile with the final beam result
        yield from out
        if final != emitted[0]:
            yield final[len(emitted[0]):] if final.startswith(emitted[0]) else final
