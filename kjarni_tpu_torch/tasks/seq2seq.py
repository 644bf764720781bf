"""Shared Seq2Seq generator task plumbing (port of kjarni_tpu/tasks/seq2seq.py;
cf. kjarni/src/seq2seq/model.rs)."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

from ..models.decoder_lm import resolve_device
from ..models.seq2seq_lm import Seq2SeqLM
from ..registry import ModelTask
from .common import Device, DownloadPolicy, resolve_model_dir

_SEQ2SEQ_TASKS = (ModelTask.SEQ2SEQ, ModelTask.SUMMARIZATION,
                  ModelTask.TRANSLATION, ModelTask.TEXT_TO_TEXT)


@dataclasses.dataclass
class Seq2SeqOverrides:
    """Per-call generation overrides (cf. seq2seq Seq2SeqOverrides)."""

    num_beams: Optional[int] = None
    max_length: Optional[int] = None
    min_length: Optional[int] = None
    length_penalty: Optional[float] = None
    no_repeat_ngram_size: Optional[int] = None
    early_stopping: Optional[bool] = None

    def kwargs(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items() if v is not None}


class Seq2SeqGenerator:
    """Registry-resolved seq2seq model + beam generation.

    `device=None` means the CUDA card and raises when there is none; pass
    `device="cpu"` to run on the CPU.
    """

    def __init__(self, model: str, *,
                 device: Device | str | None = None,
                 cache_dir: Optional[Path] = None,
                 offline: bool = False,
                 quiet: bool = False,
                 task_name: str = "seq2seq"):
        self.device = Device.resolve(device)
        resolve_device(self.device.torch_name)   # no card: raise before any download
        policy = DownloadPolicy.OFFLINE if offline else DownloadPolicy.ALLOW
        model_dir, info = resolve_model_dir(
            model, cache_dir, policy, quiet, _SEQ2SEQ_TASKS, task_name)
        self.model_info = info
        self.model_id = info.cli_name if info else str(model)
        self.lm = Seq2SeqLM(model_dir, device=self.device.torch_name)

    @property
    def is_t5(self) -> bool:
        return self.lm.config.arch == "t5"

    def generate(self, text: str, *, task: Optional[str] = None,
                 overrides: Optional[Seq2SeqOverrides] = None,
                 stream_callback=None) -> str:
        kw = overrides.kwargs() if overrides else {}
        return self.lm.generate(text, task=task, stream_callback=stream_callback,
                                **kw)
