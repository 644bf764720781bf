"""Transcriber task API (port of kjarni_tpu/tasks/transcriber.py; cf.
kjarni/src/transcriber/model.rs:22 -- transcribe_file :76, stream_file :182)."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ..audio.loader import AudioLoaderConfig, load_audio_bytes, load_audio_for_whisper
from ..models.decoder_lm import resolve_device
from ..models.whisper_transcriber import (CHUNK_LENGTH_SECS, WhisperModel,
                                          WhisperSegment, WhisperTask,
                                          WhisperTranscriberConfig, audio_pcm16)
from ..registry import ModelTask
from .common import Device, DownloadPolicy, resolve_model_dir

_TRANSCRIBER_TASKS = (ModelTask.SPEECH_TO_TEXT,)


@dataclasses.dataclass
class TranscriptionResult:
    text: str
    segments: list[WhisperSegment]
    duration: float


class Transcriber:
    """Speech to text with Whisper.

    `device=None` means the CUDA card and raises when there is none; pass
    `device="cpu"` to run on the CPU.
    """

    def __init__(self, model: str = "whisper-small", *,
                 language: Optional[str] = None,
                 task: WhisperTask | str = WhisperTask.TRANSCRIBE,
                 timestamps: bool = False,
                 device: Device | str | None = None,
                 cache_dir: Optional[Path] = None,
                 offline: bool = False,
                 quiet: bool = False):
        self.device = Device.resolve(device)
        resolve_device(self.device.torch_name)   # no card: raise before any download
        policy = DownloadPolicy.OFFLINE if offline else DownloadPolicy.ALLOW
        model_dir, info = resolve_model_dir(
            model, cache_dir, policy, quiet, _TRANSCRIBER_TASKS, "transcription")
        self.model_info = info
        self.model_id = info.cli_name if info else str(model)
        self._model = WhisperModel(model_dir, device=self.device.torch_name)
        self.config = WhisperTranscriberConfig(
            language=language,
            task=WhisperTask(task) if isinstance(task, str) else task,
            timestamps=timestamps)

    def transcribe_file(self, path: str | Path) -> TranscriptionResult:
        audio = load_audio_for_whisper(Path(path))
        return self.transcribe_samples(audio)

    def transcribe_bytes(self, data: bytes, fmt: str = "wav") -> TranscriptionResult:
        audio = load_audio_bytes(data, fmt, AudioLoaderConfig.for_whisper())
        return self.transcribe_samples(audio.samples)

    def transcribe_samples(self, samples: np.ndarray) -> TranscriptionResult:
        text, segments = self._model.transcribe(samples, self.config)
        return TranscriptionResult(
            text=text, segments=segments,
            duration=len(samples) / 16000.0)

    def stream_file(self, path: str | Path) -> Iterator[str]:
        """Yield token text pieces as they decode (model.rs:182 stream_file),
        chunk by chunk."""
        audio = load_audio_for_whisper(Path(path))
        for i, chunk in enumerate(self._model.chunk_audio(audio)):
            chunk_pieces: list[str] = []

            def cb(tok: int, text: str) -> bool:
                chunk_pieces.append(text)
                return True

            cross_kv = self._model._encode_chunk(audio_pcm16(chunk))
            self._model.decode_chunk(cross_kv, self.config, i * CHUNK_LENGTH_SECS, cb)
            yield from chunk_pieces
