"""Audio loading: WAV decode, mono mixdown, resampling (a copy of
kjarni_tpu/audio/loader.py, which is numpy and imports no JAX).

Cf. kjarni-transformers/src/audio/loader.rs (load_audio :72,
load_audio_bytes :101, load_audio_for_whisper :302, create_sine_wave :308).
The reference uses hound + rubato's polyphase resampler (loader.rs:72); here
stdlib `wave` + a numpy windowed-sinc polyphase resampler with the same
anti-aliasing properties (Kaiser-windowed lowpass at the smaller Nyquist,
scipy.signal.resample_poly-compatible alignment).
"""

from __future__ import annotations

import dataclasses
import io
import math
import wave
from pathlib import Path

import numpy as np

from ..core.errors import AudioError

WHISPER_SAMPLE_RATE = 16000


@dataclasses.dataclass
class AudioData:
    samples: np.ndarray  # float32 mono [-1, 1]
    sample_rate: int

    @property
    def duration(self) -> float:
        return len(self.samples) / self.sample_rate

    @property
    def num_samples(self) -> int:
        return len(self.samples)


@dataclasses.dataclass
class AudioLoaderConfig:
    target_sample_rate: int | None = None
    mono: bool = True

    @staticmethod
    def for_whisper() -> "AudioLoaderConfig":
        return AudioLoaderConfig(target_sample_rate=WHISPER_SAMPLE_RATE, mono=True)


def _decode_wav(fileobj) -> AudioData:
    try:
        with wave.open(fileobj, "rb") as w:
            n_channels = w.getnchannels()
            sampwidth = w.getsampwidth()
            rate = w.getframerate()
            n_frames = w.getnframes()
            raw = w.readframes(n_frames)
    except wave.Error as e:
        raise AudioError(f"failed to decode WAV: {e}")
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise AudioError(f"unsupported WAV sample width {sampwidth}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return AudioData(samples=data, sample_rate=rate)


def _poly_filter(up: int, down: int) -> np.ndarray:
    """Kaiser-windowed sinc lowpass for up/down polyphase resampling.

    Same design rule as scipy.signal.resample_poly (and rubato's sinc
    interpolator, the reference's choice at loader.rs:72): cutoff at
    1/max(up, down) of Nyquist, 10·max_rate taps per side, Kaiser beta=5,
    unity DC gain, scaled by `up` to compensate zero-stuffing.
    """
    max_rate = max(up, down)
    f_c = 1.0 / max_rate
    half_len = 10 * max_rate
    t = np.arange(2 * half_len + 1, dtype=np.float64) - half_len
    h = f_c * np.sinc(f_c * t) * np.kaiser(2 * half_len + 1, 5.0)
    h /= h.sum()
    return h * up


def resample(samples: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Windowed-sinc polyphase resample (anti-aliased, rubato-equivalent).

    Replaces round-1's linear interpolation, which aliased on 44.1k->16k
    downsampling. Verified against scipy.signal.resample_poly goldens in
    tests/test_whisper.py.
    """
    if src_rate == dst_rate:
        return samples.astype(np.float32, copy=False)
    n_in = len(samples)
    g = math.gcd(int(src_rate), int(dst_rate))
    up, down = dst_rate // g, src_rate // g
    n_out = -(-n_in * up // down)  # ceil
    if n_in <= 1 or n_out <= 1:
        return np.zeros(max(n_out, 0), dtype=np.float32)

    h = _poly_filter(up, down)
    half_len = (len(h) - 1) // 2
    x = np.asarray(samples, dtype=np.float64)

    # Output m taps the zero-stuffed signal at i = m*down + half_len (centered
    # filter). Nonzero input samples sit at multiples of `up`:
    #   y[m] = sum_l h[j] * x[(i - j) / up]  over j == i (mod up).
    # Evaluate per phase p = i % up with a strided sliding-window dot product.
    L_poly = (len(h) + up - 1) // up  # taps per phase
    # pad x so every window index is valid: left by taps, right by taps
    pad = L_poly + 1
    xp = np.pad(x, (pad, pad))
    y = np.empty(n_out, dtype=np.float64)
    win = np.lib.stride_tricks.sliding_window_view(xp, L_poly)

    m = np.arange(n_out)
    i = m * down + half_len
    phase = i % up
    base = i // up  # index of the newest input sample contributing
    for p in range(up):
        sel = np.nonzero(phase == p)[0]
        if sel.size == 0:
            continue
        # phase-p taps: h[p], h[p+up], ... applied to x[base], x[base-1], ...
        hp = h[p::up]
        # window view rows are ascending in x; reverse taps to correlate
        hp_rev = np.zeros(L_poly)
        hp_rev[L_poly - len(hp):] = hp[::-1]
        rows = base[sel] + pad - (L_poly - 1)
        y[sel] = win[rows] @ hp_rev
    return y.astype(np.float32)


def load_audio(path: Path, config: AudioLoaderConfig | None = None) -> AudioData:
    path = Path(path)
    if not path.exists():
        raise AudioError(f"audio file not found: {path}")
    if path.suffix.lower() != ".wav":
        raise AudioError(
            f"unsupported audio format '{path.suffix}' (WAV only in this build)")
    with open(path, "rb") as f:
        return _finish(_decode_wav(f), config)


def load_audio_bytes(data: bytes, fmt: str = "wav",
                     config: AudioLoaderConfig | None = None) -> AudioData:
    if fmt.lower() != "wav":
        raise AudioError(f"unsupported audio format '{fmt}' (WAV only)")
    return _finish(_decode_wav(io.BytesIO(data)), config)


def _finish(audio: AudioData, config: AudioLoaderConfig | None) -> AudioData:
    config = config or AudioLoaderConfig()
    if config.target_sample_rate and audio.sample_rate != config.target_sample_rate:
        audio = AudioData(
            samples=resample(audio.samples, audio.sample_rate,
                             config.target_sample_rate),
            sample_rate=config.target_sample_rate)
    return audio


def load_audio_for_whisper(path: Path) -> np.ndarray:
    """WAV -> mono float32 @16kHz (loader.rs:302)."""
    return load_audio(path, AudioLoaderConfig.for_whisper()).samples


def create_sine_wave(frequency: float, duration_secs: float,
                     sample_rate: int = 16000) -> np.ndarray:
    t = np.arange(int(duration_secs * sample_rate)) / sample_rate
    return np.sin(2 * np.pi * frequency * t).astype(np.float32)


def write_wav(path: Path, samples: np.ndarray, sample_rate: int) -> None:
    """Helper for tests: float32 mono -> 16-bit WAV."""
    data = np.clip(samples, -1.0, 1.0)
    pcm = (data * 32767.0).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
