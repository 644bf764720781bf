"""Log-mel spectrogram frontend on the device (port of
kjarni_tpu/audio/mel.py; cf. kjarni-transformers/src/audio/mel.rs).

The filterbank is built on the host in numpy (a copy of the JAX package's);
the pipeline is torch ops on the audio's device: reflect pad -> frames ->
periodic Hann window -> rfft in f32 -> power -> mel matmul -> log10 ->
Whisper's normalization. It takes one signal [n] or a batch [B, n], and
normalizes each signal against its own maximum.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160
    n_mels: int = 80
    chunk_length_secs: int = 30
    whisper_normalize: bool = False
    center: bool = False
    power: bool = False
    fmax: float | None = None
    fmin: float = 0.0

    @staticmethod
    def whisper(n_mels: int = 80) -> "MelConfig":
        return MelConfig(sample_rate=16000, n_fft=400, hop_length=160,
                         n_mels=n_mels, chunk_length_secs=30,
                         whisper_normalize=True, center=True, power=True,
                         fmax=8000.0, fmin=0.0)

    @property
    def chunk_samples(self) -> int:
        return self.sample_rate * self.chunk_length_secs

    @property
    def n_frames(self) -> int:
        # whisper fixes 3000 frames per 30s chunk
        return self.chunk_samples // self.hop_length


def hz_to_mel_slaney(hz: np.ndarray) -> np.ndarray:
    """Slaney mel scale (mel.rs:163 create_mel_filterbank_librosa)."""
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    hz = np.asarray(hz, dtype=np.float64)
    return np.where(hz < min_log_hz, hz / f_sp,
                    min_log_mel + np.log(np.maximum(hz, 1e-10) / min_log_hz) / logstep)


def mel_to_hz_slaney(mel: np.ndarray) -> np.ndarray:
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = np.asarray(mel, dtype=np.float64)
    return np.where(mel < min_log_mel, mel * f_sp,
                    min_log_hz * np.exp(logstep * (mel - min_log_mel)))


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """librosa-compatible Slaney filterbank [n_mels, n_fft//2+1]."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel_slaney(np.array(fmin)),
                          hz_to_mel_slaney(np.array(fmax)), n_mels + 2)
    hz_pts = mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney normalization
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    fb = fb * enorm[:, None]
    return fb.astype(np.float32)


def log_mel_spectrogram(audio: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """audio [n] or [B, n] (pre-padded to chunk_samples for whisper) -> [n_mels, T]
    or [B, n_mels, T], in f32.

    With whisper settings a frame whose window would overrun the padded
    signal is left at zero (the reference `break`s there), then whisper
    log-normalization applies, per signal.
    """
    batched = audio.dim() == 2
    x = (audio if batched else audio[None]).float()
    fmax = cfg.fmax if cfg.fmax is not None else cfg.sample_rate / 2.0
    fb = torch.from_numpy(mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                                         cfg.fmin, fmax)).to(x.device)
    if cfg.center:
        pad = cfg.n_fft // 2
        x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]   # 3-d for reflect
    n_samples = x.shape[1]
    if cfg.whisper_normalize:
        n_frames = cfg.n_frames
    else:
        n_frames = 1 + (n_samples - cfg.n_fft) // cfg.hop_length

    # frames [B, n_frames, n_fft]: zeros past the end, then frames that do not
    # fit inside the signal are zeroed whole
    need = (n_frames - 1) * cfg.hop_length + cfg.n_fft
    if need > n_samples:
        x = F.pad(x, (0, need - n_samples))
    frames = x.unfold(1, cfg.n_fft, cfg.hop_length)[:, :n_frames]
    starts = torch.arange(n_frames, device=x.device) * cfg.hop_length
    valid = (starts + cfg.n_fft) <= n_samples
    window = torch.from_numpy(np.hanning(cfg.n_fft + 1)[:-1].astype(np.float32)
                              ).to(x.device)
    frames = frames * window * valid[:, None]

    spec = torch.fft.rfft(frames, dim=-1).abs()   # [B, n_frames, n_bins]
    if cfg.power:
        spec = spec * spec
    mel = (spec @ fb.T).transpose(1, 2)           # [B, n_mels, n_frames]

    if cfg.whisper_normalize:
        log_spec = torch.log10(torch.clamp(mel, min=1e-10))
        peak = log_spec.amax(dim=(1, 2), keepdim=True)
        log_spec = torch.maximum(log_spec, peak - 8.0)
        out = (log_spec + 4.0) / 4.0
    else:
        out = torch.log(torch.clamp(mel, min=1e-10))
    return out if batched else out[0]
