"""Whisper transcription pipeline: chunking, prompt, greedy decode, stitching
(port of kjarni_tpu/models/whisper_transcriber.py; cf.
kjarni-models/src/models/whisper/transcriber.rs).

Audio goes to the device as int16 PCM and is dequantized there; mel and
encode run per chunk (B = 1) or per wave of chunks (B up to chunk_batch,
bucket-padded on the device by repeating lane 0). Decoding is a host loop
over device tensors with one host sync per token: the serial loop stops at
EOT, and the batched loop pins each finished row to EOT and stops when every
row has finished, so that each row equals its own B = 1 decode. The JAX
package fuses both loops into `lax.while_loop`s with the same semantics.

Sampling (the temperature fallback) draws from a `torch.Generator` seeded
with `config.seed + attempt`; its draws are not `jax.random`'s.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import zlib
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..audio.mel import MelConfig, log_mel_spectrogram
from ..core.bucketing import batch_bucket, seq_bucket
from ..tokenizer import KjarniTokenizer
from ..weights.safetensors_loader import ModelWeights
from . import whisper as kwhisper
from .decoder_lm import auto_dtype, resolve_device

# Token constants (transcriber.rs:20-24): whisper-small's vocabulary of
# 51,865 ids (99 languages). The ids after the languages move with their
# count: a model's own ids are WhisperSpecials.for_vocab(vocab_size).
SOT_TOKEN = 50258
EOT_TOKEN = 50257
TRANSCRIBE_TOKEN = 50359
TRANSLATE_TOKEN = 50358
NO_TIMESTAMPS_TOKEN = 50363
FIRST_SPECIAL_TOKEN = 50257
TIMESTAMP_BEGIN = 50364
CHUNK_LENGTH_SECS = 30.0
_SMALL_VOCAB, _SMALL_LANGUAGES = 51865, 99


@dataclasses.dataclass(frozen=True)
class WhisperSpecials:
    """The special ids of a multilingual Whisper vocabulary: <|endoftext|>,
    <|startoftranscript|>, then one id per language, then <|translate|>,
    <|transcribe|>, <|startoflm|>, <|startofprev|>, <|nocaptions|>,
    <|notimestamps|> and the timestamps, in that order. whisper-small's
    51,865 ids hold 99 languages; large-v3's 51,866 hold 100 (<|yue|> added),
    which moves every id after the languages up by one. The JAX package keeps
    whisper-small's ids for every model."""
    languages: int

    @staticmethod
    def for_vocab(vocab_size: int) -> "WhisperSpecials":
        return WhisperSpecials(_SMALL_LANGUAGES + max(0, vocab_size - _SMALL_VOCAB))

    @property
    def translate(self) -> int:
        return SOT_TOKEN + 1 + self.languages

    @property
    def transcribe(self) -> int:
        return self.translate + 1

    @property
    def no_timestamps(self) -> int:
        return self.translate + 5

    @property
    def timestamp_begin(self) -> int:
        return self.translate + 6

# The encoder's self-attention takes the flash kernel by default in bf16 on
# the card. The JAX package keeps its Pallas kernel off, on a TPU timing that
# says nothing of this card. On an NVIDIA H100 80GB HBM3 at 700 W
# (chip_smoke.py phase "whisper": whisper-small's widths, bf16, one encode
# call of 12 layers, device ms from CUDA-graph replay), flash takes 4.71 ms
# against the plain attention's 11.48 at B = 1 (a serial chunk), and 22.28
# against 72.48 at B = 8 (a wave of 8 chunks).
ENCODER_FLASH = True


def audio_pcm16(audio: np.ndarray) -> np.ndarray:
    """Quantize f32 audio to int16 PCM for the host->device transfer.

    Halves the upload bytes; quantization error <= 3.1e-5, below the log-mel
    floor. The serial and batched paths share this encoding, so their
    per-lane equality is exact.
    """
    if audio.dtype == np.int16:
        return audio
    return np.clip(np.round(audio * 32768.0), -32768.0, 32767.0) \
        .astype(np.int16)


def _dequant_pcm(audio: torch.Tensor) -> torch.Tensor:
    """The inverse of audio_pcm16 on the device (f32 input passes through)."""
    if audio.dtype == torch.int16:
        return audio.float() * (1.0 / 32768.0)
    return audio


class WhisperTask(str, enum.Enum):
    TRANSCRIBE = "transcribe"
    TRANSLATE = "translate"


@dataclasses.dataclass
class WhisperTranscriberConfig:
    """Cf. transcriber.rs:33 WhisperTranscriberConfig.

    temperature_fallback enables the OpenAI-Whisper quality loop: when a
    chunk's transcript is degenerate (gzip compression ratio above
    compression_ratio_threshold, or mean token logprob below
    logprob_threshold), the chunk is re-decoded at increasing sampling
    temperatures until a candidate passes. Off by default.
    chunk_batch: chunks decode together in waves of up to this many lanes
    (<= 1 forces the serial path; streaming always decodes serially).
    """

    language: Optional[str] = None
    task: WhisperTask = WhisperTask.TRANSCRIBE
    timestamps: bool = False
    max_tokens_per_chunk: int = 224
    temperature_fallback: bool = False
    temperatures: tuple[float, ...] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    compression_ratio_threshold: float = 2.4
    logprob_threshold: float = -1.0
    seed: int = 0
    chunk_batch: int = 16


def compression_ratio(text: str) -> float:
    """gzip-style compressibility of the transcript: repetition loops
    compress extremely well (ratio > threshold flags a degenerate decode)."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


@dataclasses.dataclass
class WhisperSegment:
    start: float
    end: float
    text: str


@dataclasses.dataclass
class WhisperChunkResult:
    segments: list[WhisperSegment]
    text: str


class WhisperModel:
    """A loaded Whisper checkpoint with its encode and decode loops.

    `device=None` means the CUDA card and raises when there is none.
    `dtype="auto"` is bf16 on the card, f32 on the CPU; f32 is also taken on
    the card. The encoder takes the flash kernel in bf16 on the card
    (ENCODER_FLASH; the kernel takes bf16 only) and the plain attention
    elsewhere.
    """

    def __init__(self, model_dir: Path, dtype="auto", device=None):
        self.device = resolve_device(device)
        dtype = auto_dtype(dtype, self.device)
        model_dir = Path(model_dir)
        self.model_dir = model_dir
        hf_cfg = json.loads((model_dir / "config.json").read_text())
        self.config = kwhisper.WhisperConfig.from_hf(hf_cfg)
        self.params = kwhisper.load_params(ModelWeights(model_dir), self.config,
                                           dtype, self.device)
        self.tokenizer = KjarniTokenizer.from_file(model_dir / "tokenizer.json")
        self.use_flash = (ENCODER_FLASH and self.device.type == "cuda"
                          and dtype == torch.bfloat16)
        self.mel_config = MelConfig.whisper(n_mels=self.config.num_mel_bins)
        self.specials = WhisperSpecials.for_vocab(self.config.vocab_size)
        # suppression: allow text tokens, EOT, and (optionally) timestamps
        ids = torch.arange(self.config.vocab_size, device=self.device)
        allow_base = (ids < FIRST_SPECIAL_TOKEN) | (ids == EOT_TOKEN)
        self._allow_no_ts = allow_base
        self._allow_ts = allow_base | (ids >= self.specials.timestamp_begin)

    @property
    def dtype(self) -> torch.dtype:
        return self.params["embed"].dtype

    # ------------------------------------------------------------------
    # encode

    @torch.inference_mode()
    def _encode_chunks(self, audios: np.ndarray, n_pad: int = 0):
        """Mel + encode + cross-K/V over [n, chunk_samples] (int16 PCM or
        f32); `n_pad` pads the wave on the device by repeating lane 0, so the
        upload carries only real lanes."""
        x = _dequant_pcm(torch.from_numpy(np.ascontiguousarray(audios)).to(self.device))
        if n_pad:
            x = torch.cat([x, x[:1].expand(n_pad, -1)])
        mel = log_mel_spectrogram(x, self.mel_config).to(self.dtype)
        enc = kwhisper.encode(self.params, self.config, mel, use_flash=self.use_flash)
        return kwhisper.precompute_cross_kv(self.params, self.config, enc)

    def _encode_chunk(self, audio: np.ndarray):
        """One chunk [chunk_samples] -> cross-K/V [L, 1, H, 1500, D]."""
        return self._encode_chunks(np.asarray(audio)[None])

    # ------------------------------------------------------------------
    # decode

    def _new_cache(self, batch: int, cache_len: int):
        return kwhisper.init_self_cache(self.config, batch, cache_len, self.dtype,
                                        self.device)

    def _logits(self, ids, sk, sv, ck, cv, pos: int) -> torch.Tensor:
        """The last position's logits [B, V] of one decode step."""
        logits, _, _ = kwhisper.decode_step(self.params, self.config, ids, sk, sv,
                                            ck, cv, None, pos)
        return logits[:, -1]

    def _prompt_ids(self, prompt: list[int], batch: int = 1) -> torch.Tensor:
        return torch.tensor([prompt] * batch, dtype=torch.long, device=self.device)

    @staticmethod
    def _pick(logits: torch.Tensor, allow: torch.Tensor, temperature: float = 0.0,
              generator: Optional[torch.Generator] = None):
        """[B, V] -> (tokens [B], logprobs [B]) among the allowed ids: greedy
        (the first maximum) at temperature 0, else one seeded draw per row."""
        masked = torch.where(allow, logits.float(), float("-inf"))
        lse = torch.logsumexp(masked, dim=-1)
        if temperature > 0:
            probs = torch.softmax(masked / max(temperature, 1e-6), dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            tok = torch.argmax(masked, dim=-1)
        return tok, masked.gather(1, tok[:, None])[:, 0] - lse

    @torch.inference_mode()
    def _decode_loop(self, prompt: list[int], ck, cv, allow, cache_len: int,
                     temperature: float, generator: Optional[torch.Generator],
                     max_steps: int):
        """Prefill, then one step per token until EOT or max_steps ->
        (ids, sum of the ids' logprobs)."""
        sk, sv = self._new_cache(1, cache_len)
        tok, lp = self._pick(self._logits(self._prompt_ids(prompt), sk, sv, ck, cv, 0),
                             allow, temperature, generator)
        toks, sum_lp = [tok], lp
        for i in range(max_steps):
            if int(tok) == EOT_TOKEN:          # the one host sync of a step
                break
            tok, lp = self._pick(self._logits(tok[:, None], sk, sv, ck, cv,
                                              len(prompt) + i),
                                 allow, temperature, generator)
            toks.append(tok)
            sum_lp = sum_lp + lp
        return torch.cat(toks).tolist(), float(sum_lp)

    @torch.inference_mode()
    def _decode_loop_b(self, prompt: list[int], ck, cv, allow, cache_len: int,
                       max_steps: int):
        """Batched greedy decode over n independent chunks with per-row EOT:
        finished rows keep stepping but are pinned to EOT, so each row's
        prefix equals its own B = 1 greedy decode. -> (ids [n, max_steps + 1]
        padded with EOT, logprob sums [n])."""
        n = ck.shape[1]
        sk, sv = self._new_cache(n, cache_len)
        tok, lp = self._pick(self._logits(self._prompt_ids(prompt, n), sk, sv, ck, cv, 0),
                             allow)
        out = torch.full((n, max_steps + 1), EOT_TOKEN, dtype=torch.long,
                         device=self.device)
        out[:, 0] = tok
        done, sum_lp = tok == EOT_TOKEN, lp
        for i in range(max_steps):
            if bool(done.all()):               # the one host sync of a step
                break
            nxt, lp = self._pick(self._logits(tok[:, None], sk, sv, ck, cv,
                                              len(prompt) + i), allow)
            nxt = torch.where(done, EOT_TOKEN, nxt)
            out[:, i + 1] = nxt
            sum_lp = sum_lp + torch.where(done, 0.0, lp)
            done = done | (nxt == EOT_TOKEN)
            tok = nxt
        return out.cpu().numpy(), sum_lp.cpu().numpy()

    # ------------------------------------------------------------------

    def chunk_audio(self, audio: np.ndarray) -> list[np.ndarray]:
        """Zero-padded 30s chunks (transcriber.rs:87)."""
        n = self.mel_config.chunk_samples
        chunks = []
        for start in range(0, max(len(audio), 1), n):
            chunk = audio[start:start + n]
            if len(chunk) < n:
                chunk = np.pad(chunk, (0, n - len(chunk)))
            chunks.append(chunk.astype(np.float32))
        return chunks

    @torch.inference_mode()
    def detect_language(self, cross_kv) -> str:
        """Detect the spoken language: feed [SOT], argmax over language tokens
        (the whisper-native method; the reference defaults to 'en')."""
        ck, cv = cross_kv
        sk, sv = self._new_cache(1, 8)
        logits = self._logits(self._prompt_ids([SOT_TOKEN]), sk, sv, ck, cv, 0)
        lang_lo = SOT_TOKEN + 1                       # <|en|>
        lang_hi = lang_lo + self.specials.languages
        tok = int(lang_lo + torch.argmax(logits[0, lang_lo:lang_hi]))
        text = self.tokenizer.decode([tok], skip_special_tokens=False)
        return text.strip("<|>") if text else "en"

    def resolve_language_token(self, language: str) -> Optional[int]:
        return self.tokenizer.token_to_id(f"<|{language.lower()}|>")

    def build_prompt_tokens(self, config: WhisperTranscriberConfig) -> list[int]:
        tokens = [SOT_TOKEN]
        lang = config.language or "en"
        tokens.append(self.resolve_language_token(lang) or 50259)
        tokens.append(self.specials.transcribe if config.task == WhisperTask.TRANSCRIBE
                      else self.specials.translate)
        if not config.timestamps:
            tokens.append(self.specials.no_timestamps)
        return tokens

    def _plan(self, prompt: list[int], config: WhisperTranscriberConfig):
        """(cache_len, max_steps, allow) of one chunk's decode."""
        cfg = self.config
        max_len = min(len(prompt) + config.max_tokens_per_chunk + 1,
                      cfg.max_target_positions)
        cache_len = seq_bucket(max_len, cfg.max_target_positions)
        max_steps = min(config.max_tokens_per_chunk, cache_len - len(prompt) - 1)
        allow = self._allow_ts if config.timestamps else self._allow_no_ts
        return cache_len, max_steps, allow

    def _accepted(self, ids: list[int], sum_lp: float,
                  config: WhisperTranscriberConfig) -> bool:
        """The fallback's test of one decode: not a repetition loop and a
        mean token logprob at or above the threshold."""
        text_ids = [i for i in ids if i < FIRST_SPECIAL_TOKEN]
        text = self.tokenizer.decode(text_ids, skip_special_tokens=True)
        avg_lp = sum_lp / max(len(ids), 1)
        return (compression_ratio(text) <= config.compression_ratio_threshold
                and avg_lp >= config.logprob_threshold)

    @torch.inference_mode()
    def decode_chunk(self, cross_kv, config: WhisperTranscriberConfig,
                     chunk_time_offset: float,
                     on_token: Optional[Callable[[int, str], bool]] = None
                     ) -> WhisperChunkResult:
        """Greedy decode one chunk over precomputed cross-K/V (transcriber.rs:143)."""
        ck, cv = cross_kv
        prompt = self.build_prompt_tokens(config)
        cache_len, max_steps, allow = self._plan(prompt, config)

        if on_token is None:
            temps = (config.temperatures if config.temperature_fallback
                     else (0.0,))
            generated: list[int] = []
            for attempt, temp in enumerate(temps):
                gen = torch.Generator(device=self.device).manual_seed(
                    config.seed + attempt)
                generated, sum_lp = self._decode_loop(prompt, ck, cv, allow, cache_len,
                                                      temp, gen, max_steps)
                if not config.temperature_fallback or \
                        self._accepted(generated, sum_lp, config):
                    break  # decode accepted; else retry hotter
            return self._finalize_chunk(generated, config, chunk_time_offset)

        # streaming path: per-token host sync for the callback
        sk, sv = self._new_cache(1, cache_len)
        tok, _ = self._pick(self._logits(self._prompt_ids(prompt), sk, sv, ck, cv, 0),
                            allow)
        generated = []
        pos = len(prompt)
        t = int(tok)
        generated.append(t)
        if t != EOT_TOKEN and not on_token(t, self.tokenizer.decode([t], False)):
            return self._finalize_chunk(generated, config, chunk_time_offset)
        for _ in range(config.max_tokens_per_chunk):
            if t == EOT_TOKEN or pos + 1 >= cache_len:
                break
            tok, _ = self._pick(self._logits(tok[:, None], sk, sv, ck, cv, pos), allow)
            t = int(tok)
            pos += 1
            generated.append(t)
            if t != EOT_TOKEN and not on_token(t, self.tokenizer.decode([t], False)):
                break
        return self._finalize_chunk(generated, config, chunk_time_offset)

    def _finalize_chunk(self, ids: list[int], config: WhisperTranscriberConfig,
                        offset: float) -> WhisperChunkResult:
        if config.timestamps:
            segments = self._parse_timestamp_segments(ids, offset)
            return WhisperChunkResult(segments=segments,
                                      text="".join(s.text for s in segments))
        text_ids = [i for i in ids if i < FIRST_SPECIAL_TOKEN]
        text = self.tokenizer.decode(text_ids, skip_special_tokens=True)
        segments = []
        if text.strip():
            segments = [WhisperSegment(offset, offset + CHUNK_LENGTH_SECS, text)]
        return WhisperChunkResult(segments=segments, text=text)

    def _parse_timestamp_segments(self, ids: list[int],
                                  offset: float) -> list[WhisperSegment]:
        """<|t1|> text <|t2|> pairs -> segments; timestamps step 0.02s."""
        segments: list[WhisperSegment] = []
        start: Optional[float] = None
        buf: list[int] = []
        for i in ids:
            if i >= self.specials.timestamp_begin:
                ts = (i - self.specials.timestamp_begin) * 0.02 + offset
                if start is None:
                    start = ts
                else:
                    text = self.tokenizer.decode(
                        [t for t in buf if t < FIRST_SPECIAL_TOKEN], True)
                    if text.strip():
                        segments.append(WhisperSegment(start, ts, text))
                    start, buf = ts, []
            elif i < FIRST_SPECIAL_TOKEN:
                buf.append(i)
        if buf:
            text = self.tokenizer.decode(buf, True)
            if text.strip():
                segments.append(WhisperSegment(
                    start if start is not None else offset,
                    offset + CHUNK_LENGTH_SECS, text))
        return segments

    # ------------------------------------------------------------------

    def transcribe(self, audio: np.ndarray,
                   config: Optional[WhisperTranscriberConfig] = None,
                   on_token: Optional[Callable[[int, str], bool]] = None
                   ) -> tuple[str, list[WhisperSegment]]:
        """Full pipeline: chunk -> mel+encode -> decode -> stitch.

        language="auto" runs whisper-native detection on the first chunk.
        Multi-chunk audio without a streaming callback runs the batched
        pipeline (config.chunk_batch lanes per wave); streaming keeps the
        serial order so on_token sees tokens in time order.
        """
        config = config or WhisperTranscriberConfig()
        chunks = self.chunk_audio(audio)
        if on_token is None and len(chunks) > 1 and config.chunk_batch > 1:
            return self._transcribe_batched(chunks, config)
        results = []
        for i, chunk in enumerate(chunks):
            cross_kv = self._encode_chunk(audio_pcm16(chunk))
            if config.language == "auto":
                config = dataclasses.replace(
                    config, language=self.detect_language(cross_kv))
            results.append(self.decode_chunk(cross_kv, config,
                                             i * CHUNK_LENGTH_SECS, on_token))
        return stitch_segments(results)

    def _transcribe_batched(self, chunks: list[np.ndarray],
                            config: WhisperTranscriberConfig
                            ) -> tuple[str, list[WhisperSegment]]:
        """Independent chunks decode together: waves of up to chunk_batch
        lanes (bucketed; partial waves pad by repeating lane 0). Per-lane
        greedy output equals the serial decode_chunk; temperature_fallback
        re-checks lanes on the host and retries only degenerate chunks
        through the serial path."""
        results: list[Optional[WhisperChunkResult]] = [None] * len(chunks)
        prompt: Optional[list[int]] = None
        wave_size = max(int(config.chunk_batch), 1)
        for ws in range(0, len(chunks), wave_size):
            wave = chunks[ws:ws + wave_size]
            nb = min(batch_bucket(len(wave)), wave_size)
            # upload only real lanes as int16 PCM; bucket-pad on device
            ck, cv = self._encode_chunks(audio_pcm16(np.stack(wave)),
                                         n_pad=nb - len(wave))
            if config.language == "auto" and prompt is None:
                config = dataclasses.replace(
                    config, language=self.detect_language((ck[:, :1], cv[:, :1])))
            if prompt is None:
                prompt = self.build_prompt_tokens(config)
            cache_len, max_steps, allow = self._plan(prompt, config)
            out, sum_lp = self._decode_loop_b(prompt, ck, cv, allow, cache_len,
                                              max_steps)
            for j in range(len(wave)):
                row = [int(t) for t in out[j]]
                if EOT_TOKEN in row:
                    row = row[:row.index(EOT_TOKEN) + 1]
                offset = (ws + j) * CHUNK_LENGTH_SECS
                if config.temperature_fallback and \
                        not self._accepted(row, float(sum_lp[j]), config):
                    # degenerate greedy decode: retry this chunk alone
                    # through the serial fallback ladder
                    lane = (ck[:, j:j + 1], cv[:, j:j + 1])
                    results[ws + j] = self.decode_chunk(lane, config, offset)
                    continue
                results[ws + j] = self._finalize_chunk(row, config, offset)
        return stitch_segments(results)


def stitch_segments(chunk_results: list[WhisperChunkResult]
                    ) -> tuple[str, list[WhisperSegment]]:
    """Cf. transcriber.rs:420 stitch_segments + merge_boundary_segments."""
    if not chunk_results:
        return "", []
    full_text = "".join(r.text for r in chunk_results)
    all_segments = [s for r in chunk_results for s in r.segments]
    if len(all_segments) < 2:
        return full_text, all_segments

    def is_boundary(t: float) -> bool:
        rem = t % CHUNK_LENGTH_SECS
        return rem < 0.02 or (CHUNK_LENGTH_SECS - rem) < 0.02

    merged: list[WhisperSegment] = []
    for seg in all_segments:
        if merged and abs(merged[-1].end - seg.start) < 0.02 and \
                is_boundary(merged[-1].end):
            merged[-1] = WhisperSegment(merged[-1].start, seg.end,
                                        merged[-1].text + seg.text)
        else:
            merged.append(seg)
    return full_text, merged
