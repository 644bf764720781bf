"""kjarni_tpu_torch's Whisper path (audio/loader.py, audio/mel.py,
models/whisper.py, models/whisper_transcriber.py, tasks/transcriber.py)
against the JAX package's, on the CPU, in f32.

Both packages load tests/test_whisper.py's tiny Whisper checkpoint (full
vocabulary and 1,500 source positions, d_model 32, 2 + 2 layers) and take the
same numpy audio. Tolerances are the JAX tests' own: the mel atol 2e-4
(also against transformers' WhisperFeatureExtractor), encoder states atol
3e-3 / rtol 1e-3, decoder logits atol 8e-3 / rtol 1e-2, incremental decode
against the full pass 1e-3; greedy ids, texts and segments exactly. The
encoder's flash path runs the kernel's plain version here, against the JAX
package's Pallas kernel in interpret mode, as its own tests run it.
Sampled decoding (the temperature fallback) draws from torch.Generators,
whose draws are not jax.random's: those tests hold the decisions and that
every draw is an allowed id.
"""

import dataclasses
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import build_word_tokenizer
from test_whisper import whisper_checkpoint

from kjarni_tpu.audio import loader as jloader
from kjarni_tpu.audio import mel as jmel
from kjarni_tpu.models import whisper as jw
from kjarni_tpu.models import whisper_transcriber as jwt
from kjarni_tpu.ops.pallas import flash_attention as jflash
from kjarni_tpu.tasks.transcriber import Transcriber as JaxTranscriber
from kjarni_tpu_torch import Transcriber
from kjarni_tpu_torch.audio import loader as tloader
from kjarni_tpu_torch.audio import mel as tmel
from kjarni_tpu_torch.core.errors import AudioError, InvalidConfigError
from kjarni_tpu_torch.models import whisper as tw
from kjarni_tpu_torch.models import whisper_transcriber as twt
from kjarni_tpu_torch.weights.safetensors_loader import ModelWeights

MEL_ATOL = 2e-4
SR = 16000


def _noise_tone(seconds: float, seed: int, f: float = 220.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(SR * seconds)
    return (0.1 * np.sin(2 * np.pi * f * np.arange(n) / SR)
            + 0.02 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def wdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("whisper")
    _, cfg, params = whisper_checkpoint(d, seed=6)
    build_word_tokenizer(d / "tokenizer.json", bert_style=False)
    return d, cfg, params


@pytest.fixture(scope="module")
def models(wdir):
    d = wdir[0]
    return twt.WhisperModel(d, device="cpu"), jwt.WhisperModel(d)


def _segs(segments):
    return [(s.start, s.end, s.text) for s in segments]


# ---------------------------------------------------------------------------
# audio
# ---------------------------------------------------------------------------

def test_filterbank_equals_jax():
    for args in ((16000, 400, 80, 0.0, 8000.0), (16000, 400, 128, 0.0, 8000.0),
                 (22050, 512, 40, 50.0, 11025.0)):
        np.testing.assert_array_equal(tmel.mel_filterbank(*args), jmel.mel_filterbank(*args))


def test_log_mel_matches_jax_and_whisper_feature_extractor():
    from transformers import WhisperFeatureExtractor
    audio = tloader.create_sine_wave(440.0, 2.0, SR)
    cfg = tmel.MelConfig.whisper()
    padded = np.pad(audio, (0, cfg.chunk_samples - len(audio)))
    got = tmel.log_mel_spectrogram(torch.from_numpy(padded), cfg).numpy()
    want = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(padded), jmel.MelConfig.whisper()))
    hf = WhisperFeatureExtractor()(audio, sampling_rate=SR,
                                   return_tensors="np").input_features[0]
    assert got.shape == want.shape == hf.shape == (80, 3000)
    np.testing.assert_allclose(got, want, atol=MEL_ATOL)
    np.testing.assert_allclose(got, hf, atol=MEL_ATOL)


def test_log_mel_batched_and_other_configs_match_jax():
    cfg, jcfg = tmel.MelConfig.whisper(), jmel.MelConfig.whisper()
    a = np.stack([_noise_tone(30.0, 1), _noise_tone(30.0, 2, f=3000.0) * 3])
    got = tmel.log_mel_spectrogram(torch.from_numpy(a), cfg).numpy()
    for i in range(2):   # each row normalized against its own maximum
        want = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(a[i]), jcfg))
        np.testing.assert_allclose(got[i], want, atol=MEL_ATOL)
        np.testing.assert_array_equal(
            got[i], tmel.log_mel_spectrogram(torch.from_numpy(a[i]), cfg).numpy())
    # a signal shorter than the chunk: frames past its end are zero
    short = _noise_tone(3.0, 3)
    np.testing.assert_allclose(
        tmel.log_mel_spectrogram(torch.from_numpy(short), cfg).numpy(),
        np.asarray(jmel.log_mel_spectrogram(jnp.asarray(short), jcfg)), atol=MEL_ATOL)
    plain = dict(n_fft=256, hop_length=100, n_mels=40)
    np.testing.assert_allclose(
        tmel.log_mel_spectrogram(torch.from_numpy(short), tmel.MelConfig(**plain)).numpy(),
        np.asarray(jmel.log_mel_spectrogram(jnp.asarray(short), jmel.MelConfig(**plain))),
        atol=MEL_ATOL, rtol=1e-5)


@pytest.mark.parametrize("src", [44100, 8000, 22050])
def test_loader_copy_equals_jax(tmp_path, src):
    x = _noise_tone(1.0, src)
    np.testing.assert_array_equal(tloader.resample(x, src, SR), jloader.resample(x, src, SR))
    np.testing.assert_array_equal(tloader.create_sine_wave(123.0, 0.5, src),
                                  jloader.create_sine_wave(123.0, 0.5, src))
    wav = tmp_path / "a.wav"
    tloader.write_wav(wav, x, src)
    got = tloader.load_audio_for_whisper(wav)
    np.testing.assert_array_equal(got, jloader.load_audio_for_whisper(wav))
    data = wav.read_bytes()
    np.testing.assert_array_equal(
        tloader.load_audio_bytes(data, config=tloader.AudioLoaderConfig.for_whisper()).samples,
        got)
    with pytest.raises(AudioError):
        tloader.load_audio(tmp_path / "missing.wav")
    with pytest.raises(AudioError):
        tloader.load_audio_bytes(data, fmt="mp3")


def test_pcm16_and_its_dequantization_equal_jax():
    x = np.concatenate([_noise_tone(0.1, 4) * 12, [1.0, -1.0, 0.0]]).astype(np.float32)
    q = twt.audio_pcm16(x)
    np.testing.assert_array_equal(q, jwt.audio_pcm16(x))
    assert twt.audio_pcm16(q) is q
    np.testing.assert_array_equal(twt._dequant_pcm(torch.from_numpy(q)).numpy(),
                                  np.asarray(jwt._dequant_pcm(jnp.asarray(q))))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_load_params_equal_converted_jax_params(wdir):
    d, _, jparams = wdir
    cfg = tw.WhisperConfig.from_hf(json.loads((d / "config.json").read_text()))
    params = tw.load_params(ModelWeights(d), cfg)
    assert params["conv1_w"].shape == (32, 80, 3)

    def same(p, r):
        for k, v in r.items():
            if isinstance(v, dict):
                same(p[k], v)
            else:
                np.testing.assert_array_equal(p[k].numpy(), np.asarray(v, np.float32))
    same(params, jparams)


def test_encode_matches_jax_with_and_without_flash(models, monkeypatch):
    wm, jm = models
    mel = np.random.default_rng(0).standard_normal((2, 80, 3000)).astype(np.float32) * 0.1
    want = np.asarray(jw.encode(jm.params, jm.config, jnp.asarray(mel)))
    plain = tw.encode(wm.params, wm.config, torch.from_numpy(mel)).numpy()
    flash = tw.encode(wm.params, wm.config, torch.from_numpy(mel), use_flash=True).numpy()
    np.testing.assert_allclose(plain, want, atol=3e-3, rtol=1e-3)
    np.testing.assert_allclose(flash, plain, atol=1e-5, rtol=1e-5)
    # the JAX package's flash path, its Pallas kernel in interpret mode
    monkeypatch.setattr(jflash, "flash_attention",
                        functools.partial(jflash.flash_attention, interpret=True))
    jflash_out = np.asarray(jw.encode(jm.params, jm.config, jnp.asarray(mel[:1]),
                                      use_flash=True))
    np.testing.assert_allclose(flash[:1], jflash_out, atol=3e-3, rtol=1e-3)


def test_encode_flash_launch_site_is_non_causal(models, monkeypatch):
    wm, _ = models
    calls = []
    real = tw.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), kw))
        return real(q, k, v, **kw)
    monkeypatch.setattr(tw, "flash_attention", spy)
    mel = torch.zeros(1, 80, 3000)
    tw.encode(wm.params, wm.config, mel, use_flash=True)
    assert calls == [((1, 4, 1500, 8), {"causal": False})] * wm.config.encoder_layers


def test_decode_step_and_incremental_match_jax(models):
    wm, jm = models
    mel = np.random.default_rng(1).standard_normal((1, 80, 3000)).astype(np.float32) * 0.1
    dec = np.array([[50258, 50259, 50359, 50363, 100]], dtype=np.int32)
    jenc = jw.encode(jm.params, jm.config, jnp.asarray(mel))
    jck, jcv = jw.precompute_cross_kv(jm.params, jm.config, jenc)
    jsk, jsv = jw.init_self_cache(jm.config, 1, 8)
    ones = jnp.ones((1, 1500), jnp.int32)
    want, _, _ = jw.decode_step(jm.params, jm.config, jnp.asarray(dec), jsk, jsv, jck, jcv,
                                ones, 0)
    p, cfg = wm.params, wm.config
    ck, cv = tw.precompute_cross_kv(p, cfg, tw.encode(p, cfg, torch.from_numpy(mel)))
    tones = torch.ones(1, 1500, dtype=torch.long)
    sk, sv = tw.init_self_cache(cfg, 1, 8)
    full, _, _ = tw.decode_step(p, cfg, torch.from_numpy(dec).long(), sk, sv, ck, cv,
                                tones, 0)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=8e-3, rtol=1e-2)
    sk, sv = tw.init_self_cache(cfg, 1, 8)
    for i in range(dec.shape[1]):
        last, sk, sv = tw.decode_step(p, cfg, torch.from_numpy(dec[:, i:i + 1]).long(),
                                      sk, sv, ck, cv, tones, i)
    np.testing.assert_allclose(last[0, 0].numpy(), full[0, -1].numpy(), atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# transcription
# ---------------------------------------------------------------------------

def test_prompt_chunks_and_language(models):
    wm, jm = models
    for kw in ({}, {"timestamps": True}, {"task": twt.WhisperTask.TRANSLATE},
               {"language": "de"}):
        jkw = dict(kw, task=jwt.WhisperTask(kw["task"].value)) if "task" in kw else kw
        assert wm.build_prompt_tokens(twt.WhisperTranscriberConfig(**kw)) == \
            jm.build_prompt_tokens(jwt.WhisperTranscriberConfig(**jkw))
    audio = _noise_tone(45.0, 5)
    got, want = wm.chunk_audio(audio), jm.chunk_audio(audio)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    ck, cv = wm._encode_chunk(twt.audio_pcm16(got[0]))
    jkv = jm._encode_chunk(jm.params, jnp.asarray(jwt.audio_pcm16(want[0])))
    np.testing.assert_allclose(ck.numpy(), np.asarray(jkv[0]), atol=3e-3, rtol=1e-3)
    assert wm.detect_language((ck, cv)) == jm.detect_language(jkv)


# one max_tokens_per_chunk throughout: the JAX package compiles one decode
# loop per (steps, prompt length), shared across the tests
@pytest.mark.parametrize("kw", [dict(max_tokens_per_chunk=4),
                                dict(max_tokens_per_chunk=4, timestamps=True),
                                dict(max_tokens_per_chunk=4, language="auto")])
def test_serial_transcribe_equals_jax(models, kw):
    wm, jm = models
    audio = _noise_tone(20.0, 6)
    got = wm.transcribe(audio, twt.WhisperTranscriberConfig(**kw))
    want = jm.transcribe(audio, jwt.WhisperTranscriberConfig(**kw))
    assert got[0] == want[0] and _segs(got[1]) == _segs(want[1])


@pytest.mark.parametrize("seconds,kw", [
    (75.0, dict(max_tokens_per_chunk=4)),                     # 3 chunks: pads to 4
    (90.0, dict(max_tokens_per_chunk=4, chunk_batch=2)),      # waves of 2 + 1
    (61.0, dict(max_tokens_per_chunk=4, timestamps=True)),
    (61.0, dict(max_tokens_per_chunk=4, language="auto")),
])
def test_batched_transcribe_equals_jax_and_serial(models, seconds, kw):
    wm, jm = models
    audio = _noise_tone(seconds, int(seconds))
    got = wm.transcribe(audio, twt.WhisperTranscriberConfig(**kw))
    want = jm.transcribe(audio, jwt.WhisperTranscriberConfig(**kw))
    serial = wm.transcribe(audio, twt.WhisperTranscriberConfig(**dict(kw, chunk_batch=1)))
    assert got[0] == want[0] == serial[0]
    assert _segs(got[1]) == _segs(want[1]) == _segs(serial[1])


def test_batched_rows_equal_their_serial_decodes(models):
    """The batched greedy loop pins finished rows to EOT: each row equals its
    own B = 1 decode, ids and logprob sums."""
    wm, _ = models
    audio = np.stack([_noise_tone(30.0, s) for s in (11, 12, 13)])
    ck, cv = wm._encode_chunks(twt.audio_pcm16(audio), n_pad=1)
    assert ck.shape[1] == 4
    cfg = twt.WhisperTranscriberConfig(max_tokens_per_chunk=6)
    prompt = wm.build_prompt_tokens(cfg)
    cache_len, max_steps, allow = wm._plan(prompt, cfg)
    out, sums = wm._decode_loop_b(prompt, ck, cv, allow, cache_len, max_steps)
    for j in range(4):
        ids, s = wm._decode_loop(prompt, ck[:, j:j + 1], cv[:, j:j + 1], allow, cache_len,
                                 0.0, None, max_steps)
        row = list(out[j])
        assert row[:len(ids)] == ids and all(t == twt.EOT_TOKEN for t in row[len(ids):])
        np.testing.assert_allclose(sums[j], s, rtol=1e-5, atol=1e-5)


def test_fallback_decisions_equal_jax(models):
    wm, jm = models
    base = dict(max_tokens_per_chunk=4, temperature_fallback=True)
    audio = _noise_tone(61.0, 21)
    # permissive thresholds: temperature 0 is accepted, equal to greedy and JAX
    ok = dict(base, compression_ratio_threshold=1e9, logprob_threshold=-1e9)
    greedy = wm.transcribe(audio, twt.WhisperTranscriberConfig(max_tokens_per_chunk=4))
    for cb in (1, 16):
        got = wm.transcribe(audio, twt.WhisperTranscriberConfig(**ok, chunk_batch=cb))
        want = jm.transcribe(audio, jwt.WhisperTranscriberConfig(**ok, chunk_batch=cb))
        assert got[0] == want[0] == greedy[0]
    # the acceptance test itself, on the same inputs as the JAX loop's
    cfg = twt.WhisperTranscriberConfig(**base)
    for ids, sum_lp in (([5, 6, 7], -0.5), ([5, 6, 7], -9.0), ([9] * 200, -1.0), ([], 0.0),
                        ([twt.EOT_TOKEN], -2.0)):
        text = jm.tokenizer.decode([i for i in ids if i < jwt.FIRST_SPECIAL_TOKEN], True)
        jax_ok = (jwt.compression_ratio(text) <= cfg.compression_ratio_threshold
                  and sum_lp / max(len(ids), 1) >= cfg.logprob_threshold)
        assert wm._accepted(ids, sum_lp, cfg) == jax_ok
    for text in ("", "the cat " * 60, "a b c d e f g"):
        assert twt.compression_ratio(text) == jwt.compression_ratio(text)


def test_fallback_retries_with_seeded_draws_of_allowed_ids(models, monkeypatch):
    wm, _ = models
    temps, draws = [], []
    real = wm._decode_loop

    def spy(prompt, ck, cv, allow, cache_len, temperature, generator, max_steps):
        ids, s = real(prompt, ck, cv, allow, cache_len, temperature, generator, max_steps)
        temps.append(temperature)
        draws.append(ids)
        return ids, s
    monkeypatch.setattr(wm, "_decode_loop", spy)
    impossible = twt.WhisperTranscriberConfig(
        max_tokens_per_chunk=6, temperature_fallback=True, temperatures=(0.0, 0.5, 1.0),
        compression_ratio_threshold=-1.0, logprob_threshold=1e9, timestamps=True)
    text, _ = wm.transcribe(_noise_tone(10.0, 22), impossible)
    assert isinstance(text, str) and temps == [0.0, 0.5, 1.0]
    for ids in draws:
        assert all(i < twt.FIRST_SPECIAL_TOKEN or i == twt.EOT_TOKEN
                   or i >= twt.TIMESTAMP_BEGIN for i in ids)
    # a seed repeats its draws
    temps.clear()
    draws_before = list(draws)
    draws.clear()
    wm.transcribe(_noise_tone(10.0, 22), impossible)
    assert draws == draws_before


def test_stitch_segments_equals_jax():
    S, J = twt.WhisperSegment, jwt.WhisperSegment
    cases = [
        [[(0.0, 30.0, "hello ")], [(30.0, 60.0, "world")]],
        [[(0.0, 12.0, "a")], [(30.0, 40.0, "b")]],
        [[(0.0, 5.0, "x"), (5.0, 30.0, "y")], [(30.0, 31.0, "z")], []],
        [],
        [[(2.0, 29.99, "p")], [(30.0, 45.0, "q")]],
    ]
    for case in cases:
        got = twt.stitch_segments([twt.WhisperChunkResult([S(*s) for s in r],
                                                          "".join(s[2] for s in r))
                                   for r in case])
        want = jwt.stitch_segments([jwt.WhisperChunkResult([J(*s) for s in r],
                                                           "".join(s[2] for s in r))
                                    for r in case])
        assert got[0] == want[0] and _segs(got[1]) == _segs(want[1])


def test_transcriber_task_equals_jax(wdir, models, tmp_path):
    d = wdir[0]
    wav = tmp_path / "speech.wav"
    tloader.write_wav(wav, _noise_tone(35.0 * 22050 / SR, 31), 22050)  # 35 s at 22.05 kHz
    port = Transcriber(str(d), device="cpu", quiet=True)
    ref = JaxTranscriber(str(d), quiet=True)
    ref._model = models[1]      # the same weights, its programs compiled once
    port.config.max_tokens_per_chunk = ref.config.max_tokens_per_chunk = 4
    got, want = port.transcribe_file(wav), ref.transcribe_file(wav)
    assert got.text == want.text and _segs(got.segments) == _segs(want.segments)
    assert got.duration == pytest.approx(want.duration) == pytest.approx(35.0, abs=0.01)
    by_bytes = port.transcribe_bytes(wav.read_bytes())
    assert by_bytes.text == got.text
    assert list(port.stream_file(wav)) == list(ref.stream_file(wav))
    ts = Transcriber(str(d), device="cpu", timestamps=True, task="translate", quiet=True)
    assert ts.config.timestamps and ts.config.task == twt.WhisperTask.TRANSLATE


def test_transcriber_needs_the_card_unless_asked_for_the_cpu(wdir):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(InvalidConfigError, match="device='cpu'"):
        Transcriber(str(wdir[0]))
    wm = twt.WhisperModel(wdir[0], device="cpu")
    assert not wm.use_flash and wm.dtype == torch.float32     # flash: bf16 on the card
    assert dataclasses.replace(twt.WhisperTranscriberConfig(), seed=3).seed == 3


def test_large_v3_takes_its_own_special_ids(tmp_path):
    """whisper-large-v3's vocabulary (51,866 ids) adds <|yue|> as its 100th
    language, which moves every special id after the languages up by one.
    The port takes the model's own ids from its vocabulary size: the task
    and no-timestamps tokens of its prompt, the first timestamp, and
    detection over all 100 languages. (The JAX package keeps whisper-small's
    ids for every model, so it has no large-v3 result to compare with.)"""
    import chip_smoke
    from helpers import save_torch_model
    from transformers import WhisperConfig, WhisperForConditionalGeneration
    config = WhisperConfig(
        vocab_size=51866, d_model=32, encoder_layers=1, decoder_layers=1,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
        decoder_ffn_dim=64, num_mel_bins=128, max_source_positions=1500,
        max_target_positions=448)
    torch.manual_seed(3)
    save_torch_model(tmp_path, WhisperForConditionalGeneration(config).eval(), config)
    chip_smoke.write_tokenizer(tmp_path / "tokenizer.json", 51866,
                               chip_smoke.whisper_specials(100))
    wm = twt.WhisperModel(tmp_path, device="cpu")
    tok = wm.tokenizer.token_to_id
    assert wm.mel_config.n_mels == 128 and wm.specials.languages == 100
    for kw, task in (({}, "<|transcribe|>"),
                     ({"task": twt.WhisperTask.TRANSLATE}, "<|translate|>")):
        assert wm.build_prompt_tokens(twt.WhisperTranscriberConfig(**kw)) == [
            tok("<|startoftranscript|>"), tok("<|en|>"), tok(task), tok("<|notimestamps|>")]
    assert bool(wm._allow_ts[tok("<|0.00|>")])
    assert not bool(wm._allow_ts[tok("<|notimestamps|>")])
    segs = wm._parse_timestamp_segments([tok("<|0.00|>"), 500, tok("<|1.00|>")], 30.0)
    assert [(s.start, s.end) for s in segs] == [(30.0, 31.0)]

    def logits(*_):   # the SOT step's logits, largest at the 100th language
        out = torch.zeros(1, 51866)
        out[0, tok("<|yue|>")] = 1.0
        return out
    wm._logits = logits
    assert wm.detect_language((None, None)) == "yue"
    # whisper-small's vocabulary keeps the module's (and the JAX package's) ids
    small = twt.WhisperSpecials.for_vocab(51865)
    assert (small.translate, small.transcribe, small.no_timestamps,
            small.timestamp_begin) == (twt.TRANSLATE_TOKEN, twt.TRANSCRIBE_TOKEN,
                                       twt.NO_TIMESTAMPS_TOKEN, twt.TIMESTAMP_BEGIN)
