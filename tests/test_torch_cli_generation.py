"""The port's CLI against the JAX package's, on the CPU: the generation
family (generate, chat, summarize, translate, transcribe, model convert, -v
and the kjarni.toml [models."…"] overrides), with test_torch_cli.py's helpers
and bounds: the port's side with `--device cpu`, JSON compared key by key,
texts exactly. The tiny llama dir is greedy by default (generation_config.json
do_sample false), so chat's turns compare token for token: jax.random and
torch draw apart.
"""

import io
import json

import pytest
import torch

from helpers import build_word_tokenizer, save_torch_model
from test_torch_cli import _run, both

from kjarni_tpu.cli import main as jcli
from kjarni_tpu_torch.cli import main as tcli


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    from transformers import (BartConfig, BartForConditionalGeneration, LlamaConfig,
                              LlamaForCausalLM, T5Config, T5ForConditionalGeneration)
    base = tmp_path_factory.mktemp("torch_cli_gen")
    out = {k: base / k for k in ("llama", "bart", "t5")}
    for d in out.values():
        d.mkdir()
    d = out["llama"]
    vm = build_word_tokenizer(d / "tokenizer.json", bert_style=False)
    cfg = LlamaConfig(vocab_size=len(vm), hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=128, bos_token_id=2, eos_token_id=3,
                      tie_word_embeddings=False)
    torch.manual_seed(61)
    save_torch_model(d, LlamaForCausalLM(cfg).eval(), cfg)
    (d / "generation_config.json").write_text(json.dumps({"do_sample": False}))
    d = out["bart"]
    vm = build_word_tokenizer(d / "tokenizer.json", bert_style=False)
    cfg = BartConfig(vocab_size=len(vm), d_model=32, encoder_layers=1, decoder_layers=1,
                     encoder_attention_heads=2, decoder_attention_heads=2,
                     encoder_ffn_dim=64, decoder_ffn_dim=64, max_position_embeddings=64,
                     pad_token_id=0, bos_token_id=2, eos_token_id=3,
                     decoder_start_token_id=3, forced_bos_token_id=2)
    torch.manual_seed(62)
    save_torch_model(d, BartForConditionalGeneration(cfg).eval(), cfg)
    d = out["t5"]
    vm = build_word_tokenizer(d / "tokenizer.json", bert_style=False)
    cfg = T5Config(vocab_size=len(vm), d_model=32, d_kv=8, d_ff=64, num_layers=1,
                   num_decoder_layers=1, num_heads=4, relative_attention_num_buckets=8,
                   feed_forward_proj="relu", decoder_start_token_id=0, eos_token_id=1,
                   pad_token_id=0)
    torch.manual_seed(63)
    save_torch_model(d, T5ForConditionalGeneration(cfg).eval(), cfg)
    return out


def test_model_convert(dirs, capsys, tmp_path):
    """Both convert the llama dir to their native checkpoints with the same
    message; each package's checkpoint generates the same greedy text."""
    msgs = []
    for main, dev, name in ((jcli.main, [], "jax"), (tcli.main, ["--device", "cpu"], "port")):
        out = tmp_path / name / "ckpt"
        rc, text, err = _run(main, ["model", "convert", str(dirs["llama"]), str(out),
                                    "--dtype", "f32", *dev], capsys)
        assert rc == 0, err
        msgs.append(text.replace(str(out), "<out>"))
    assert msgs[0] == msgs[1] == "✓ Converted to native checkpoint at <out>\n"
    assert (tmp_path / "port" / "ckpt" / "kjarni_ckpt" / "params.pt").exists()
    gen = ["generate", "hello world", "--max-tokens", "5", "--preset", "greedy",
           "--format", "json"]
    _, jout, _ = _run(jcli.main, gen + ["--model", str(tmp_path / "jax" / "ckpt")], capsys)
    _, tout, _ = _run(tcli.main, gen + ["--model", str(tmp_path / "port" / "ckpt"),
                                        "--device", "cpu"], capsys)
    assert json.loads(tout) == json.loads(jout)


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

_GEN = ["generate", "hello world the doctor", "--max-tokens", "6", "--preset", "greedy"]


@pytest.mark.parametrize("extra", [["--format", "json"], [], ["--kv-cache", "int8",
                                                                  "--format", "json"],
                                   ["--offload", "ends", "--format", "json"]],
                         ids=["json", "text_stream", "kv_int8", "offload_ends"])
def test_generate(dirs, capsys, extra):
    rc, out, _ = both(_GEN + ["--model", str(dirs["llama"]), *extra], capsys)
    assert rc == 0 and out.strip()


def test_generate_past_max_length_is_empty_in_both(dirs, capsys):
    """GenerationConfig.max_length (100) counts the prompt and the CLI has no
    option to raise it: a 110-token prompt generates nothing, in both."""
    prompt = " ".join(["the doctor"] * 55)
    rc, out, _ = both(["generate", prompt, "--model", str(dirs["llama"]), "--max-tokens",
                       "4", "--preset", "greedy", "--format", "json"], capsys)
    assert rc == 0 and json.loads(out) == {"text": ""}


def test_generate_with_a_draft_model(dirs, capsys):
    rc, out, _ = both(_GEN + ["--model", str(dirs["llama"]), "--draft-model",
                              str(dirs["llama"]), "--draft-tokens", "3", "--format", "json"],
                      capsys)
    assert rc == 0


def test_generate_stdin(dirs, capsys, monkeypatch):
    outs = []
    for main, dev in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        monkeypatch.setattr("sys.stdin", io.StringIO("hello world"))
        rc, out, _ = _run(main, ["generate", "--model", str(dirs["llama"]), "--max-tokens",
                                 "4", "--preset", "greedy", "--format", "json", *dev], capsys)
        assert rc == 0
        outs.append(json.loads(out))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("extra", [[], ["--system", "be brief"],
                                   ["--chat-template", "chatml"]],
                         ids=["plain", "system", "template"])
def test_chat_message(dirs, capsys, extra):
    rc, out, _ = both(["chat", "--model", str(dirs["llama"]), "-m", "hello world", *extra],
                      capsys)
    assert rc == 0


def test_tp_passes_through_and_is_refused(dirs, capsys):
    """--tp 2 reaches the port's Generator, which refuses it outside a
    process group of 2 ranks and names the launcher (under torchrun it runs:
    tests/test_torch_parallel_serving.py)."""
    rc, _, err = _run(tcli.main, _GEN + ["--model", str(dirs["llama"]), "--tp", "2",
                                         "--device", "cpu"], capsys)
    assert rc == 1 and "torchrun --nproc-per-node 2" in err


# ---------------------------------------------------------------------------
# kjarni.toml [models."…"] overrides
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("override", ['quantize = "int4"', 'dtype = "f32"',
                                      'execution_plan = "offload_ends"',
                                      'max_context = 64'],
                         ids=["int4", "f32", "plan", "max_context"])
def test_toml_model_overrides(dirs, capsys, monkeypatch, tmp_path, override):
    monkeypatch.delenv("KJARNI_CONFIG", raising=False)
    (tmp_path / "kjarni.toml").write_text(f'[models."{dirs["llama"]}"]\n{override}\n')
    monkeypatch.chdir(tmp_path)
    seen = []
    real = tcli._model_overrides
    monkeypatch.setattr(tcli, "_model_overrides", lambda m: seen.append(real(m)) or seen[-1])
    rc, out, _ = both(_GEN + ["--model", str(dirs["llama"]), "--format", "json"], capsys)
    assert rc == 0
    key = override.split(" = ")[0]
    assert key in seen[0]


# ---------------------------------------------------------------------------
# seq2seq and audio
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["text", "json"])
def test_summarize(dirs, capsys, fmt):
    rc, _, _ = both(["summarize", "the doctor and the physician went to work",
                     "--model", str(dirs["bart"]), "--format", fmt], capsys)
    assert rc == 0


def test_translate(dirs, capsys):
    rc, out, _ = both(["translate", "hello world", "--model", str(dirs["t5"]), "--from",
                       "en", "--to", "de", "--format", "json"], capsys)
    assert rc == 0 and "translation" in out


def test_transcribe(capsys, tmp_path):
    from test_whisper import whisper_checkpoint
    from kjarni_tpu.audio.loader import create_sine_wave, write_wav
    d = tmp_path / "whisper"
    d.mkdir()
    whisper_checkpoint(d, seed=64)
    build_word_tokenizer(d / "tokenizer.json", bert_style=False)
    wav = tmp_path / "a.wav"
    write_wav(wav, create_sine_wave(440, 0.3, 16000), 16000)
    rc, out, _ = both(["transcribe", str(wav), "--model", str(d), "--format", "json"], capsys)
    assert rc == 0 and json.loads(out)["duration"] == pytest.approx(0.3, 0.01)


# ---------------------------------------------------------------------------
# verbosity
# ---------------------------------------------------------------------------

def test_verbose_enables_stats(dirs, capsys):
    from kjarni_tpu.core import stats as jstats
    from kjarni_tpu_torch.core import stats as tstats
    try:
        rc, _, _ = both(["-v", *_GEN, "--model", str(dirs["llama"]), "--format", "json"],
                        capsys)
        assert rc == 0 and tstats.stats_enabled()
    finally:
        jstats.enable_stats(False)
        tstats.enable_stats(False)
