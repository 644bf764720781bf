"""The port's C ABI against the JAX package's, on the CPU.

- The bridge (kjarni_tpu_torch/ffi/bridge.py) against kjarni_tpu/ffi/bridge.py
  for all ten tasks and their methods, cancel tokens and the pull stream:
  the same JSON, floats within 1e-5 (the JAX tests' bound for the encoder
  tasks), texts and orders exactly. The port's options carry "device": "cpu";
  without it the port refuses here (no card).
- The port's libkjarni.so (built by kjarni_tpu_torch/ffi/build.py into
  build/ffi/) through ctypes, in a subprocess of its own so that it never
  shares a process with native/libkjarni.so: the JSON calls, the typed
  buffer calls, the push-callback stream with an early stop that cancels its
  token, and the pull stream, each against the JAX bridge's answers.
- bindings/python loading the port's library through KJARNI_LIBRARY (same
  subprocess).
- The port's compiled C host (kjarni_tpu_torch/native/test_host.c) with
  device "cpu", as tests/test_ffi_c_host.py runs the JAX one.
- kjarni_tpu_torch/native/kjarni.h byte-identical to native/kjarni.h.

The library tests skip only where g++ or python3-config is missing, as the
JAX tests do without a native toolchain.
"""

import json
import os
import shutil
import site
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from helpers import build_word_tokenizer, save_torch_model, tiny_bert_dir
from test_torch_cli import _close

from kjarni_tpu.ffi import bridge as jbridge
from kjarni_tpu_torch.ffi import bridge as tbridge

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    from transformers import (BartConfig, BartForConditionalGeneration, LlamaConfig,
                              LlamaForCausalLM, T5Config, T5ForConditionalGeneration)
    from test_whisper import whisper_checkpoint
    from kjarni_tpu.audio.loader import create_sine_wave, write_wav
    base = tmp_path_factory.mktemp("torch_ffi")
    out = {k: base / k for k in ("embedder", "classifier", "reranker", "llama", "bart",
                                 "t5", "whisper", "docs")}
    for d in out.values():
        d.mkdir()
    tiny_bert_dir(out["embedder"], seed=11)
    tiny_bert_dir(out["classifier"], num_labels=2, seed=12)
    tiny_bert_dir(out["reranker"], num_labels=1, seed=13)
    vm = build_word_tokenizer(out["llama"] / "tokenizer.json", bert_style=False)
    cfg = LlamaConfig(vocab_size=len(vm), hidden_size=32, intermediate_size=64,
                      num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=128, bos_token_id=2, eos_token_id=3,
                      tie_word_embeddings=False)
    torch.manual_seed(71)
    save_torch_model(out["llama"], LlamaForCausalLM(cfg).eval(), cfg)
    # greedy by default: chat's turns take the model's defaults, and sampled
    # draws of jax.random and torch part
    (out["llama"] / "generation_config.json").write_text(json.dumps({"do_sample": False}))
    vm = build_word_tokenizer(out["bart"] / "tokenizer.json", bert_style=False)
    cfg = BartConfig(vocab_size=len(vm), d_model=32, encoder_layers=1, decoder_layers=1,
                     encoder_attention_heads=2, decoder_attention_heads=2,
                     encoder_ffn_dim=64, decoder_ffn_dim=64, max_position_embeddings=64,
                     pad_token_id=0, bos_token_id=2, eos_token_id=3,
                     decoder_start_token_id=3, forced_bos_token_id=2)
    torch.manual_seed(72)
    save_torch_model(out["bart"], BartForConditionalGeneration(cfg).eval(), cfg)
    vm = build_word_tokenizer(out["t5"] / "tokenizer.json", bert_style=False)
    cfg = T5Config(vocab_size=len(vm), d_model=32, d_kv=8, d_ff=64, num_layers=1,
                   num_decoder_layers=1, num_heads=4, relative_attention_num_buckets=8,
                   feed_forward_proj="relu", decoder_start_token_id=0, eos_token_id=1,
                   pad_token_id=0)
    torch.manual_seed(73)
    save_torch_model(out["t5"], T5ForConditionalGeneration(cfg).eval(), cfg)
    whisper_checkpoint(out["whisper"], seed=74)
    build_word_tokenizer(out["whisper"] / "tokenizer.json", bert_style=False)
    out["wav"] = base / "a.wav"
    write_wav(out["wav"], create_sine_wave(440, 0.3, 16000), 16000)
    (out["docs"] / "a.txt").write_text("the quick brown fox\nmedical staff treat patients\n")
    (out["docs"] / "b.md").write_text("keeping data safe with quality service")
    out["more"] = base / "more.txt"
    out["more"].write_text("hello world the physician is good")
    out["base"] = base
    return out


def _both(task: str, opts: dict, calls: list) -> list:
    """Create `task` through both bridges, make each (method, args) call on
    both, compare the JSON; returns the port's answers."""
    hj = jbridge.create(task, json.dumps(opts))
    ht = tbridge.create(task, json.dumps({**opts, "device": "cpu"}))
    got = []
    try:
        for method, args in calls:
            a = json.loads(tbridge.call(ht, method, json.dumps(args)))
            b = json.loads(jbridge.call(hj, method, json.dumps(args)))
            _close(a, b, f"{task}.{method}")
            got.append(a)
    finally:
        jbridge.destroy(hj)
        tbridge.destroy(ht)
    return got


_TEXTS = ["the doctor helps", "asphalt paving is hard", "i love this product"]


@pytest.mark.parametrize("task,calls", [
    ("embedder", [("embed", {"text": "hello world"}), ("embed_batch", {"texts": _TEXTS}),
                  ("similarity", {"a": "doctor", "b": "physician"}), ("dim", {})]),
    ("classifier", [("classify", {"text": "i love this"}),
                    ("classify_batch", {"texts": _TEXTS}), ("labels", {})]),
    ("reranker", [("score", {"query": "medical question", "document": _TEXTS[0]}),
                  ("rerank", {"query": "medical question", "documents": _TEXTS})]),
    ("chat", [("send", {"message": "hello world"}), ("history", {}),
              ("send", {"message": "the doctor"}), ("clear_history", {"keep_system": True}),
              ("history", {})]),
    ("generator", [("generate", {"prompt": "hello world", "max_new_tokens": 5}),
                   ("generate", {"prompt": "the doctor is", "preset": "greedy",
                                 "max_new_tokens": 4})]),
    ("summarizer", [("summarize", {"text": "the doctor and the physician went to work"})]),
    ("translator", [("translate", {"text": "hello world", "from": "en", "to": "de"})]),
])
def test_bridge_tasks_match_jax(dirs, task, calls):
    model = dirs["llama"] if task in ("chat", "generator") else dirs.get(task)
    if task == "summarizer":
        model = dirs["bart"]
    if task == "translator":
        model = dirs["t5"]
    got = _both(task, {"model": str(model)}, calls)
    assert got and all(isinstance(g, dict) for g in got)


def test_bridge_transcriber_matches_jax(dirs):
    got = _both("transcriber", {"model": str(dirs["whisper"])},
                [("transcribe_file", {"path": str(dirs["wav"])})])
    assert abs(got[0]["duration"] - 0.3) < 0.01


def test_bridge_indexer_and_searcher_match_jax(dirs, tmp_path):
    """Each package's indexer writes its own index (create, then add); each
    searcher answers over its own, in every mode."""
    opts = {"model": str(dirs["embedder"]), "quiet": True}
    hj, ht = jbridge.create("indexer", json.dumps(opts)), tbridge.create(
        "indexer", json.dumps({**opts, "device": "cpu"}))
    try:
        for method, paths in (("create", [str(dirs["docs"])]), ("add", [str(dirs["more"])])):
            a = json.loads(tbridge.call(ht, method, json.dumps(
                {"index_path": str(tmp_path / "port"), "paths": paths})))
            b = json.loads(jbridge.call(hj, method, json.dumps(
                {"index_path": str(tmp_path / "jax"), "paths": paths})))
            assert a == b and a["documents"] >= 1
    finally:
        jbridge.destroy(hj)
        tbridge.destroy(ht)
    hj, ht = jbridge.create("searcher", json.dumps(opts)), tbridge.create(
        "searcher", json.dumps({**opts, "device": "cpu"}))
    try:
        for mode in ("semantic", "keyword", "hybrid"):
            q = {"query": "who treats patients", "mode": mode, "top_k": 3}
            a = json.loads(tbridge.call(ht, "search", json.dumps(
                {**q, "index_path": str(tmp_path / "port")})))
            b = json.loads(jbridge.call(hj, "search", json.dumps(
                {**q, "index_path": str(tmp_path / "jax")})))
            _close(a, b, mode)
            assert a["results"]
    finally:
        jbridge.destroy(hj)
        tbridge.destroy(ht)


def _pull(bridge, h, method, args, cancel=0):
    bridge.stream_start(h, method, json.dumps(args), cancel)
    out = []
    while (tok := bridge.stream_next(h)) is not None:
        out.append(tok)
    return out


@pytest.mark.parametrize("task,method,args", [
    ("generator", "generate_stream", {"prompt": "hello world", "max_new_tokens": 5,
                                      "preset": "greedy"}),
    ("chat", "stream", {"message": "hello world"}),
])
def test_bridge_pull_streams_match_jax(dirs, task, method, args):
    hj = jbridge.create(task, json.dumps({"model": str(dirs["llama"])}))
    ht = tbridge.create(task, json.dumps({"model": str(dirs["llama"]), "device": "cpu"}))
    try:
        got, want = _pull(tbridge, ht, method, args), _pull(jbridge, hj, method, args)
        assert got == want and got
    finally:
        jbridge.destroy(hj)
        tbridge.destroy(ht)


def test_bridge_cancel_tokens_match_jax(dirs):
    for bridge in (jbridge, tbridge):
        tok = bridge.cancel_token_new()
        assert bridge.cancel_token_is_cancelled(tok) is False
        bridge.cancel_token_cancel(tok)
        assert bridge.cancel_token_is_cancelled(tok) is True
        bridge.destroy(tok)
    counts = []
    for bridge, dev in ((jbridge, {}), (tbridge, {"device": "cpu"})):
        h = bridge.create("generator", json.dumps({"model": str(dirs["llama"]), **dev}))
        tok = bridge.cancel_token_new()
        bridge.cancel_token_cancel(tok)
        counts.append(len(_pull(bridge, h, "generate_stream",
                                {"prompt": "hello", "max_new_tokens": 10,
                                 "preset": "greedy"}, tok)))
        bridge.stream_start(h, "generate_stream", json.dumps({"prompt": "hello"}), 0)
        bridge.stream_cancel(h)
        assert bridge.stream_next(h) is None
        bridge.destroy(tok)
        bridge.destroy(h)
    assert counts[0] == counts[1] <= 1


@pytest.mark.parametrize("bad", [("task", "quantum-oracle", "unknown task"),
                                 ("method", "teleport", "unknown method"),
                                 ("handle", None, "invalid kjarni handle")])
def test_bridge_errors_match_jax(dirs, bad):
    kind, value, msg = bad
    for bridge, dev in ((jbridge, {}), (tbridge, {"device": "cpu"})):
        with pytest.raises(ValueError, match=msg):
            if kind == "task":
                bridge.create(value, "{}")
            elif kind == "handle":
                bridge.call(987654321, "embed", "{}")
            else:
                h = bridge.create("embedder", json.dumps({"model": str(dirs["embedder"]),
                                                          **dev}))
                try:
                    bridge.call(h, value, "{}")
                finally:
                    bridge.destroy(h)


def test_bridge_without_a_device_means_the_card(dirs):
    """No "device" key: the task takes the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the task would run on it")
    with pytest.raises(Exception, match="no CUDA device"):
        tbridge.create("embedder", json.dumps({"model": str(dirs["embedder"])}))


# ---------------------------------------------------------------------------
# the port's shared library, the Python binding and the C host
# ---------------------------------------------------------------------------

def test_header_is_byte_identical():
    assert (ROOT / "kjarni_tpu_torch" / "native" / "kjarni.h").read_bytes() == \
        (ROOT / "native" / "kjarni.h").read_bytes()


def _cpp_code(text: str) -> list:
    """A C++ source's code as tokens split on whitespace, its // and /* */
    comments removed (string and character literals kept whole)."""
    out, i, n = [], 0, len(text)
    while i < n:
        if text.startswith("//", i):
            i = text.find("\n", i) % (n + 1)
        elif text.startswith("/*", i):
            i = text.index("*/", i) + 2
        elif text[i] in "\"'":
            j = i + 1
            while text[j] != text[i]:
                j += 2 if text[j] == "\\" else 1
            out.append(text[i:j + 1])
            i = j + 1
        else:
            out.append(text[i])
            i += 1
    return "".join(out).split()


def test_shim_equals_the_jax_shim_but_for_its_bridge():
    """The port's kjarni_ffi.cpp is native/kjarni_ffi.cpp with one change,
    the bridge module it imports: a fix to either shim's code must reach the
    other."""
    port = (ROOT / "kjarni_tpu_torch" / "native" / "kjarni_ffi.cpp").read_text()
    ref = (ROOT / "native" / "kjarni_ffi.cpp").read_text()
    assert port.count('"kjarni_tpu_torch.ffi.bridge"') == 1
    assert _cpp_code(port.replace('"kjarni_tpu_torch.ffi.bridge"',
                                  '"kjarni_tpu.ffi.bridge"')) == _cpp_code(ref)
    assert _cpp_code(port) != _cpp_code(ref)


@pytest.fixture(scope="module")
def built():
    if shutil.which("g++") is None or shutil.which("gcc") is None:
        pytest.skip("native toolchain unavailable (g++/gcc)")
    from kjarni_tpu_torch.ffi import build
    try:
        build.python_config()
    except RuntimeError:
        pytest.skip("python3-config unavailable")
    return build.build_library(), build.build_test_host()


def _env():
    """The embedded interpreter (the Python libkjarni.so links) knows nothing
    of this venv or checkout: both come in through PYTHONPATH."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + site.getsitepackages())
    env.setdefault("TOKENIZERS_PARALLELISM", "false")
    return env


_CTYPES_SCRIPT = r'''
import ctypes, json, sys
lib_path, emb, clf, llama, binding = sys.argv[1:6]
L = ctypes.CDLL(lib_path)
L.kjarni_init.restype = ctypes.c_int
L.kjarni_version.restype = ctypes.c_char_p
L.kjarni_last_error.restype = ctypes.c_char_p
L.kjarni_new.restype = ctypes.c_longlong
L.kjarni_new.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
L.kjarni_call.restype = ctypes.c_void_p
L.kjarni_call.argtypes = [ctypes.c_longlong, ctypes.c_char_p, ctypes.c_char_p]
L.kjarni_string_free.argtypes = [ctypes.c_void_p]
L.kjarni_free.argtypes = [ctypes.c_longlong]
L.kjarni_embedder_embed.restype = ctypes.c_int
L.kjarni_embedder_embed.argtypes = [ctypes.c_longlong, ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_float), ctypes.c_int]
L.kjarni_generator_generate.restype = ctypes.c_void_p
L.kjarni_generator_generate.argtypes = [ctypes.c_longlong, ctypes.c_char_p, ctypes.c_int]
L.kjarni_cancel_token_new.restype = ctypes.c_longlong
L.kjarni_cancel_token_is_cancelled.restype = ctypes.c_int
L.kjarni_cancel_token_is_cancelled.argtypes = [ctypes.c_longlong]
L.kjarni_cancel_token_free.argtypes = [ctypes.c_longlong]
CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p)
L.kjarni_stream_with_callback.restype = ctypes.c_int
L.kjarni_stream_with_callback.argtypes = [ctypes.c_longlong, ctypes.c_char_p,
                                          ctypes.c_char_p, CB, ctypes.c_void_p,
                                          ctypes.c_longlong]
L.kjarni_stream_start.restype = ctypes.c_int
L.kjarni_stream_start.argtypes = [ctypes.c_longlong, ctypes.c_char_p, ctypes.c_char_p]
L.kjarni_stream_next.restype = ctypes.c_void_p
L.kjarni_stream_next.argtypes = [ctypes.c_longlong]
out = {"version": L.kjarni_version().decode(), "init": L.kjarni_init()}

def take(p):
    assert p, L.kjarni_last_error().decode()
    s = ctypes.string_at(p).decode()
    L.kjarni_string_free(p)
    return json.loads(s)

def new(task, model):
    h = L.kjarni_new(task.encode(), json.dumps({"model": model, "device": "cpu"}).encode())
    assert h > 0, L.kjarni_last_error().decode()
    return h

h = new("embedder", emb)
out["embed"] = take(L.kjarni_call(h, b"embed", json.dumps({"text": "hello world"}).encode()))
buf = (ctypes.c_float * 64)()
n = L.kjarni_embedder_embed(h, b"hello world", buf, 64)
out["embed_typed"] = [float(x) for x in buf[:n]]
L.kjarni_free(h)
h = new("classifier", clf)
out["classify"] = take(L.kjarni_call(h, b"classify", b'{"text": "i love this"}'))
L.kjarni_free(h)
h = new("generator", llama)
out["generate_typed"] = take(L.kjarni_generator_generate(h, b"hello world", 5))
args = json.dumps({"prompt": "hello world", "max_new_tokens": 6, "preset": "greedy"}).encode()
toks = []

@CB
def cb(tok, _ud):
    toks.append(tok.decode())
    return 0
out["callback_n"] = L.kjarni_stream_with_callback(h, b"generate_stream", args, cb, None, 0)
out["callback"] = list(toks)
cancel = L.kjarni_cancel_token_new()
early = []

@CB
def stop2(tok, _ud):
    early.append(tok.decode())
    return 1 if len(early) >= 2 else 0
out["early_n"] = L.kjarni_stream_with_callback(h, b"generate_stream", args, stop2, None, cancel)
out["early_cancelled"] = L.kjarni_cancel_token_is_cancelled(cancel)
L.kjarni_cancel_token_free(cancel)
assert L.kjarni_stream_start(h, b"generate_stream", args) == 0
pulled = []
while True:
    p = L.kjarni_stream_next(h)
    if not p:
        break
    pulled.append(ctypes.string_at(p).decode())
    L.kjarni_string_free(p)
out["pull"] = pulled
L.kjarni_free(h)
out["bad_task"] = L.kjarni_new(b"quantum-oracle", b"{}")
out["no_device_error"] = ""
if L.kjarni_new(b"embedder", json.dumps({"model": emb}).encode()) == 0:
    out["no_device_error"] = L.kjarni_last_error().decode()
sys.path.insert(0, binding)
import kjarni
with kjarni.Embedder(emb, device="cpu") as e:
    out["binding_embed"] = [float(x) for x in e.embed("hello world")]
with kjarni.Classifier(clf, device="cpu") as c:
    out["binding_labels"] = c.labels
print(json.dumps(out))
'''


def test_port_library_through_ctypes_and_the_binding(dirs, built, tmp_path):
    """The port's libkjarni.so in a process of its own (ctypes, then
    bindings/python through KJARNI_LIBRARY), against the JAX bridge."""
    lib, _ = built
    script = tmp_path / "drive.py"
    script.write_text(_CTYPES_SCRIPT)
    env = _env()
    env["KJARNI_LIBRARY"] = str(lib)
    r = subprocess.run([sys.executable, str(script), str(lib), str(dirs["embedder"]),
                        str(dirs["classifier"]), str(dirs["llama"]),
                        str(ROOT / "bindings" / "python")],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["version"] == "0.1.0" and got["init"] == 0 and got["bad_task"] == 0
    he = jbridge.create("embedder", json.dumps({"model": str(dirs["embedder"])}))
    want = json.loads(jbridge.call(he, "embed", '{"text": "hello world"}'))
    jbridge.destroy(he)
    _close(got["embed"], want)
    _close(got["embed_typed"], want["embedding"])
    _close(got["binding_embed"], want["embedding"])
    hc = jbridge.create("classifier", json.dumps({"model": str(dirs["classifier"])}))
    _close(got["classify"], json.loads(jbridge.call(hc, "classify", '{"text": "i love this"}')))
    jbridge.destroy(hc)
    assert got["binding_labels"] == ["NEGATIVE", "POSITIVE"]
    hg = jbridge.create("generator", json.dumps({"model": str(dirs["llama"])}))
    assert got["generate_typed"] == json.loads(jbridge.call(
        hg, "generate", json.dumps({"prompt": "hello world", "max_new_tokens": 5})))
    stream = _pull(jbridge, hg, "generate_stream", {"prompt": "hello world",
                                                    "max_new_tokens": 6, "preset": "greedy"})
    jbridge.destroy(hg)
    assert got["callback"] == got["pull"] == stream and got["callback_n"] == len(stream)
    assert got["early_n"] == 2 and got["early_cancelled"] == 1
    if not torch.cuda.is_available():
        assert "no CUDA device" in got["no_device_error"]


def test_port_compiled_c_host(dirs, built):
    """The port's C host boots the embedded interpreter itself and runs every
    check with device "cpu"."""
    _, host = built
    r = subprocess.run([str(host), str(dirs["embedder"]), str(dirs["classifier"]),
                        str(dirs["llama"]), "cpu"], capture_output=True, text=True,
                       env=_env(), timeout=900)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr[-3000:]}"
    assert r.stdout.startswith("OK ") and "checks" in r.stdout
