"""The port's HTTP server (serve.py, serve_batching.py, serve_openai.py) and
its watchdog against the JAX package's, on the CPU.

Two loopback servers, one over each package, serve the same tiny dirs (BERT
classifier, embedder and cross-encoder from tests/helpers.py; a one-layer
llama for generate and chat); the port's runs with `device="cpu"`. Every
answer is compared: health, models, classify, embed, similarity, rerank
(scores within 1e-5), generate (single, batch and under the continuous
scheduler: texts equal), chat sessions, both OpenAI routes (texts, finish
reasons and usage equal) and their SSE streams, batch_stats, and the error
codes. A tp > 1 server outside a process group answers an HTTP 400 that
names torchrun (the server under SPMD is tests/test_torch_serve_tp.py)
(/v1/search is held in tests/test_torch_search_tasks.py). A request whose device work outlives the watchdog's deadline
answers 503.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from helpers import build_word_tokenizer, save_torch_model, tiny_bert_dir

from kjarni_tpu import serve as jserve
from kjarni_tpu_torch import serve as tserve
from kjarni_tpu_torch.core.errors import DeviceTimeoutError, KjarniError
from kjarni_tpu_torch.core.watchdog import block_with_timeout, call_with_timeout


def post(base, path, payload, timeout=120):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.status, json.loads(r.read())


def sse(base, path, payload):
    """The data frames of an SSE answer, [DONE] last."""
    req = urllib.request.Request(base + path, data=json.dumps(dict(payload, stream=True))
                                 .encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        frames = [line[6:] for line in r.read().decode().split("\n") if line.startswith("data: ")]
    assert frames[-1] == "[DONE]"
    return [json.loads(f) for f in frames[:-1]]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    from transformers import LlamaConfig, LlamaForCausalLM
    out = {k: tmp_path_factory.mktemp(f"serve_{k}") for k in ("clf", "emb", "cross", "lm")}
    tiny_bert_dir(out["clf"], num_labels=2, seed=31)
    tiny_bert_dir(out["emb"], seed=32)
    tiny_bert_dir(out["cross"], num_labels=1, seed=33)
    vm = build_word_tokenizer(out["lm"] / "tokenizer.json", bert_style=False)
    config = LlamaConfig(vocab_size=len(vm), hidden_size=32, intermediate_size=64,
                         num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2,
                         max_position_embeddings=64, bos_token_id=2, eos_token_id=3,
                         tie_word_embeddings=False)
    torch.manual_seed(91)
    save_torch_model(out["lm"], LlamaForCausalLM(config).eval(), config)
    # greedy by default, so that /v1/chat (which takes no preset) compares ids
    (out["lm"] / "generation_config.json").write_text(json.dumps({"do_sample": False}))
    return {"classify": str(out["clf"]), "embed": str(out["emb"]),
            "rerank": str(out["cross"]), "generate": str(out["lm"]), "chat": str(out["lm"])}


def _start(mod, models, **kw):
    engine = mod._Engine(models, **kw)
    srv = mod.KjarniHTTPServer(("127.0.0.1", 0), mod.make_handler(engine))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_port}", engine


@pytest.fixture(scope="module")
def servers(dirs):
    """(JAX base, port base) per scheduler; started lazily, shut down at
    the end of the module."""
    started, live = {}, []

    def pair(scheduler="batch", **kw):
        key = (scheduler, tuple(sorted(kw.items())))
        if key not in started:
            j = _start(jserve, dirs, scheduler=scheduler, **kw)
            t = _start(tserve, dirs, scheduler=scheduler, device="cpu", **kw)
            live.extend((j[0], t[0]))
            started[key] = (j[1], t[1], j[2], t[2])
        return started[key]
    yield pair
    for srv in live:
        srv.shutdown()


def test_health_and_models(servers):
    jb, tb, _, _ = servers()
    assert get(tb, "/health") == get(jb, "/health") == (200, {"status": "ok"})
    (jc, jm), (tc, tm) = get(jb, "/v1/models"), get(tb, "/v1/models")
    assert tc == jc == 200
    assert [(m["name"], m["task"], m["architecture"]) for m in tm["models"]] == \
        [(m["name"], m["task"], m["architecture"]) for m in jm["models"]]
    assert tm["data"] == jm["data"] and tm["object"] == "list"
    code, out = post(tb, "/v1/nope", {})
    assert code == post(jb, "/v1/nope", {})[0] == 400 and "unknown endpoint" in out["error"]


@pytest.mark.parametrize("path,body", [
    ("/v1/classify", {"text": "i love this product"}),
    ("/v1/classify", {"texts": ["i love this product", "terrible quality"]}),
    ("/v1/embed", {"text": "hello world"}),
    ("/v1/embed", {"texts": ["a doctor", "the nurse was good"]}),
    ("/v1/similarity", {"a": "doctor", "b": "the physician"}),
    ("/v1/rerank", {"query": "a good doctor", "top_k": 2,
                    "documents": ["the nurse", "a great physician", "mondays"]}),
], ids=["classify", "classify_batch", "embed", "embed_batch", "similarity", "rerank"])
def test_encoder_endpoints_equal_jax(servers, path, body):
    jb, tb, _, _ = servers()
    (jc, jo), (tc, to) = post(jb, path, body), post(tb, path, body)
    assert tc == jc == 200
    if path == "/v1/classify":
        for j, t in zip(jo.get("results", [jo]), to.get("results", [to])):
            assert t["label"] == j["label"] and t["score"] == pytest.approx(j["score"], abs=1e-5)
            assert t["all_scores"] == pytest.approx(j["all_scores"], abs=1e-5)
    elif path == "/v1/embed":
        key = "embeddings" if "texts" in body else "embedding"
        assert to["dim"] == jo["dim"]
        np.testing.assert_allclose(to[key], jo[key], atol=1e-5)
    elif path == "/v1/similarity":
        assert to["similarity"] == pytest.approx(jo["similarity"], abs=1e-5)
    else:
        assert [r["index"] for r in to["results"]] == [r["index"] for r in jo["results"]]
        assert [r["text"] for r in to["results"]] == [r["text"] for r in jo["results"]]
        np.testing.assert_allclose([r["score"] for r in to["results"]],
                                   [r["score"] for r in jo["results"]], atol=1e-5)


GEN = {"prompt": "hello world the doctor", "max_new_tokens": 6, "preset": "greedy"}


@pytest.mark.parametrize("body", [GEN, dict(GEN, prompts=["hello world", "the nurse is good",
                                                         "data is safe"])],
                         ids=["single", "batch"])
def test_generate_equals_jax(servers, body):
    jb, tb, _, _ = servers()
    (jc, jo), (tc, to) = post(jb, "/v1/generate", body), post(tb, "/v1/generate", body)
    assert tc == jc == 200 and to == jo


def test_continuous_scheduler_equals_jax_and_batch(servers):
    """Concurrent greedy requests join the port's ContinuousEngine and answer
    the text of the batch scheduler and of the JAX server; then sequential
    requests leave equal batch_stats."""
    jb, tb, _, _ = servers()
    expected = post(jb, "/v1/generate", GEN)[1]["text"]
    jc_base, tc_base, _, t_engine = servers("continuous", max_batch=4)
    results, barrier = {}, threading.Barrier(4)

    def client(i):
        barrier.wait()
        results[i] = post(tc_base, "/v1/generate", GEN)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(r == (200, {"text": expected}) for r in results.values())
    code, out = post(tc_base, "/v1/generate", dict(GEN, preset="creative", max_new_tokens=3))
    assert code == 200 and isinstance(out["text"], str)
    # a fresh pair, requests one at a time: the engines' counters agree
    jc_base, tc_base, _, _ = servers("continuous", max_batch=2, steps_per_sync=4)
    for prompt in ("hello world", "the doctor went to the nurse", "data is safe"):
        body = dict(GEN, prompt=prompt)
        assert post(tc_base, "/v1/generate", body) == post(jc_base, "/v1/generate", body)
    (_, js), (_, ts) = post(jc_base, "/v1/batch_stats", {}), post(tc_base, "/v1/batch_stats", {})
    assert ts == js and list(ts["continuous"].values())[0]["finished"] == 3


def test_prompt_prefix_hits_and_equal_text(servers):
    jb, tb, _, _ = servers()
    prefix = "hello world the doctor"
    jcb, tcb, _, _ = servers("continuous", prompt_prefix=(prefix,))
    for tail in (" went to the nurse", " is good"):
        body = dict(GEN, prompt=prefix + tail)
        t = post(tcb, "/v1/generate", body)
        assert t == post(jcb, "/v1/generate", body) == post(tb, "/v1/generate", body)
    stats = list(post(tcb, "/v1/batch_stats", {})[1]["continuous"].values())[0]
    assert stats["prefix_hits"] == 2


def test_chat_sessions_equal_jax(servers):
    jb, tb, _, _ = servers()
    for msg, session in (("hello", "s1"), ("the doctor", "s1"), ("hello", "s2")):
        body = {"message": msg, "session": session}
        (jc, jo), (tc, to) = post(jb, "/v1/chat", body), post(tb, "/v1/chat", body)
        assert tc == jc == 200 and to == jo


@pytest.mark.parametrize("scheduler", ["batch", "continuous"])
@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "hello world the doctor", "max_tokens": 8,
                         "temperature": 0}),
    ("/v1/completions", {"prompt": ["hello world", "the nurse"], "max_tokens": 5,
                         "temperature": 0, "stop": ["the"]}),
    ("/v1/chat/completions", {"messages": [{"role": "system", "content": "be good"},
                                           {"role": "user", "content": "hello doctor"}],
                              "max_tokens": 8, "temperature": 0}),
], ids=["completion", "completion_stop", "chat"])
def test_openai_routes_equal_jax(servers, scheduler, path, body):
    jb, tb, _, _ = servers(scheduler)
    (jc, jo), (tc, to) = post(jb, path, body), post(tb, path, body)
    assert tc == jc == 200
    for k in ("id", "created"):
        jo.pop(k), to.pop(k)
    assert to == jo


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "hello world the doctor", "max_tokens": 8,
                         "temperature": 0}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hello doctor"}],
                              "max_tokens": 8, "temperature": 0}),
    ("/v1/generate", dict(GEN)),
], ids=["completion", "chat", "generate"])
def test_sse_streams_equal_jax(servers, path, body):
    jb, tb, _, _ = servers()
    j, t = sse(jb, path, body), sse(tb, path, body)
    strip = [{k: v for k, v in f.items() if k not in ("id", "created")} for f in t]
    assert strip == [{k: v for k, v in f.items() if k not in ("id", "created")} for f in j]
    assert len(t) > 1


@pytest.mark.parametrize("path,body,code", [
    ("/v1/classify", {"wrong_key": 1}, 400),
    ("/v1/completions", {"prompt": [], "max_tokens": 4}, 400),
    ("/v1/completions", {"prompt": "hi", "n": 9}, 400),
    ("/v1/chat/completions", {"messages": [{"role": "robot", "content": "x"}]}, 400),
], ids=["bad_key", "empty_prompt_list", "n_too_large", "bad_role"])
def test_error_codes_equal_jax(servers, path, body, code):
    jb, tb, _, _ = servers()
    (jc, jo), (tc, to) = post(jb, path, body), post(tb, path, body)
    assert tc == jc == code and to == jo


def test_refusals_name_the_roadmap_item(dirs):
    srv, base, _ = _start(tserve, dirs, device="cpu", tp=2)
    try:
        code, out = post(base, "/v1/generate", GEN)
        assert code == 400 and "torchrun --nproc-per-node 2" in out["error"]
    finally:
        srv.shutdown()
    with pytest.raises(KjarniError, match="unknown scheduler"):
        tserve._Engine({}, scheduler="vllm")
    with pytest.raises(KjarniError, match="--prompt-prefix"):
        tserve._Engine({}, prompt_prefix="x")


def test_no_card_means_no_cpu_fallback(dirs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run on it")
    srv, base, _ = _start(tserve, dirs)
    try:
        code, out = post(base, "/v1/generate", GEN)
        assert code == 400 and "device='cpu'" in out["error"]
    finally:
        srv.shutdown()


def test_parse_model_overrides_and_main_flags():
    assert tserve.parse_model_overrides(["generate=/a", "chat=b"]) == \
        jserve.parse_model_overrides(["generate=/a", "chat=b"])
    with pytest.raises(SystemExit):
        tserve.parse_model_overrides(["oops"])


class TestWatchdog:
    def test_fast_call_and_disabled_deadline(self):
        assert call_with_timeout(lambda: 41 + 1, 5.0) == 42
        assert call_with_timeout(lambda: "inline", None) == "inline"

    def test_stuck_call_raises_typed_error(self):
        release = threading.Event()
        t0 = time.perf_counter()
        with pytest.raises(DeviceTimeoutError, match="deadline"):
            call_with_timeout(lambda: release.wait(10), 0.2, "stuck op")
        assert time.perf_counter() - t0 < 5
        release.set()

    def test_exception_propagates(self):
        with pytest.raises(ValueError, match="boom"):
            call_with_timeout(lambda: (_ for _ in ()).throw(ValueError("boom")), 1.0)

    def test_block_with_timeout_returns_tree(self):
        tree = {"a": torch.arange(4)}
        assert block_with_timeout(tree, 10.0) is tree
        assert block_with_timeout(tree, None) is tree

    def test_wedged_request_answers_503(self):
        release = threading.Event()

        class StuckEngine:
            request_timeout_s = 0.2

            def handle(self, path, body):
                release.wait(30)
                return {"text": "never"}

        srv = tserve.KjarniHTTPServer(("127.0.0.1", 0), tserve.make_handler(StuckEngine()))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            t0 = time.perf_counter()
            code, out = post(f"http://127.0.0.1:{srv.server_port}", "/v1/generate",
                             {"prompt": "hi"}, timeout=10)
            assert code == 503 and "deadline" in out["error"]
            assert time.perf_counter() - t0 < 8
        finally:
            release.set()
            srv.shutdown()
