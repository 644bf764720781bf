"""The port's server under SPMD (serve.py with --tp / --dp, serve_spmd.py)
against the JAX package's server, on the CPU, over one group of 2 gloo
ranks spawned for the file (tests/torch_dist.py), and under torchrun.

Rank 0 issues each wave of requests from concurrent threads; every model
call goes through its Dispatcher to both ranks. The answers equal the JAX
`_Engine`'s (tp = 2 decoders, dp = 2 encoders, on its virtual devices):
texts exactly, embeddings and scores within 1e-5. Also: both schedulers
and the dynamic batcher at tp = 2, a prefix cache, the OpenAI routes and
SSE streams, a sampled request (rank 0's seed on both ranks), a failure
on every rank (an HTTP error as in one process) and a failure on rank 1
alone (the group ends); `ContinuousEngine` at tp = 2 with and without
`register_prefix` against the JAX DecoderLM's greedy text (which
tests/test_parallel_product.py holds its own tp engine to); two concurrent
HTTP clients against rank 0's server, then its stop; and `torchrun
--nproc-per-node 2 -m kjarni_tpu_torch --device cpu serve --tp 2 --dp 2`,
answering concurrent requests and exiting 0 on SIGINT to rank 0.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.request
from pathlib import Path

import pytest
import torch

import torch_dist as td
from helpers import build_word_tokenizer, save_torch_model, tiny_bert_dir
from kjarni_tpu import serve as jserve
from kjarni_tpu.generate.sampling import GenerationConfig
from kjarni_tpu.models.decoder_lm import DecoderLM as JaxDecoderLM
from kjarni_tpu_torch import serve as tserve
from kjarni_tpu_torch.serve_batching import ContinuousRunner
from kjarni_tpu_torch.serve_spmd import NotReplicated, Replica

REPO = Path(__file__).resolve().parents[1]
GREEDY = {"preset": "greedy", "max_new_tokens": 8}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = td.RankGroup(2, tmp_path_factory.mktemp("ranks2"))
    yield g
    g.close()


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A llama whose heads and FFN divide 2 (greedy generation config) and
    three tiny BERT dirs."""
    from transformers import LlamaConfig, LlamaForCausalLM
    out = {k: tmp_path_factory.mktemp(f"spmd_{k}") for k in ("lm", "clf", "emb", "cross")}
    vm = build_word_tokenizer(out["lm"] / "tokenizer.json", bert_style=False)
    config = LlamaConfig(vocab_size=len(vm), hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                         max_position_embeddings=128, bos_token_id=2, eos_token_id=3,
                         tie_word_embeddings=False)
    torch.manual_seed(11)
    save_torch_model(out["lm"], LlamaForCausalLM(config).eval(), config)
    (out["lm"] / "generation_config.json").write_text(json.dumps({"do_sample": False}))
    tiny_bert_dir(out["clf"], num_labels=2, seed=31)
    tiny_bert_dir(out["emb"], seed=32)
    tiny_bert_dir(out["cross"], num_labels=1, seed=33)
    return {"generate": str(out["lm"]), "chat": str(out["lm"]), "classify": str(out["clf"]),
            "embed": str(out["emb"]), "rerank": str(out["cross"])}


def _jax_answer(engine, req):
    kind, path, body = req
    if kind == "stream":
        it, _ = engine.handle_stream(path, body)
        return {"pieces": [p if isinstance(p, str) else p["choices"][0] for p in it]}
    return engine.handle(path, body)


def _same(got, want):
    """Answers equal but for the OpenAI routes' random ids and times, and
    floats within 1e-5."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (got, want)
        for k in want:
            if k not in ("id", "created"):
                _same(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=1e-5)
    else:
        assert got == want


TP_WAVES = [
    [("post", "/v1/generate", {"prompt": "hello world", **GREEDY}),
     ("post", "/v1/generate", {"prompts": ["hello world", "the doctor said"], **GREEDY}),
     ("post", "/v1/chat", {"message": "hello there", "session": "a"}),
     ("stream", "/v1/generate", {"prompt": "the doctor", "stream": True, **GREEDY})],
    [("post", "/v1/completions", {"prompt": "hello world", "max_tokens": 6,
                                  "temperature": 0}),
     ("stream", "/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                                         "max_tokens": 6, "temperature": 0,
                                         "stream": True}),
     ("post", "/v1/chat", {"message": "and then", "session": "a"}),
     ("post", "/v1/chat", {"message": "hello", "session": "b", "reset": True})],
]


@pytest.mark.parametrize("engine_kw", [
    {}, {"max_batch": 4}, {"scheduler": "continuous", "prompt_prefix": "hello world"}],
    ids=["batch", "batcher", "continuous"])
def test_tp2_engine_equals_jax(group, dirs, engine_kw):
    waves = TP_WAVES
    if engine_kw.get("scheduler") == "continuous":  # takes the prefix path
        waves = [[("post", "/v1/generate", {"prompt": "hello world the doctor", **GREEDY})]
                 + TP_WAVES[0][:1]] + TP_WAVES
    got = group.run(td.spmd_engine, dirs, {"tp": 2, **engine_kw}, waves)
    assert got[1] == "followed"
    jeng = jserve._Engine(dirs, tp=2, **engine_kw)
    for gw, wave in zip(got[0], waves):
        for g, req in zip(gw, wave):
            _same(g, _jax_answer(jeng, req))


DP_WAVE = [("post", "/v1/embed", {"texts": ["hello world", "the doctor", "a b c"]}),
           ("post", "/v1/embed", {"text": "hello"}),
           ("post", "/v1/similarity", {"a": "hello world", "b": "the doctor"}),
           ("post", "/v1/classify", {"texts": ["good movie", "bad movie", "fine"]}),
           ("post", "/v1/rerank", {"query": "doctor", "documents": ["the doctor", "hello",
                                                                   "world peace"]})]


def test_dp2_engine_equals_jax(group, dirs):
    got = group.run(td.spmd_engine, dirs, {"dp": 2}, [DP_WAVE])
    jeng = jserve._Engine(dirs, dp=2)
    for g, req in zip(got[0][0], DP_WAVE):
        _same(g, _jax_answer(jeng, req))


def test_sampled_and_failing_requests(group, dirs):
    """A sampled request without a seed runs on both ranks (rank 0's seed);
    a request that fails on every rank answers its error, and the group
    serves on."""
    waves = [[("post", "/v1/generate", {"prompt": "hello", "preset": "creative",
                                        "max_new_tokens": 6})],
             [("post", "/v1/generate", {"prompt": "hello", "preset": "nonesuch"})],
             [("post", "/v1/generate", {"prompt": "hello world", **GREEDY})]]
    got = group.run(td.spmd_engine, dirs, {"tp": 2}, waves)
    assert got[1] == "followed"
    assert isinstance(got[0][0][0]["text"], str)
    assert "nonesuch" in got[0][1][0]["error"]
    want = JaxDecoderLM(dirs["generate"]).generate(
        "hello world", config=GenerationConfig(strategy="greedy", max_new_tokens=8))
    assert got[0][2][0] == {"text": want}


def test_a_rank_failing_alone_ends_the_group(group, dirs):
    """Building the embed model raises on rank 1 alone (a planted fault):
    both ranks end with the divergence, and a later request is refused."""
    waves = [[("post", "/v1/embed", {"text": "hello"})],
             [("post", "/v1/generate", {"prompt": "hello world", **GREEDY})]]
    got = group.run(td.spmd_engine, dirs, {}, waves, "embed")
    for answer in (got[0][0][0]["error"], got[0][1][0]["error"], got[1]):
        assert answer.startswith("SpmdError: the ranks diverged on 'get' "
                                 "(failed on ranks [1] alone: rank 1: RuntimeError: "
                                 "planted fault)")


@pytest.mark.parametrize("prefix", [None, "hello world"])
def test_continuous_engine_tp2(group, dirs, prefix):
    cfg = GenerationConfig(strategy="greedy", max_new_tokens=12)
    want = JaxDecoderLM(dirs["generate"], max_context=64).generate("hello world the doctor",
                                                                    config=cfg)
    got = group.run(td.continuous_tp, dirs["generate"], "hello world the doctor", prefix, 12)
    assert got == [want, want]


def test_http_clients_against_rank0_then_stop(group, dirs):
    reqs = [("/v1/generate", {"prompt": "hello world", **GREEDY}),
            ("/v1/generate", {"prompt": "the doctor said", **GREEDY}),
            ("/v1/embed", {"text": "hello"})]
    got = group.run(td.http_spmd, dirs, {"tp": 2, "dp": 2}, reqs)
    assert got[1] == "followed"
    jeng = jserve._Engine(dirs, tp=2, dp=2)
    for (code, out), (path, body) in zip(got[0], reqs):
        assert code == 200
        _same(out, jeng.handle(path, body))


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=td.TIMEOUT_S) as r:
        return json.loads(r.read())


def test_torchrun_serve_tp2_dp2(dirs, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "kjarni_tpu_torch", "--device", "cpu", "serve",
           "--tp", "2", "--dp", "2", "--port", "0",
           "--models", f"generate={dirs['generate']}", "--models", f"embed={dirs['embed']}"]
    proc = subprocess.Popen(cmd, cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        line = ""
        while "kjarni serving on" not in line:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, "the server exited before serving"
        m = re.search(r"(http://\S+) \(rank 0 of 2, pid (\d+)\)", line)
        base, pid = m.group(1), int(m.group(2))
        reqs = [("/v1/generate", {"prompt": "hello world", **GREEDY}),
                ("/v1/generate", {"prompt": "the doctor said", **GREEDY}),
                ("/v1/embed", {"texts": ["hello", "the doctor"]})]
        got = [None] * len(reqs)

        def one(i):
            got[i] = _post(base, *reqs[i])
        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        jeng = jserve._Engine(dirs, tp=2, dp=2)
        for g, (path, body) in zip(got, reqs):
            _same(g, jeng.handle(path, body))
        os.kill(pid, signal.SIGINT)
        assert proc.wait(timeout=td.TIMEOUT_S) == 0, proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


class _NoGroup:
    """A Dispatcher stand-in that fails the test if anything is dispatched."""

    def call(self, op):
        raise AssertionError(f"dispatched {op!r}")


def test_replica_refuses_an_unlisted_attribute():
    """A task's or a model's attribute that is neither dispatched nor a local
    read raises before it runs: on rank 0 alone it would leave the other
    ranks out of its collectives and hang the group."""
    lm = types.SimpleNamespace(tokenizer="tok", max_context=64, reset=lambda: None)
    task = types.SimpleNamespace(model_id="m", _lm=lm, warm_up=lambda: None)
    r = Replica(_NoGroup(), (("generate", "m"), None), task, {})
    assert (r.model_id, r._lm.tokenizer, r._lm.max_context) == ("m", "tok", 64)
    assert r._lm is r._lm       # one handle per model
    with pytest.raises(NotReplicated, match="'warm_up' of .*generate"):
        r.warm_up()
    with pytest.raises(NotReplicated, match="'reset'"):
        r._lm.reset()


class _Eng:
    """A ContinuousEngine stand-in: the runner reads only these."""
    S, num_active, num_waiting = 8, 0, 0


def test_continuous_runner_fails_every_request_when_a_window_raises():
    """A request admitted in an earlier window and one waiting in the
    failing window's burst both get the window's error; the runner stops
    instead of calling the failing window again, and the server replaces it
    with a new runner over a new engine."""
    eng, calls = _Eng(), []

    def window(reqs):
        calls.append(len(reqs))
        if len(calls) == 1:
            while not runner._incoming:      # the second request joins the next window
                time.sleep(0.001)
            eng.num_active = 1
            return [0], []
        raise RuntimeError("window fault")
    runner = ContinuousRunner(eng, window)
    errors = []

    def one(prompt):
        with pytest.raises(RuntimeError) as e:
            runner.submit(prompt)
        errors.append(str(e.value))
    first = threading.Thread(target=one, args=("hello",))
    first.start()
    while not calls:
        time.sleep(0.001)
    second = threading.Thread(target=one, args=("world",))
    second.start()
    for t in (first, second):
        t.join(timeout=td.TIMEOUT_S)
    assert errors == ["window fault", "window fault"] and calls == [1, 1]
    assert runner.stopped
    with pytest.raises(RuntimeError, match="shut down"):
        runner.submit("again")

    server = tserve._Engine(scheduler="continuous", device="cpu")
    ops = []

    def replicated(op):
        ops.append(op[0])
        if op[0] == "continuous":
            return _Eng()
        raise RuntimeError("window fault")
    server._replicated = replicated
    gen = types.SimpleNamespace(model_id="m")
    r1 = server._continuous(gen)
    with pytest.raises(RuntimeError, match="window fault"):
        r1.submit("hello")
    r2 = server._continuous(gen)
    assert r2 is not r1 and not r2.stopped and r2 is server._continuous(gen)
    assert ops == ["continuous", "advance", "continuous"]
    r2.shutdown()
