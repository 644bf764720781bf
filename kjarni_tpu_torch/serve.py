"""HTTP serving: the task APIs over JSON endpoints (port of
kjarni_tpu/serve.py, over kjarni_tpu_torch's tasks).

A dependency-free stdlib HTTP server wrapping the task objects:

  POST /v1/classify   {"text": ..., "model": ...}
  POST /v1/embed      {"text": ... | "texts": [...]}
  POST /v1/similarity {"a": ..., "b": ...}
  POST /v1/rerank     {"query": ..., "documents": [...]}
  POST /v1/search     {"index": ..., "query": ..., "mode": ...}
  POST /v1/generate   {"prompt": ..., "max_new_tokens": ...}
  POST /v1/chat       {"message": ...} (stateful per session id)
  POST /v1/completions, /v1/chat/completions (OpenAI shape, serve_openai.py)
  GET  /v1/batch_stats, /v1/models, /health

Models run on the CUDA card unless `device="cpu"` (`--device cpu`) is given.
Tensor-parallel decoders (`--tp N`) and data-parallel encoders (`--dp N`)
run under `torchrun --nproc-per-node N`: rank 0 serves HTTP and every model
call it makes runs on every rank, issued from one thread in one order
(serve_spmd.py); the other ranks follow.

Run: python -m kjarni_tpu_torch.serve --port 8000
     torchrun --nproc-per-node 2 -m kjarni_tpu_torch.serve --tp 2 --models generate=DIR
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from . import registry
from .core.errors import KjarniError


class KjarniHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog sized for request bursts
    (the stdlib default of 5 drops connections under concurrent load)."""
    request_queue_size = 128
    daemon_threads = True


class _Engine:
    """Lazy per-model task cache shared by all request threads."""

    def __init__(self, default_models: dict[str, str] | None = None,
                 quiet: bool = True, max_batch: int = 1,
                 batch_window_ms: float = 10.0, scheduler: str = "batch",
                 draft_model: str | None = None, draft_num_tokens: int = 4,
                 request_timeout_s: float | None = None,
                 tp: int | None = None, dp: int | None = None,
                 steps_per_sync: int = 16,
                 prompt_prefix: str | list | None = None,
                 kv_cache: str | None = None,
                 device: str | None = None):
        if scheduler not in ("batch", "continuous"):
            raise KjarniError(f"unknown scheduler '{scheduler}' "
                              f"(expected 'batch' or 'continuous')")
        if prompt_prefix and scheduler != "continuous":
            raise KjarniError(
                "--prompt-prefix is a continuous-scheduler feature; it "
                "would be silently ignored under --scheduler batch — add "
                "--scheduler continuous")
        self.scheduler = scheduler
        self._lock = threading.Lock()
        self._cache: dict[tuple[str, str], Any] = {}
        # dynamic request batching (serve_batching.py): group concurrent
        # /v1/generate requests with matching params into one batched decode
        self.max_batch = max_batch
        self.batch_window_ms = batch_window_ms
        self._batchers: dict[str, Any] = {}
        self._continuous_runners: dict[str, Any] = {}
        # continuous scheduler: max decode iterations fused per dispatch
        # (actual window adapts down; see generate/continuous.py)
        self.steps_per_sync = steps_per_sync
        # shared-prefix prompt cache for the continuous scheduler
        self.prompt_prefix = prompt_prefix
        # DecoderLM mutates shared state across a generation (reused KV cache,
        # session prefix) — one generation per underlying model at a time.
        # Keyed by id(lm) so chat sessions sharing a DecoderLM share the lock.
        self._model_locks: dict[int, threading.Lock] = {}
        # per-key creation locks: two concurrent first requests for the same
        # model (or chat session) must not both construct — one would load the
        # weights twice / silently discard the other's conversation state.
        self._creation_locks: dict[tuple, threading.Lock] = {}
        self.defaults = {
            "classify": "distilbert-sentiment",
            "embed": "minilm-l6-v2",
            "rerank": "minilm-l6-v2-cross-encoder",
            "generate": "qwen2.5-0.5b-instruct",
            "chat": "qwen2.5-0.5b-instruct",
            "search": "minilm-l6-v2",
        }
        self.defaults.update(default_models or {})
        self.quiet = quiet
        # where the models run: None is the card, "cpu" the host
        self.device = device
        # tensor-parallel decoders / data-parallel encoders, under SPMD: the
        # task constructors check the process group's size
        self.tp = tp
        self.dp = dp
        # rank 0 of a group of several ranks: the Dispatcher every model
        # call goes through (serve_spmd.py), and the Replica handles it gives
        self._spmd = None
        self._replicas: dict = {}
        self._streams: dict = {}
        self._engines: dict = {}
        # speculative decoding for /v1/generate (greedy requests)
        self.draft_model = draft_model
        self.draft_num_tokens = draft_num_tokens
        # kv_cache="int8": the int8 slot caches of models/llama.py
        self.kv_cache = kv_cache
        # device-hang watchdog (gpu_ops/timeout.rs analogue): bound each
        # request body; a wedged device yields 503, not a hung connection
        from .core.watchdog import DEFAULT_TIMEOUT_S
        self.request_timeout_s = (request_timeout_s
                                  if request_timeout_s is not None
                                  else DEFAULT_TIMEOUT_S)

    def _creation_lock(self, key: tuple) -> threading.Lock:
        with self._lock:
            lock = self._creation_locks.get(key)
            if lock is None:
                lock = self._creation_locks[key] = threading.Lock()
        return lock

    def get(self, kind: str, model: str | None):
        model = model or self.defaults[kind]
        key = (kind, model)
        with self._creation_lock(key):
            with self._lock:
                obj = self._cache.get(key)
            if obj is None:
                obj = self._replicated(("get", kind, model))
        return self._replica(key, obj)

    # -- SPMD ------------------------------------------------------------
    # Under a group of several ranks each model call below is an op that
    # every rank runs in the same order (serve_spmd.py); with one process
    # `_replicated` runs it here and `_replica` returns the object itself.
    # An op takes no lock of this engine beyond `_lock` for a moment: the
    # request threads hold the model and creation locks while they wait.

    def _replicated(self, op: tuple):
        return self._apply(op) if self._spmd is None else self._spmd.call(op)

    def _replica(self, key: tuple, obj):
        if self._spmd is None:
            return obj
        from .serve_spmd import Replica
        with self._lock:
            r = self._replicas.get((key, None))
            if r is None:
                r = self._replicas[(key, None)] = Replica(self._spmd, (key, None), obj,
                                                          self._replicas)
        return r

    def _resolve(self, key: tuple):
        cache_key, attr = key
        obj = self._cache[cache_key]
        return getattr(obj, attr) if attr else obj

    def _get_local(self, kind: str, model: str):
        with self._lock:
            obj = self._cache.get((kind, model))
        if obj is None:
            obj = self._construct(kind, model)
            with self._lock:
                self._cache[(kind, model)] = obj
        return obj

    def _apply(self, op: tuple):
        """Run one op on this rank (module docstring of serve_spmd.py)."""
        name, *args = op
        if name == "get":
            return self._get_local(*args)
        if name == "call":
            key, method, a, kw = args
            return getattr(self._resolve(key), method)(*a, **kw)
        if name == "stream_open":
            sid, key, method, a, kw = args
            self._streams[sid] = iter(getattr(self._resolve(key), method)(*a, **kw))
            return None
        if name == "stream_next":
            try:
                return True, next(self._streams[args[0]])
            except StopIteration:
                del self._streams[args[0]]
                return False, None
        if name == "stream_close":
            it = self._streams.pop(args[0], None)
            if hasattr(it, "close"):
                it.close()
            return None
        if name == "chat_session":
            return self._chat_session_local(*args)
        if name == "continuous":
            # a new engine on the first loaded decoder of this model id
            from .serve_batching import new_engine
            lm = next(t._lm for k, t in self._cache.items()
                      if k[0] in ("generate", "chat") and t.model_id == args[0])
            self._engines[args[0]] = new_engine(
                lm, slots=self._slots(), steps_per_sync=self.steps_per_sync,
                cached_prefix=self.prompt_prefix)
            return self._engines[args[0]]
        if name == "advance":
            from .serve_batching import advance
            return advance(self._engines[args[0]], args[1])
        if name == "noop":
            return None
        raise KjarniError(f"unknown server op '{name}'")

    def _construct(self, kind: str, model: str):
        dev = self.device
        if kind == "classify":
            from .tasks.classifier import Classifier
            obj = Classifier(model, quiet=self.quiet, dp=self.dp, device=dev)
        elif kind == "embed":
            from .tasks.embedder import Embedder
            obj = Embedder(model, quiet=self.quiet, dp=self.dp, device=dev)
        elif kind == "rerank":
            from .tasks.reranker import Reranker
            obj = Reranker(model, quiet=self.quiet, dp=self.dp, device=dev)
        elif kind in ("generate",):
            from .tasks.generator import Generator
            obj = Generator(model, quiet=self.quiet,
                            tp=self.tp, kv_cache=self.kv_cache,
                            draft_model=self.draft_model,
                            draft_num_tokens=self.draft_num_tokens, device=dev)
        elif kind == "chat":
            from .tasks.chat import Chat
            obj = Chat(model, quiet=self.quiet, tp=self.tp,
                       kv_cache=self.kv_cache, device=dev)
        elif kind == "search":
            from .tasks.searcher import Searcher
            obj = Searcher(model, quiet=self.quiet, device=dev)
        else:
            raise KjarniError(f"unknown task kind '{kind}'")
        return obj

    def _lm_lock(self, lm) -> threading.Lock:
        # keyed by the model itself: a Replica handle stands for its target
        key = id(getattr(lm, "_target", lm))
        with self._lock:
            lock = self._model_locks.get(key)
            if lock is None:
                lock = self._model_locks[key] = threading.Lock()
        return lock

    def _slots(self) -> int:
        return self.max_batch if self.max_batch > 1 else 8

    def _continuous(self, gen):
        """One ContinuousRunner per loaded generator model, over an engine
        that the `continuous` op builds (on every rank under SPMD); each of
        its windows is an `advance` op. A runner that stopped on a failed
        window is replaced, with a new engine."""
        from .serve_batching import ContinuousRunner
        m = gen.model_id
        with self._creation_lock(("continuous", m)):
            with self._lock:
                r = self._continuous_runners.get(m)
            if r is None or r.stopped:
                eng = self._replicated(("continuous", m))
                r = ContinuousRunner(eng, lambda reqs: self._replicated(("advance", m, reqs)))
                with self._lock:
                    self._continuous_runners[m] = r
        return r

    def _batcher(self, gen):
        """One DynamicBatcher per loaded generator model."""
        from .serve_batching import DynamicBatcher
        lock = self._lm_lock(gen._lm)

        def run_locked(prompts, **kw):
            with lock:
                return gen.generate_batch(prompts, **kw)

        with self._lock:
            b = self._batchers.get(gen.model_id)
            if b is None:
                b = DynamicBatcher(run_locked,
                                   max_batch=self.max_batch,
                                   max_wait_ms=self.batch_window_ms)
                self._batchers[gen.model_id] = b
        return b

    def _chat_session(self, body: dict):
        """Per-session Chat sharing the base task's DecoderLM weights."""
        model = body.get("model") or self.defaults["chat"]
        session = body.get("session", "default")
        key = ("chat-session", model, session)
        with self._creation_lock(key):
            with self._lock:
                chat = self._cache.get(key)
            if chat is None:
                self.get("chat", model)
                chat = self._replicated(("chat_session", model, session))
        chat = self._replica(key, chat)
        if body.get("reset"):
            chat.clear_history(keep_system=True)
        return chat, session

    def _chat_session_local(self, model: str, session: str):
        key = ("chat-session", model, session)
        with self._lock:
            chat = self._cache.get(key)
        if chat is not None:
            return chat
        from .tasks.chat import Chat
        base = self._get_local("chat", model)
        # Chat owns its conversation; construct per session but
        # reuse the underlying DecoderLM weights from the base task
        chat = Chat.__new__(Chat)
        chat.device = base.device
        chat.model_info = base.model_info
        chat.model_id = base.model_id
        chat._lm = base._lm
        chat._spec = base._spec
        from .chat_templates import Conversation
        sp = base._lm.chat_template.default_system_prompt()
        chat._conversation = (Conversation.with_system(sp) if sp
                              else Conversation())
        with self._lock:
            self._cache[key] = chat
        return chat

    def handle_stream(self, path: str, body: dict):
        """SSE path for {"stream": true} generate/chat requests.

        Returns (token-text iterator, CancellationToken). The iterator holds
        the model lock for its whole lifetime (closing it releases the lock);
        cancelling the token stops the decode loop at the next step — the
        handler cancels on client disconnect.
        """
        from .core.cancellation import CancellationToken
        cancel = CancellationToken()
        model = body.get("model")
        if path == "/v1/generate":
            gen = self.get("generate", model)
            kw = {k: body[k] for k in ("max_new_tokens", "preset")
                  if k in body}
            lock = self._lm_lock(gen._lm)

            def run():
                with lock, contextlib.closing(gen.generate_stream(
                        body["prompt"], cancellation=cancel, **kw)) as steps:
                    for st in steps:
                        yield st.text
            return run(), cancel
        if path == "/v1/chat":
            chat, _session = self._chat_session(body)
            lock = self._lm_lock(chat._lm)

            def run():
                with lock, contextlib.closing(chat.stream(
                        body["message"], cancellation=cancel)) as steps:
                    for st in steps:
                        yield st.text
            return run(), cancel
        if path in ("/v1/completions", "/v1/chat/completions"):
            from . import serve_openai
            return serve_openai.stream(self, path, body)
        raise KjarniError(f"streaming not supported for {path}")

    # ------------------------------------------------------------------

    def handle(self, path: str, body: dict) -> dict:
        model = body.get("model")
        if path == "/v1/completions":
            from . import serve_openai
            return serve_openai.completion(self, body)
        if path == "/v1/chat/completions":
            from . import serve_openai
            return serve_openai.chat_completion(self, body)
        if path == "/v1/classify":
            clf = self.get("classify", model)
            if "texts" in body:
                return {"results": [
                    {"label": r.label, "score": r.score,
                     "all_scores": dict(r.all_scores)}
                    for r in clf.classify_batch(body["texts"])]}
            r = clf.classify(body["text"])
            return {"label": r.label, "score": r.score,
                    "all_scores": dict(r.all_scores)}
        if path == "/v1/embed":
            emb = self.get("embed", model)
            if "texts" in body:
                vecs = emb.embed_batch(body["texts"])
                return {"dim": int(vecs.shape[1]) if len(vecs) else emb.dim,
                        "embeddings": [[float(x) for x in v] for v in vecs]}
            v = emb.embed(body["text"])
            return {"dim": len(v), "embedding": [float(x) for x in v]}
        if path == "/v1/similarity":
            emb = self.get("embed", model)
            return {"similarity": emb.similarity(body["a"], body["b"])}
        if path == "/v1/rerank":
            rr = self.get("rerank", model)
            results = rr.rerank(body["query"], body["documents"])
            top_k = body.get("top_k")
            if top_k:
                results = results[:top_k]
            return {"results": [{"index": r.index, "score": r.score,
                                 "text": r.text} for r in results]}
        if path == "/v1/generate":
            gen = self.get("generate", model)
            kw = {}
            for k in ("max_new_tokens", "preset"):
                if k in body:
                    kw[k] = body[k]
            if "prompts" in body:
                with self._lm_lock(gen._lm):
                    return {"texts": gen.generate_batch(body["prompts"], **kw)}
            if self.scheduler == "continuous":
                from .tasks.generator import PRESETS
                preset_cfg = PRESETS.get(kw.get("preset") or "greedy")
                if preset_cfg is not None:
                    sampling = (None if preset_cfg.strategy == "greedy"
                                else preset_cfg.sampling)
                    runner = self._continuous(gen)
                    return {"text": runner.submit(
                        body["prompt"],
                        max_new_tokens=kw.get("max_new_tokens", 128),
                        sampling=sampling, seed=body.get("seed"))}
            if self.max_batch > 1:
                return {"text": self._batcher(gen).submit(body["prompt"], **kw)}
            with self._lm_lock(gen._lm):
                return {"text": gen.generate(body["prompt"], **kw)}
        if path == "/v1/batch_stats":
            return {"batch_sizes": {m: list(b.batch_sizes)
                                    for m, b in self._batchers.items()},
                    "continuous": {m: {"active": r._engine.num_active,
                                       "waiting": r._engine.num_waiting,
                                       **r._engine.stats}
                                   for m, r in self._continuous_runners.items()}}
        if path == "/v1/chat":
            # per-session conversation state: {"session": "abc"} isolates users
            chat, session = self._chat_session(body)
            with self._lm_lock(chat._lm):
                return {"reply": chat.send(body["message"]),
                        "session": session}
        if path == "/v1/search":
            s = self.get("search", model)
            results = s.search(body["index"], body["query"],
                               mode=body.get("mode", "hybrid"),
                               top_k=body.get("top_k", 10))
            return {"results": [{"score": r.score, "text": r.text,
                                 "metadata": r.metadata} for r in results]}
        raise KjarniError(f"unknown endpoint {path}")


def make_handler(engine: _Engine):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, payload: dict):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, {"status": "ok"})
            elif self.path == "/v1/models":
                listing = [
                    {"name": m.cli_name, "task": m.task.value,
                     "architecture": m.architecture.value,
                     "downloaded": registry.is_downloaded(m)}
                    for m in registry.all_models()]
                # dual-shape: kjarni's "models" plus the OpenAI list form so
                # client.models.list() works against this server too; the
                # OpenAI array lists only models the completions endpoints
                # can actually serve
                self._reply(200, {
                    "models": listing,
                    "object": "list",
                    "data": [{"id": m["name"], "object": "model",
                              "owned_by": "kjarni"} for m in listing
                             if m["task"] in ("generation", "chat",
                                              "reasoning")]})
            else:
                self._reply(404, {"error": "not found"})

        def _reply_sse(self, body: dict):
            """Server-sent events: one `data:` frame per token, then [DONE].
            First token reaches the client before generation completes;
            client disconnect cancels the decode via the CancellationToken."""
            from .core.watchdog import call_with_timeout
            it, cancel = engine.handle_stream(self.path, body)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            timeout = engine.request_timeout_s
            try:
                while True:
                    try:
                        piece = call_with_timeout(lambda: next(it), timeout,
                                                  f"stream {self.path}")
                    except StopIteration:
                        break
                    payload = (piece if isinstance(piece, dict)
                               else {"text": piece})
                    self.wfile.write(
                        b"data: " + json.dumps(payload).encode() + b"\n\n")
                    self.wfile.flush()
                self.wfile.write(b"data: [DONE]\n\n")
            except (BrokenPipeError, ConnectionResetError):
                cancel.cancel()   # client went away: stop the decode loop
            finally:
                it.close()        # releases the model lock

        def do_POST(self):
            from .core.errors import DeviceTimeoutError
            from .core.watchdog import call_with_timeout
            try:
                n = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(n) or b"{}")
                if body.get("stream") and self.path in (
                        "/v1/generate", "/v1/chat",
                        "/v1/completions", "/v1/chat/completions"):
                    self._reply_sse(body)
                    return
                out = call_with_timeout(
                    lambda: engine.handle(self.path, body),
                    engine.request_timeout_s, f"request {self.path}")
                self._reply(200, out)
            except DeviceTimeoutError as e:
                self._reply(503, {"error": str(e)})
            except KjarniError as e:
                self._reply(400, {"error": str(e)})
            except (KeyError, json.JSONDecodeError) as e:
                self._reply(400, {"error": f"bad request: {e}"})
            except Exception as e:  # noqa: BLE001 — server must not die
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def _spmd_world() -> int:
    import torch.distributed as dist
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def serve(host: str = "127.0.0.1", port: int = 8000,
          default_models: dict[str, str] | None = None,
          **engine_kw) -> ThreadingHTTPServer:
    """The HTTP server over an `_Engine(default_models, **engine_kw)`
    (max_batch, batch_window_ms, scheduler, draft_model, request_timeout_s,
    tp, dp, steps_per_sync, prompt_prefix, kv_cache, device). In a process
    group of several ranks this is rank 0's, and its engine issues every
    model call through a Dispatcher (serve_spmd.py) that the other ranks'
    `run` follows; a divergence between the ranks shuts it down."""
    engine = _Engine(default_models, **engine_kw)
    server = KjarniHTTPServer((host, port), make_handler(engine))
    server.engine = engine
    if _spmd_world() > 1:
        from .serve_spmd import Dispatcher
        engine._spmd = Dispatcher(engine._apply, on_failure=lambda: threading.Thread(
            target=server.shutdown, daemon=True).start())
    return server


def run(host: str = "127.0.0.1", port: int = 8000,
        default_models: dict[str, str] | None = None, **engine_kw) -> int:
    """Serve until SIGINT (or, under SPMD, SIGTERM) on rank 0. Under a
    process group of several ranks (torchrun), rank 0 serves and every
    other rank follows its model calls until rank 0 stops; the exit code is
    1 if the ranks diverged."""
    import torch.distributed as dist
    world = _spmd_world()
    if world > 1 and dist.get_rank() != 0:
        from .serve_spmd import follow
        follow(_Engine(default_models, **engine_kw)._apply)
        return 0
    server = serve(host, port, default_models, **engine_kw)
    spmd = server.engine._spmd
    # the JAX server's line; under SPMD the bound port (port 0 picks one)
    # and the pid that SIGINT stops
    where = f"http://{host}:{port}"
    if spmd is not None:
        where = (f"http://{host}:{server.server_address[1]} "
                 f"(rank 0 of {world}, pid {os.getpid()})")

        def stop(signum, frame):
            raise KeyboardInterrupt
        signal.signal(signal.SIGTERM, stop)
    print(f"kjarni serving on {where}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if spmd is not None:
            spmd.stop()
    if spmd is not None and spmd.failed is not None:
        print(f"error: {spmd.failed}", file=sys.stderr)
        return 1
    return 0


def parse_model_overrides(pairs: list[str]) -> dict[str, str]:
    """Parse repeated KIND=NAME_OR_PATH --models flags."""
    out = {}
    for pair in pairs:
        kind, sep, name = pair.partition("=")
        if not sep or not kind or not name:
            raise SystemExit(
                f"--models expects KIND=NAME_OR_PATH, got '{pair}'")
        out[kind] = name
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="kjarni HTTP server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=1,
                    help="group up to N concurrent /v1/generate requests "
                         "into one batched decode (1 = off)")
    ap.add_argument("--batch-window-ms", type=float, default=10.0,
                    help="how long to wait for co-batchable requests")
    ap.add_argument("--models", action="append", default=[],
                    metavar="KIND=NAME_OR_PATH",
                    help="override the model for a task kind, e.g. "
                         "--models generate=/path/to/model (repeatable)")
    ap.add_argument("--scheduler", choices=["batch", "continuous"],
                    default="batch",
                    help="'continuous' joins generate requests into a "
                         "running slot-based decode (token-level batching)")
    ap.add_argument("--steps-per-sync", type=int, default=16,
                    help="continuous scheduler: max decode iterations fused "
                         "per host dispatch (the window adapts down to the "
                         "least-loaded slot's outstanding tokens)")
    ap.add_argument("--prompt-prefix", default=None, action="append",
                    help="continuous scheduler: prefill this shared prompt "
                         "prefix once and reuse its KV for every request "
                         "that starts with it (prompt caching); repeat the "
                         "flag to cache several prefixes (e.g. one per "
                         "tenant's system prompt)")
    ap.add_argument("--draft-model",
                    help="speculative-decoding draft model for /v1/generate")
    ap.add_argument("--device-timeout", type=float, default=None,
                    help="per-request deadline in seconds; a wedged device "
                         "returns 503 instead of hanging (default: "
                         "KJARNI_DEVICE_TIMEOUT_S or off)")
    ap.add_argument("--tp", type=int, default=None, metavar="N",
                    help="tensor-parallel decoder models over N ranks "
                         "(under torchrun --nproc-per-node N)")
    ap.add_argument("--dp", type=int, default=None, metavar="N",
                    help="data-parallel encoder models over N ranks "
                         "(under torchrun --nproc-per-node N)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the models run (default: the CUDA card)")
    args = ap.parse_args(argv)
    from .parallel.comm import spmd_group
    with spmd_group(args.device):
        return run(args.host, args.port,
                   default_models=parse_model_overrides(args.models),
                   max_batch=args.max_batch,
                   batch_window_ms=args.batch_window_ms,
                   scheduler=args.scheduler,
                   steps_per_sync=args.steps_per_sync,
                   prompt_prefix=args.prompt_prefix,
                   draft_model=args.draft_model,
                   request_timeout_s=args.device_timeout,
                   tp=args.tp, dp=args.dp, device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
