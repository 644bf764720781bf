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
Not ported yet, and answered with an HTTP error naming the ROADMAP.md item:
the server under tensor / data parallelism, `--tp` / `--dp` (item 9: every
rank ≥ 1 needs a loop that follows rank 0's requests; the task APIs and the
CLI take tp and dp under torchrun).

Run: python -m kjarni_tpu_torch.serve --port 8000
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from . import registry
from .core.errors import KjarniError
from .models.decoder_lm import not_ported


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
        # tensor-parallel decoders / data-parallel encoders: refused when a
        # model is built (ROADMAP.md item 9), since the server runs in one
        # process and the task constructors take tp / dp under SPMD only
        self.tp = tp
        self.dp = dp
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
                if obj is not None:
                    return obj
            obj = self._construct(kind, model)
            with self._lock:
                self._cache[key] = obj
        return obj

    def _construct(self, kind: str, model: str):
        dev = self.device
        if kind in ("generate", "chat") and (self.tp or 1) > 1:
            raise not_ported("tensor parallelism (--tp) in the server", "queue 1, item 9")
        if kind in ("classify", "embed", "rerank") and (self.dp or 1) > 1:
            raise not_ported("data parallelism (--dp) in the server", "queue 1, item 9")
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
        with self._lock:
            lock = self._model_locks.get(id(lm))
            if lock is None:
                lock = self._model_locks[id(lm)] = threading.Lock()
        return lock

    def _continuous(self, gen):
        """One ContinuousRunner per loaded generator model."""
        from .serve_batching import ContinuousRunner
        with self._lock:
            r = self._continuous_runners.get(gen.model_id)
            if r is None:
                slots = self.max_batch if self.max_batch > 1 else 8
                r = ContinuousRunner(gen._lm, slots=slots,
                                     steps_per_sync=self.steps_per_sync,
                                     cached_prefix=self.prompt_prefix)
                self._continuous_runners[gen.model_id] = r
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
        model = body.get("model")
        session = body.get("session", "default")
        key = ("chat-session", model or self.defaults["chat"], session)
        with self._creation_lock(key):
            with self._lock:
                chat = self._cache.get(key)
            if chat is None:
                from .tasks.chat import Chat
                base = self.get("chat", model)
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
        if body.get("reset"):
            chat.clear_history(keep_system=True)
        return chat, session

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
                with lock:
                    for st in gen.generate_stream(
                            body["prompt"], cancellation=cancel, **kw):
                        yield st.text
            return run(), cancel
        if path == "/v1/chat":
            chat, _session = self._chat_session(body)
            lock = self._lm_lock(chat._lm)

            def run():
                with lock:
                    for st in chat.stream(body["message"],
                                          cancellation=cancel):
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


def serve(host: str = "127.0.0.1", port: int = 8000,
          default_models: dict[str, str] | None = None,
          max_batch: int = 1,
          batch_window_ms: float = 10.0,
          scheduler: str = "batch",
          draft_model: str | None = None,
          request_timeout_s: float | None = None,
          tp: int | None = None, dp: int | None = None,
          steps_per_sync: int = 16,
          prompt_prefix: str | list | None = None,
          kv_cache: str | None = None,
          device: str | None = None) -> ThreadingHTTPServer:
    engine = _Engine(default_models, max_batch=max_batch,
                     batch_window_ms=batch_window_ms, scheduler=scheduler,
                     draft_model=draft_model,
                     request_timeout_s=request_timeout_s,
                     tp=tp, dp=dp, steps_per_sync=steps_per_sync,
                     prompt_prefix=prompt_prefix, kv_cache=kv_cache,
                     device=device)
    server = KjarniHTTPServer((host, port), make_handler(engine))
    return server


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
                    help="tensor-parallel decoder models over N cards "
                         "(not ported to the server: N > 1 is refused)")
    ap.add_argument("--dp", type=int, default=None, metavar="N",
                    help="data-parallel encoder models over N cards "
                         "(not ported to the server: N > 1 is refused)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the models run (default: the CUDA card)")
    args = ap.parse_args(argv)
    server = serve(args.host, args.port,
                   default_models=parse_model_overrides(args.models),
                   max_batch=args.max_batch,
                   batch_window_ms=args.batch_window_ms,
                   scheduler=args.scheduler,
                   steps_per_sync=args.steps_per_sync,
                   prompt_prefix=args.prompt_prefix,
                   draft_model=args.draft_model,
                   request_timeout_s=args.device_timeout,
                   tp=args.tp, dp=args.dp, device=args.device)
    print(f"kjarni serving on http://{args.host}:{args.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
