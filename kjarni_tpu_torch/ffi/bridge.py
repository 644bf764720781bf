"""Python side of the C ABI: handle table + JSON method dispatch.

The port of kjarni_tpu/ffi/bridge.py over kjarni_tpu_torch's task classes.
The port's native shim (kjarni_tpu_torch/native/kjarni_ffi.cpp, built by
ffi/build.py) embeds CPython and funnels every call through this module:
`create(task, options_json)`, `call(handle, method, args_json)`,
`destroy(handle)`. Mirrors kjarni-ffi's handle-based C API
(kjarni-ffi/src/lib.rs:36, per-task files) with the typed marshalling kept in
one place. A "device" key in the options ("cuda" or "cpu") reaches the task's
constructor with the other options; without one the task runs on the card and
raises where there is none.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Iterator

_LOCK = threading.Lock()
_HANDLES: dict[int, Any] = {}
_STREAMS: dict[int, Iterator] = {}
_NEXT = 1


def _register(obj: Any) -> int:
    global _NEXT
    with _LOCK:
        h = _NEXT
        _NEXT += 1
        _HANDLES[h] = obj
    return h


def _get(handle: int) -> Any:
    obj = _HANDLES.get(handle)
    if obj is None:
        raise ValueError(f"invalid kjarni handle {handle}")
    return obj


def create(task: str, options_json: str) -> int:
    """Instantiate a task object; returns a handle (kjarni_*_new)."""
    opts = json.loads(options_json) if options_json else {}
    model = opts.pop("model", None)
    opts.setdefault("quiet", True)
    if task == "embedder":
        from ..tasks.embedder import Embedder
        obj = Embedder(model or "minilm-l6-v2", **opts)
    elif task == "classifier":
        from ..tasks.classifier import Classifier
        obj = Classifier(model or "distilbert-sentiment", **opts)
    elif task == "reranker":
        from ..tasks.reranker import Reranker
        obj = Reranker(model or "minilm-l6-v2-cross-encoder", **opts)
    elif task == "chat":
        from ..tasks.chat import Chat
        obj = Chat(model or "qwen2.5-0.5b-instruct", **opts)
    elif task == "generator":
        from ..tasks.generator import Generator
        obj = Generator(model or "qwen2.5-0.5b-instruct", **opts)
    elif task == "summarizer":
        from ..tasks.summarizer import Summarizer
        obj = Summarizer(model or "distilbart-cnn", **opts)
    elif task == "translator":
        from ..tasks.translator import Translator
        obj = Translator(model or "flan-t5-base", **opts)
    elif task == "transcriber":
        from ..tasks.transcriber import Transcriber
        obj = Transcriber(model or "whisper-small", **opts)
    elif task == "indexer":
        from ..tasks.indexer import Indexer
        obj = Indexer(model or "minilm-l6-v2", **opts)
    elif task == "searcher":
        from ..tasks.searcher import Searcher
        obj = Searcher(model or "minilm-l6-v2", **opts)
    else:
        raise ValueError(f"unknown task '{task}'")
    return _register(obj)


def destroy(handle: int) -> None:
    with _LOCK:
        _HANDLES.pop(handle, None)
        _STREAMS.pop(handle, None)


def call(handle: int, method: str, args_json: str) -> str:
    """Invoke a method; args and result are JSON (kjarni_call)."""
    obj = _get(handle)
    args = json.loads(args_json) if args_json else {}
    result = _dispatch(obj, method, args)
    return json.dumps(result)


def _dispatch(obj: Any, method: str, a: dict) -> Any:
    kind = type(obj).__name__

    if kind == "Embedder":
        if method == "embed":
            return {"embedding": [float(x) for x in obj.embed(a["text"])]}
        if method == "embed_batch":
            return {"embeddings": [[float(x) for x in v]
                                   for v in obj.embed_batch(a["texts"])]}
        if method == "similarity":
            return {"similarity": obj.similarity(a["a"], a["b"])}
        if method == "dim":
            return {"dim": obj.dim}
    elif kind == "Classifier":
        if method == "classify":
            r = obj.classify(a["text"])
            return {"label": r.label, "score": r.score,
                    "all_scores": [[l, s] for l, s in r.all_scores]}
        if method == "classify_batch":
            return {"results": [
                {"label": r.label, "score": r.score,
                 "all_scores": [[l, s] for l, s in r.all_scores]}
                for r in obj.classify_batch(a["texts"])]}
        if method == "labels":
            return {"labels": obj.labels}
    elif kind == "Reranker":
        if method == "score":
            return {"score": obj.score(a["query"], a["document"])}
        if method == "rerank":
            return {"results": [
                {"index": r.index, "score": r.score, "text": r.text}
                for r in obj.rerank(a["query"], a["documents"])]}
    elif kind == "Chat":
        if method == "send":
            return {"reply": obj.send(a["message"])}
        if method == "clear_history":
            obj.clear_history(a.get("keep_system", True))
            return {}
        if method == "history":
            return {"messages": [
                {"role": m.role.value, "content": m.content}
                for m in obj.conversation.messages]}
    elif kind == "Generator":
        if method == "generate":
            kw = {k: v for k, v in a.items() if k != "prompt"}
            return {"text": obj.generate(a["prompt"], **kw)}
    elif kind == "Summarizer":
        if method == "summarize":
            return {"summary": obj.summarize(a["text"])}
    elif kind == "Translator":
        if method == "translate":
            return {"translation": obj.translate(a["text"], a["from"], a["to"])}
    elif kind == "Transcriber":
        if method == "transcribe_file":
            r = obj.transcribe_file(a["path"])
            return {"text": r.text, "duration": r.duration,
                    "segments": [{"start": s.start, "end": s.end,
                                  "text": s.text} for s in r.segments]}
    elif kind == "Indexer":
        if method == "create":
            s = obj.create(a["index_path"], a["paths"])
            return {"documents": s.documents, "chunks": s.chunks,
                    "bytes": s.bytes}
        if method == "add":
            s = obj.add(a["index_path"], a["paths"])
            return {"documents": s.documents, "chunks": s.chunks,
                    "bytes": s.bytes}
    elif kind == "Searcher":
        if method == "search":
            results = obj.search(a["index_path"], a["query"],
                                 mode=a.get("mode", "hybrid"),
                                 top_k=a.get("top_k", 10))
            return {"results": [
                {"score": r.score, "document_id": r.document_id,
                 "text": r.text, "metadata": r.metadata} for r in results]}
    raise ValueError(f"unknown method '{method}' for {kind}")


# cancel tokens (kjarni-ffi/src/callback.rs:52 CancellationToken): host
# languages create one, pass it to a stream, and may cancel from any thread
def cancel_token_new() -> int:
    from ..core.cancellation import CancellationToken
    return _register(CancellationToken())


def cancel_token_cancel(handle: int) -> None:
    _get(handle).cancel()


def cancel_token_is_cancelled(handle: int) -> bool:
    return bool(_get(handle).is_cancelled)


# streaming (kjarni-ffi callback.rs analogue): start a stream, pull tokens
def stream_start(handle: int, method: str, args_json: str,
                 cancel_handle: int = 0) -> None:
    obj = _get(handle)
    args = json.loads(args_json) if args_json else {}
    kind = type(obj).__name__
    cancellation = _get(cancel_handle) if cancel_handle else None
    if kind == "Chat" and method == "stream":
        _STREAMS[handle] = iter(obj.stream(args["message"],
                                           cancellation=cancellation))
    elif kind == "Generator" and method == "generate_stream":
        kw = {k: v for k, v in args.items() if k != "prompt"}
        _STREAMS[handle] = iter(obj.generate_stream(
            args["prompt"], cancellation=cancellation, **kw))
    else:
        raise ValueError(f"no stream '{method}' for {kind}")


def stream_next(handle: int) -> str | None:
    """Next token text, or None when the stream ends."""
    it = _STREAMS.get(handle)
    if it is None:
        return None
    try:
        st = next(it)
        return st.text
    except StopIteration:
        _STREAMS.pop(handle, None)
        return None


def stream_cancel(handle: int) -> None:
    _STREAMS.pop(handle, None)
