"""The HTTP server under SPMD: `serve --tp N` / `--dp N` under
`torchrun --nproc-per-node N` (serve.py).

Every rank holds the same models: tensor-parallel decoders hold their
shards, data-parallel encoders their copies, and each model call runs a
collective on every rank. Rank 0 binds the port and answers HTTP on many
threads (and the batchers' own loops), so its calls could reach the group
from several threads at once, and two threads' collectives on one group
interleave and hang. So on rank 0 every call that reaches a model goes to
one thread, the `Dispatcher`: it sends the call to every rank (a pickled
broadcast on the default group), runs it on its own engine, and the ranks
then agree on how it went. The other ranks run `follow`: receive a call,
run it on their own `_Engine`, report. The calls are the engine's ops
(serve.py `_Engine._apply`): building a model, one task method (an encoder
call, a generation, a batch, a chat turn), opening, pulling one step of and
closing a stream, and one window of the continuous engine.

Rank 0 reaches its task objects through `Replica` handles: the methods in
`Replica.CALLS` and `Replica.STREAMS` are dispatched, and the attributes in
`Replica.LOCAL` (a tokenizer, a chat template, a model id) are read on rank
0 alone, since they run no collective and every rank holds the same. Any
other attribute raises `NotReplicated`: a call that ran on rank 0 alone
would leave the other ranks out of its collectives and hang the group.

A call that fails on every rank fails the request as it would in one
process. A call that fails on some ranks and not on others leaves their
states apart: the group ends, rank 0 stops serving and each rank exits with
an error. When idle, rank 0 sends a no-op every `HEARTBEAT_S` seconds, so
the followers' receive never reaches the process group's timeout. Shutdown
(rank 0's SIGINT or SIGTERM) sends a stop that ends every follower's loop.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Callable, Optional

import torch.distributed as dist

from .core.errors import KjarniError

HEARTBEAT_S = 60.0


class SpmdError(KjarniError):
    """The ranks disagreed on a call: the group has ended."""


class NotReplicated(RuntimeError):
    """A Replica's attribute that is neither dispatched nor a local read."""


def _exchange(op):
    box = [op]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _agree(op, error: Optional[BaseException]) -> None:
    """Every rank's outcome of `op`; raises SpmdError unless all failed or
    all succeeded."""
    mine = None if error is None else f"{type(error).__name__}: {error}"
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    failed = [r for r, e in enumerate(every) if e is not None]
    if failed and len(failed) != len(every):
        detail = "; ".join(f"rank {r}: {every[r]}" for r in failed)
        raise SpmdError(f"the ranks diverged on {op[0]!r} (failed on ranks {failed} "
                        f"alone: {detail}); the server stops")


def _run(apply: Callable, op):
    try:
        return apply(op), None
    except Exception as e:  # noqa: BLE001 — every rank's outcome is compared
        return None, e


def follow(apply: Callable[[tuple], Any]) -> None:
    """Ranks >= 1: run each call rank 0 sends, until its stop."""
    while True:
        op = _exchange(None)
        if op is None:
            return
        _, err = _run(apply, op)
        _agree(op, err)


class Dispatcher:
    """Rank 0's one issuing thread (module docstring). `call(op)` from any
    thread returns what `apply(op)` returned on rank 0, or raises what it
    raised; `on_failure` is called once if the group ends."""

    def __init__(self, apply: Callable[[tuple], Any],
                 on_failure: Optional[Callable[[], None]] = None):
        self._apply = apply
        self.on_failure = on_failure
        self.failed: Optional[SpmdError] = None
        self._q: queue.Queue = queue.Queue()
        self._ids = itertools.count()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="kjarni-spmd")
        self._thread.start()

    def in_op(self) -> bool:
        return threading.current_thread() is self._thread

    def new_id(self) -> int:
        return next(self._ids)

    def call(self, op: tuple):
        if self.in_op():
            return self._apply(op)
        if self.failed is not None:
            raise self.failed
        done, box = threading.Event(), {}
        self._q.put((op, box, done))
        done.wait()
        if "error" in box:
            raise box["error"]
        return box["value"]

    def stop(self) -> None:
        """Send the stop to every rank (after the calls already queued)."""
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join()

    def _loop(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=HEARTBEAT_S)
            except queue.Empty:
                item = (("noop",), {}, threading.Event())
            if item is None:
                _exchange(None)
                return
            op, box, done = item
            _exchange(op)
            value, err = _run(self._apply, op)
            try:
                _agree(op, err)
            except SpmdError as e:
                self.failed = e
                box["error"] = e
                done.set()
                self._fail_pending(e)
                if self.on_failure is not None:
                    self.on_failure()
                return
            if err is not None:
                box["error"] = err
            else:
                box["value"] = value
            done.set()

    def _fail_pending(self, e: SpmdError) -> None:
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                item[1]["error"] = e
                item[2].set()


class RemoteStream:
    """A stream every rank opened under one id; each `next` pulls one step
    on every rank. `close` (also at the end) closes it everywhere."""

    def __init__(self, dispatcher: Dispatcher, key, method: str, args, kwargs):
        self._d = dispatcher
        self._sid = dispatcher.new_id()
        # a cancellation token stays on rank 0: a stream cancelled there is
        # closed on every rank at the same step
        kwargs = {k: v for k, v in kwargs.items() if k != "cancellation"}
        dispatcher.call(("stream_open", self._sid, key, method, args, kwargs))
        self._open = True

    def __iter__(self):
        return self

    def __next__(self):
        if not self._open:
            raise StopIteration
        more, item = self._d.call(("stream_next", self._sid))
        if not more:
            self._open = False
            raise StopIteration
        return item

    def close(self) -> None:
        if self._open:
            self._open = False
            self._d.call(("stream_close", self._sid))


class Replica:
    """Rank 0's handle on a task object that every rank holds under `key`
    (serve.py `_Engine._resolve`)."""

    CALLS = frozenset({"classify", "classify_batch", "embed", "embed_batch",
                       "similarity", "rerank", "generate", "generate_batch", "send",
                       "clear_history", "search"})
    STREAMS = frozenset({"generate_stream", "stream"})
    LOCAL = frozenset({"model_id", "dim", "max_context", "tokenizer", "chat_template",
                       "encode_prompt"})

    def __init__(self, dispatcher: Dispatcher, key, target, children: dict):
        self._d, self._key, self._target = dispatcher, key, target
        self._children = children

    def __getattr__(self, name: str):
        if name == "_lm":   # the model itself, one handle per model
            key = (self._key[0], "_lm")
            if key not in self._children:
                self._children[key] = Replica(self._d, key, self._target._lm, self._children)
            return self._children[key]
        if name in self.CALLS:
            return lambda *a, **kw: self._d.call(("call", self._key, name, a, kw))
        if name in self.STREAMS:
            return lambda *a, **kw: RemoteStream(self._d, self._key, name, a, kw)
        if name in self.LOCAL:
            return getattr(self._target, name)
        raise NotReplicated(f"'{name}' of {self._key[0]} is not run on every rank: add it "
                            f"to Replica.CALLS, STREAMS or LOCAL (serve_spmd.py)")
