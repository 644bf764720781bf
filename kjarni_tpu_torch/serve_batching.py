"""Dynamic request batching for the HTTP server (copy of
kjarni_tpu/serve_batching.py, over the port's ContinuousEngine).

Decode is bound by weight bytes, so B concurrent sequences decode at nearly
the cost of one (DecoderLM.generate_batch). Two schedulers close that gap at
the server boundary:
  * DynamicBatcher — request-level batching: requests that arrive within a
    window and share generation parameters run as one `generate_batch` call;
  * ContinuousRunner — token-level continuous batching over the slot engine
    in generate/continuous.py: requests join a RUNNING decode mid-flight,
    each slot with its own sampling parameters and generator.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional


class _Request:
    __slots__ = ("prompt", "key", "kwargs", "done", "result", "error",
                 "want_full")

    def __init__(self, prompt: str, key: tuple, kwargs: dict,
                 want_full: bool = False):
        self.prompt = prompt
        self.key = key
        self.kwargs = kwargs
        self.done = threading.Event()
        self.result = None         # str, or FinishedRequest when want_full
        self.error: Optional[BaseException] = None
        self.want_full = want_full


class DynamicBatcher:
    """Groups concurrent generate requests into batched decode calls.

    run_batch: callable(prompts, **kwargs) -> list[str]. Requests are only
    grouped when their kwargs match (same sampling parameters); mismatched
    requests run in their own batch.
    """

    def __init__(self, run_batch: Callable[..., list[str]], *,
                 max_batch: int = 8, max_wait_ms: float = 10.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._run_batch = run_batch
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._cv = threading.Condition()
        self._pending: list[_Request] = []
        self._stopped = False
        self.batch_sizes: list[int] = []  # observability: size of each batch run
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="kjarni-batcher")
        self._thread.start()

    # ------------------------------------------------------------------

    @staticmethod
    def _key(kwargs: dict) -> tuple:
        return tuple(sorted((k, repr(v)) for k, v in kwargs.items()))

    def submit(self, prompt: str, **kwargs: Any) -> str:
        """Enqueue one prompt and block until its generation is done."""
        req = _Request(prompt, self._key(kwargs), kwargs)
        with self._cv:
            if self._stopped:
                raise RuntimeError("batcher is shut down")
            self._pending.append(req)
            self._cv.notify_all()
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.result  # type: ignore[return-value]

    def shutdown(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout=5)

    # ------------------------------------------------------------------

    def _take_matching(self, key: tuple, limit: int) -> list[_Request]:
        taken = []
        rest = []
        for r in self._pending:
            if r.key == key and len(taken) < limit:
                taken.append(r)
            else:
                rest.append(r)
        self._pending = rest
        return taken

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stopped:
                    self._cv.wait()
                if not self._pending and self._stopped:
                    return
                first = self._pending.pop(0)
            batch = [first]
            deadline = time.monotonic() + self.max_wait_ms / 1000.0
            while len(batch) < self.max_batch:
                with self._cv:
                    batch.extend(self._take_matching(
                        first.key, self.max_batch - len(batch)))
                    if len(batch) >= self.max_batch:
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
            self.batch_sizes.append(len(batch))
            try:
                outs = self._run_batch([r.prompt for r in batch],
                                       **first.kwargs)
                if len(outs) != len(batch):
                    raise RuntimeError(
                        f"run_batch returned {len(outs)} results for "
                        f"{len(batch)} prompts")
                for r, out in zip(batch, outs):
                    r.result = out
            except BaseException as e:  # noqa: BLE001 — deliver to waiters
                for r in batch:
                    r.error = e
            finally:
                for r in batch:
                    r.done.set()


def new_engine(lm, *, slots: int = 8, steps_per_sync: int = 16,
               cached_prefix: Optional[str | list] = None):
    """The ContinuousEngine a runner drives, with its cached prefixes."""
    from .generate.continuous import ContinuousEngine
    eng = ContinuousEngine(lm, slots=slots, steps_per_sync=steps_per_sync)
    if cached_prefix:
        # shared-prefix prompt cache: prompts starting with any of these
        # texts' tokens skip recomputing them at admission (one entry
        # per system prompt for multi-tenant serving)
        prefixes = ([cached_prefix] if isinstance(cached_prefix, str)
                    else list(cached_prefix))
        for p in prefixes:
            eng.register_prefix(p)
    return eng


def advance(eng, reqs: list) -> tuple[list, list]:
    """One window of the runner's loop: queue each (prompt, kwargs) of
    `reqs`, then step() the engine. Returns (each request's id or the
    exception its submit raised, the requests that finished)."""
    ids = []
    for prompt, kwargs in reqs:
        try:
            # defer_admit: queue the whole burst, then let step()
            # prefill every joining request in ONE batched prefill
            ids.append(eng.submit(prompt, defer_admit=True, **kwargs))
        except Exception as e:  # noqa: BLE001 — delivered to its request
            ids.append(e)
    eng.step()
    return ids, eng.drain()


class ContinuousRunner:
    """Thread-safe front-end for ContinuousEngine (generate/continuous.py).

    The engine itself is single-threaded (slot state, slot caches); this
    runner owns it on a worker thread: server threads enqueue prompts, the
    worker admits them into the running decode (mid-flight joins) and delivers
    results. Per-request sampling params ride along to the slot engine.
    `window(reqs)` runs one window on `engine` (`advance`; the server runs
    it as an op, on every rank under SPMD). A window that raises fails every
    request the runner holds and stops it: the engine's state is unknown.
    """

    def __init__(self, engine, window: Callable[[list], tuple]):
        self._engine = engine
        self._window = window
        self._cv = threading.Condition()
        self._incoming: list[_Request] = []
        self._by_rid: dict[int, _Request] = {}
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="kjarni-continuous")
        self._thread.start()

    def submit(self, prompt: str, max_new_tokens: int = 128,
               sampling: Any = None, seed: Any = None,
               **_ignored: Any) -> str:
        return self._submit(_Request(
            prompt, (), {"max_new_tokens": max_new_tokens,
                         "sampling": sampling, "seed": seed}))

    def submit_full(self, *, token_ids=None, prompt: str = None,
                    max_new_tokens: int = 128, sampling: Any = None,
                    seed: Any = None):
        """Like submit() but returns the engine's FinishedRequest (token
        ids + finish_reason) and accepts pre-encoded token_ids — the
        OpenAI layer needs both for usage accounting."""
        return self._submit(_Request(
            prompt, (), {"max_new_tokens": max_new_tokens,
                         "sampling": sampling, "seed": seed,
                         "token_ids": token_ids}, want_full=True))

    def _submit(self, req: _Request):
        with self._cv:
            if self._stopped:
                raise RuntimeError("runner is shut down")
            self._incoming.append(req)
            self._cv.notify_all()
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def shutdown(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout=5)

    def _loop(self) -> None:
        eng = self._engine
        while True:
            with self._cv:
                while (not self._incoming and not eng.num_active
                       and not eng.num_waiting):
                    if self._stopped:
                        return
                    self._cv.wait()
                incoming, self._incoming = self._incoming, []
                if incoming and not eng.num_active:
                    # engine idle: give the rest of a concurrent burst a few
                    # ms to arrive so the first wave admits full — one
                    # batched prefill instead of a half-empty first window
                    deadline = time.monotonic() + 0.008
                    while (len(incoming) < eng.S
                           and time.monotonic() < deadline):
                        self._cv.wait(timeout=0.002)
                        incoming += self._incoming
                        self._incoming = []
            try:
                ids, finished = self._window([(r.prompt, r.kwargs) for r in incoming])
            except BaseException as e:  # noqa: BLE001 — delivered to every request
                self._fail(incoming, e)
                return
            for req, rid in zip(incoming, ids):
                if isinstance(rid, BaseException):
                    req.error = rid
                    req.done.set()
                else:
                    self._by_rid[rid] = req
            for fr in finished:
                req = self._by_rid.pop(fr.request_id, None)
                if req is not None:
                    req.result = fr if req.want_full else fr.text
                    req.done.set()

    @property
    def stopped(self) -> bool:
        return self._stopped

    def _fail(self, incoming: list, error: BaseException) -> None:
        with self._cv:
            self._stopped = True
            failed = incoming + self._incoming + list(self._by_rid.values())
            self._incoming, self._by_rid = [], {}
        for req in failed:
            req.error = error
            req.done.set()
