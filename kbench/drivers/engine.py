"""Driver of the continuous-batching engine, the server's `--scheduler
continuous` loop without its HTTP thread: `serve_batching.new_engine`, then
one `serve_batching.advance` per window, open loop.

Each request is due at its arrival time; every request due by the start of a
window joins that window (queued, then admitted in batched waves by the
engine). The window's finished requests are delivered at its end, as the
server delivers them. After the last arrival the loop drains what is left,
for at most DRAIN_S seconds; a request still unfinished then has failed.
"""

from __future__ import annotations

import time

from .common import Served, Window

DRAIN_S = 60.0


def setup(lm, cell: dict):
    from kjarni_tpu_torch import serve_batching
    return serve_batching.new_engine(lm, slots=cell["slots"],
                                     steps_per_sync=cell["steps_per_sync"])


def _kwargs(req) -> dict:
    from kjarni_tpu_torch.generate.sampling import SamplingParams
    sp = None if req.greedy else SamplingParams(**req.sampling)
    return {"token_ids": req.token_ids, "max_new_tokens": req.max_new_tokens,
            "sampling": sp, "seed": req.seed}


def warm(eng, reqs: list) -> None:
    """Serve the warm-up requests as one burst, then until all are done."""
    from kjarni_tpu_torch.serve_batching import advance
    ids, _ = advance(eng, [(None, _kwargs(r)) for r in reqs])
    for rid in ids:
        if isinstance(rid, BaseException):
            raise rid
    while eng.num_active or eng.num_waiting:
        advance(eng, [])
    eng.drain()


def run(eng, reqs: list, seconds: float, tracer, clock=time.perf_counter) -> Window:
    from kjarni_tpu_torch.serve_batching import advance
    before = dict(eng.stats)
    served: dict = {}
    i, n = 0, len(reqs)
    t0 = clock()

    def now():
        return clock() - t0

    while True:
        t = now()
        tracer.poll(t)
        batch = []
        while i < n and reqs[i].due_s <= t:
            batch.append(reqs[i])
            i += 1
        if not batch and not eng.num_active and not eng.num_waiting:
            if i >= n:
                break
            with tracer.span("wait", now):
                time.sleep(max(0.0, reqs[i].due_s - now()))
            continue
        if t > seconds + DRAIN_S:
            break
        sent = now()
        with tracer.span("engine.advance", now):
            ids, finished = advance(eng, [(None, _kwargs(r)) for r in batch])
        t_end = now()
        for r, rid in zip(batch, ids):
            s = Served(r, sent)
            if isinstance(rid, BaseException):
                s.error, s.done_s = repr(rid), None
                served[("err", r.index)] = s
            else:
                served[rid] = s
        for fr in finished:
            s = served.get(fr.request_id)
            if s is not None:
                s.tokens = list(fr.token_ids)
                s.done_s = t_end
    tracer.stop()
    end = max([s.done_s for s in served.values() if s.done_s is not None], default=now())
    counters = {k: eng.stats[k] - before.get(k, 0) for k in eng.stats}
    out = sorted(served.values(), key=lambda s: s.request.index)
    return Window(out, seconds, end, counters, list(tracer.spans))
