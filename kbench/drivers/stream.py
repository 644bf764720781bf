"""Driver of the single stream, `DecoderLM.generate_stream(token_ids=...)`, the
loop that `Generator`, `Chat` and `kjarni generate` run: one client in a closed
loop, each request sent when the last one has ended, until the window closes.
The request in flight when it closes runs to its end and counts.

A request's time to first token runs from the call to the first token the
generator yields.
"""

from __future__ import annotations

import time

from .common import Served, Window


def setup(lm, cell: dict):
    return lm


def _config(lm, req):
    from kjarni_tpu_torch.generate.sampling import GenerationConfig, SamplingParams
    if req.greedy:
        return GenerationConfig(max_new_tokens=req.max_new_tokens,
                                max_length=lm.max_context, strategy="greedy")
    return GenerationConfig(max_new_tokens=req.max_new_tokens, max_length=lm.max_context,
                            strategy="sample", sampling=SamplingParams(**req.sampling),
                            seed=req.seed)


def serve(lm, req, clock, sent: float) -> Served:
    s = Served(req, sent)
    for st in lm.generate_stream(token_ids=req.token_ids, config=_config(lm, req)):
        if s.first_s is None:
            s.first_s = clock()
        s.tokens.append(st.id)
    s.done_s = clock()
    return s


def warm(lm, reqs: list) -> None:
    for r in reqs:
        serve(lm, r, time.perf_counter, 0.0)


def run(lm, reqs, seconds: float, tracer, clock=time.perf_counter) -> Window:
    """reqs: an iterator of requests in the order the client sends them."""
    t0 = clock()

    def now():
        return clock() - t0

    served = []
    for k, r in enumerate(reqs):
        t = now()
        if t >= seconds:
            break
        tracer.poll(t)
        r.index, r.due_s = k, -1.0      # closed loop: timed from when sent
        with tracer.span("stream.request", now):
            served.append(serve(lm, r, now, t))
    tracer.stop()
    end = max([s.done_s for s in served], default=now())
    return Window(served, seconds, end, {"requests": len(served)}, list(tracer.spans))
