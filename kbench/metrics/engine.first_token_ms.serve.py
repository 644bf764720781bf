"""engine.first_token_ms.serve: the mean time from a request's submit to the
engine to the readback that delivers its first token, in ms, over the
program's `kjarni.engine.first_token` records of the traced slice (every
request submitted inside it whose first token came back inside it). Host
clock (time.perf_counter_ns)."""

from kbench.spans import named


def read(run):
    waits = [s.end_ns - s.start_ns for s in named("kjarni.engine.first_token")]
    return sum(waits) / len(waits) / 1e6 if waits else None
