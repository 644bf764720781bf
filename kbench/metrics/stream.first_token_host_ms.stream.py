"""stream.first_token_host_ms.stream: the part of the single stream's time to
first token in which the card was not running the request's prefill, in ms:
the mean over the program's `kjarni.stream.request` spans of the traced
slice of (first token - the span's start) - the card time of its
`kjarni.stream.prefill` (0 on the CPU, which has no card time). Host clock
less device time."""

from kbench.spans import named


def read(run):
    prefill_ms = {}
    for s in named("kjarni.stream.prefill"):
        prefill_ms[s.parent] = prefill_ms.get(s.parent, 0.0) + (s.device_ms or 0.0)
    rest = [(s.counts["first_token_ns"] - s.start_ns) / 1e6 - prefill_ms[s.id]
            for s in named("kjarni.stream.request")
            if s.counts.get("first_token_ns") is not None and s.id in prefill_ms]
    return sum(rest) / len(rest) if rest else None
