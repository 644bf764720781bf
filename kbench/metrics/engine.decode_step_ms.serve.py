"""engine.decode_step_ms.serve: the time of one decode step of the engine on
the card's stream, in ms: the summed CUDA-event time of the program's
`kjarni.engine.decode` spans of the traced slice (a window's k forwards over
all slots and their sampling, up to the readback; from the first operation on
the stream to the last, gaps included) over their summed `k`. A decode step
is launch-bound, so this reads the host's pace, which the profiler roughly
doubles: not the kernels' busy time. Nothing on the CPU, or where the program
records no spans."""

from kbench.spans import named


def read(run):
    spans = [s for s in named("kjarni.engine.decode") if s.device_ms is not None]
    steps = sum(s.counts["k"] for s in spans)
    return sum(s.device_ms for s in spans) / steps if steps else None
