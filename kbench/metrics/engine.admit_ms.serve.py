"""engine.admit_ms.serve: the mean time of one admission wave on the card's
stream, in ms: the program's `kjarni.engine.admit_wave` spans of the traced
slice, each timed by a pair of CUDA events from the wave's first operation on
the stream to its last (the int4 GEMM at M = lanes x bucket, flash, head,
sampler, scatter), gaps between kernels included. Not the kernels' busy time:
where the host paces the stream the pair reads the host's pace, and under the
profiler that pace is slower than in an untraced run. Nothing on the CPU, or
where the program records no spans."""

from kbench.spans import mean_device_ms, named


def read(run):
    return mean_device_ms(named("kjarni.engine.admit_wave"))
