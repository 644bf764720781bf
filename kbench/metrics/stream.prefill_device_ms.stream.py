"""stream.prefill_device_ms.stream: the mean card time of one prefill of the
single stream, in ms: the program's `kjarni.stream.prefill` spans of the
traced slice (the bucketed forward through the head), each timed by a pair of
CUDA events from its first operation on the stream to its last. The prefill
is bound by the card (its enqueue runs ahead of the stream), so the pair
reads the card's work. Nothing on the CPU, or where the program records no
spans."""

from kbench.spans import mean_device_ms, named


def read(run):
    return mean_device_ms(named("kjarni.stream.prefill"))
