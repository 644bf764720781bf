"""stream.pad_share.stream: the share of the single stream's prefill tokens
that are padding, in percent: 100 x (1 - summed prompt tokens / summed
bucket) over the program's `kjarni.stream.prefill` spans of the traced slice
(counts the program keeps; a reused prefix is not prefilled and not
counted)."""

from kbench.spans import named, pad_share


def read(run):
    return pad_share(named("kjarni.stream.prefill"))
