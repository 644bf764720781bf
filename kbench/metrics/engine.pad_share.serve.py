"""engine.pad_share.serve: the share of the admission waves' prefill tokens
that are padding, in percent: 100 x (1 - summed prompt tokens / summed lanes
x bucket) over the program's `kjarni.engine.admit_wave` spans of the traced
slice (counts the program keeps)."""

from kbench.spans import named, pad_share


def read(run):
    return pad_share(named("kjarni.engine.admit_wave"))
