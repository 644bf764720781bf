"""moe.rows_per_expert.serve: the mean rows an expert receives in one MoE
layer call over the traced slice: the summed `rows` (tokens x experts per
token) of the program's `kjarni.moe` spans over (their number x the
configuration's `n_routed_experts`). Padding rows and idle slots count, as
the program routes them. Nothing where the program records no such span."""

from kbench.spans import named


def read(run):
    spans = named("kjarni.moe")
    if not spans:
        return None
    return sum(s.counts["rows"] for s in spans) / (len(spans) * run.hf["n_routed_experts"])
