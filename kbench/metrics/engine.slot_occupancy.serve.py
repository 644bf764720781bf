"""engine.slot_occupancy.serve: the share of the slot-steps the engine decodes
that belong to a live request, in percent: 100 x summed active x k / summed
S x k over the program's `kjarni.engine.decode` spans of the traced slice
(every decode step computes all S slots; counts the program keeps)."""

from kbench.spans import named


def read(run):
    spans = named("kjarni.engine.decode")
    total = sum(s.counts["S"] * s.counts["k"] for s in spans)
    if not total:
        return None
    return 100.0 * sum(s.counts["active"] * s.counts["k"] for s in spans) / total
