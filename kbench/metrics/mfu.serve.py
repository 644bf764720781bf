"""mfu.serve: model FLOPs of the useful work of every request of the window,
over (seconds from the window's start until its last request finished) x the
H100's bf16 peak, in percent. Useful work counts unpadded prompts, the head
only where a token is sampled, and each decoded token over its context
(roofline/costs.py::useful_flops), so padding to buckets lowers it."""

from kbench.roofline.costs import useful_flops
from kbench.roofline.peaks import BF16_FLOP_PER_S


def read(run):
    w = run.window
    flops = sum(useful_flops(run.hf, len(s.request.token_ids), len(s.tokens))
                for s in w.served if s.done_s is not None)
    return 100.0 * flops / (w.end_s * BF16_FLOP_PER_S) if flops else None
