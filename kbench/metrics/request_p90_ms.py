"""request_p90_ms: the 90th percentile, over every request due in the window,
of the time from when it was due to when it finished (open loop: a stall
delays every later request's clock too). A request that failed is missing:
it sorts above every finished one. Host clock."""

from kbench.stats import percentile


def read(run):
    return 1e3 * percentile([s.latency_s for s in run.window.served], 90)
