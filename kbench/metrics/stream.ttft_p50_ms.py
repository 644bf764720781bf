"""stream.ttft_p50_ms: the median time to first token of the single stream,
over every request of the traced run's window (a steadier statistic beside
ttft_p90_ms). Host clock."""

from kbench.stats import percentile


def read(run):
    return 1e3 * percentile([None if s.first_s is None else s.first_s - s.sent_s
                             for s in run.window.served], 50)
