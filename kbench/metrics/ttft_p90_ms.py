"""ttft_p90_ms: the 90th percentile, over every request of the window, of the
time from the call to `generate_stream` to its first yielded token. Host
clock."""

from kbench.stats import percentile


def read(run):
    return 1e3 * percentile([None if s.first_s is None else s.first_s - s.sent_s
                             for s in run.window.served], 90)
