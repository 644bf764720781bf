"""engine.window_ms.serve: the mean wall time of one engine window (one
`serve_batching.advance`: admission waves, then up to steps_per_sync decode
steps and their one readback), from the harness's span around each call over
the whole window. Host clock."""


def read(run):
    spans = [e - s for name, s, e in run.window.spans if name == "engine.advance"]
    return 1e3 * sum(spans) / len(spans) if spans else None
