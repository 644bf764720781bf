"""engine.tokens_per_window.serve: tokens the engine delivered per window over
the run's window, from its own counters (`stats["tokens"] / stats["windows"]`)."""


def read(run):
    c = run.window.counters
    return c["tokens"] / c["windows"] if c.get("windows") else None
