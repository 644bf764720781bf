"""The program's own spans of a traced run, for the per-layer readers.

The program records its spans while a torch profiler runs
(`kjarni_tpu_torch.core.profiling.spans()`: the newest recording session,
here the traced slice). A program that records none, or has no such
function, gives an empty list, and the readers then report nothing.
"""

from __future__ import annotations


def named(name: str) -> list:
    """The spans called `name` of the newest recording session, in the order
    they began."""
    try:
        from kjarni_tpu_torch.core import profiling
    except ImportError:
        return []
    spans = getattr(profiling, "spans", None)
    return [] if spans is None else [s for s in spans() if s.name == name]


def pad_share(spans: list) -> float | None:
    """100 x (1 - prompt tokens / padded tokens) over prefill spans, each
    padding `lanes` (1 where not counted) prompts to `bucket`."""
    padded = sum(s.counts.get("lanes", 1) * s.counts["bucket"] for s in spans)
    if not padded:
        return None
    return 100.0 * (1.0 - sum(s.counts["prompt_tokens"] for s in spans) / padded)


def mean_device_ms(spans: list) -> float | None:
    """The mean CUDA-event time (`device_ms`) of the spans; None on the CPU,
    which has none."""
    ms = [s.device_ms for s in spans if s.device_ms is not None]
    return sum(ms) / len(ms) if ms else None
