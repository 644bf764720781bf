"""Static-shape bucketing.

XLA traces and compiles one program per distinct input shape. The reference's Rust
kernels ran on ragged batches directly; on TPU we instead pad (batch, seq) up to a
small set of buckets so each bucket compiles once and is reused. Masks keep the
padding inert. Cf. SURVEY.md §7 "Static shapes everywhere".
"""

from __future__ import annotations

from typing import Sequence

# Powers of two keep the MXU tiles full; the 8-floor keeps tiny inputs from
# generating degenerate (sublane-misaligned) shapes.
DEFAULT_SEQ_BUCKETS: tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
DEFAULT_BATCH_BUCKETS: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; the largest bucket caps (callers must truncate first)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def seq_bucket(n: int, max_len: int | None = None,
               buckets: Sequence[int] = DEFAULT_SEQ_BUCKETS) -> int:
    b = bucket_for(n, buckets)
    if max_len is not None:
        b = min(b, max_len)
        # max_len itself may not be a bucket; if n fits under max_len but the
        # bucket overshoots, clamp to max_len so we never exceed the model limit.
        if n > b:
            b = max_len
    return b


def batch_bucket(n: int, buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS) -> int:
    return bucket_for(n, buckets)
