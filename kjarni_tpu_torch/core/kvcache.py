"""Working slice of a fixed-shape KV cache (port of kjarni_tpu/core/kvcache.py).

The JAX package slices the cache to the current bucket and writes it back,
because its layer scan restacks whatever cache it carries. Here the cache is
written in place, so the working slice is a view: writes through it land in
the full cache and there is nothing to write back. It only bounds how much
cache decode attention reads (fill-proportional, not capacity-proportional).
"""

from __future__ import annotations

import torch


def slice_working(cache, kb: int, axis: int):
    """View of the first `kb` positions along the position axis; for the
    int8 cache ({"q": [..., T, D], "s": [..., T]}) a dict of such views,
    the position axis being `axis` in both."""
    if isinstance(cache, dict):
        return {k: t.narrow(axis, 0, kb) for k, t in cache.items()}
    return cache.narrow(axis, 0, kb)
