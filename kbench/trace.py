"""The traced slice of a `--trace 1` run, and what is read from it.

A run with tracing on profiles one slice of its window with torch.profiler
(host ops and the card's kernels) and, over the same slice, records the shapes
of every launch of the program's two hand-written kernels by wrapping the two
names `models/llama.py` calls (`int4_matvec`, `flash_attention`); the wrappers
pass their arguments through unchanged. The card is synchronised at both ends
of the slice, so the launches recorded are the kernels traced.

From the slice: the seconds in which any operation ran on the card (`busy_s`,
the union of kernel, copy and set intervals), the slice's length
(`window_s`), each kernel family's device seconds and count, the kernels that
took most time, and the longest idle gaps labelled by what the host was doing
(the harness span and the innermost host op around the gap's middle; "python"
where no op was running).
"""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import Optional

from .roofline.costs import bound_s, flash_cost, int4_cost

KERNELS = {"int4": ("int4_gemv_kernel", "int4_gemm_kernel"),
           "flash": ("flash_fwd_kernel",)}
SPAN_PREFIX = "kbench."
GAP_LABELLED = 400        # longest gaps given a label
TOP = 10


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")() * 1000)


def _events(prof) -> tuple[list, list]:
    """(device events, host events) of a finished profile, each a list of
    (name, start_ns, end_ns) sorted by start."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        rec = (e.name(), start, end)
        if not str(e.device_type()).endswith("CUDA"):
            host.append(rec)
        elif not rec[0].startswith(SPAN_PREFIX):   # not a span's shadow on the card
            dev.append(rec)
    dev.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    return dev, host


def busy_intervals(dev: list) -> list:
    """The union of device intervals [(start_ns, end_ns)], sorted."""
    out = []
    for _, s, e in dev:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(busy: list, start_ns: int, end_ns: int) -> list:
    """Idle intervals of the slice [start_ns, end_ns) between busy ones."""
    out, t = [], start_ns
    for s, e in busy:
        if s > t:
            out.append((t, min(s, end_ns)))
        t = max(t, e)
    if t < end_ns:
        out.append((t, end_ns))
    return [(a, b) for a, b in out if b > a]


def _innermost(events: list, starts: list, m: int, reach_ns: int) -> Optional[str]:
    """The shortest event of `events` (sorted by start) that holds time m,
    looking back no further than reach_ns."""
    best = None
    i = bisect.bisect_right(starts, m) - 1
    while i >= 0 and events[i][1] >= m - reach_ns:
        name, s, e = events[i]
        if e >= m and (best is None or e - s < best[1]):
            best = (name, e - s)
        i -= 1
    return None if best is None else best[0]


def label_gaps(idle: list, host: list) -> list:
    """[[label, seconds], ...]: the longest idle gaps summed by what the host
    was doing at each gap's middle, the largest first."""
    spans = [h for h in host if h[0].startswith(SPAN_PREFIX)]
    ops = [h for h in host if not h[0].startswith(SPAN_PREFIX)]
    span_starts, op_starts = [s for _, s, _ in spans], [s for _, s, _ in ops]
    sums: dict = {}
    for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:GAP_LABELLED]:
        m = (a + b) // 2
        span = _innermost(spans, span_starts, m, 10 ** 12) or "outside spans"
        op = _innermost(ops, op_starts, m, 2 * 10 ** 9) or "python"
        key = f"{span[len(SPAN_PREFIX):] if span.startswith(SPAN_PREFIX) else span} / {op}"
        sums[key] = sums.get(key, 0.0) + (b - a) / 1e9
    return sorted(([k, v] for k, v in sums.items()), key=lambda kv: -kv[1])[:TOP]


def kernel_family(name: str) -> Optional[str]:
    for fam, pats in KERNELS.items():
        if any(p in name for p in pats):
            return fam
    return None


def launch_bound_s(rec: tuple) -> float:
    """The least time of one recorded launch (roofline/costs.py)."""
    if rec[0] == "int4":
        _, M, K, N, G, xb, yb = rec
        return bound_s(*int4_cost(M, K, N, G, xb, yb))
    _, B, H, Hkv, S, T, D, causal, window, q_offset, kv_len = rec
    return bound_s(*flash_cost(B, H, Hkv, S, T, D, causal, window, q_offset, kv_len))


def _sync() -> bool:
    """Wait for the card, where there is one; False on the CPU."""
    import torch
    if not torch.cuda.is_available():
        return False
    torch.cuda.synchronize()
    return True


def _profiler():
    """A profiler of host ops and, where there is a card, its kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    return profile(activities=[ProfilerActivity.CPU] + cuda)


class Slice:
    """What one traced slice holds, as the metric readers see it."""

    def __init__(self, window_s: float, dev: list, host: list, launches: list):
        self.window_s = window_s
        t0 = min([s for _, s, _ in dev + host], default=0)
        t1 = max([e for _, _, e in dev + host], default=0)
        busy = busy_intervals(dev)
        self.busy_s = sum(e - s for s, e in busy) / 1e9
        self.device_s: dict = {}
        self.kernel_count: dict = {}
        by_name: dict = {}
        for name, s, e in dev:
            fam = kernel_family(name)
            if fam is not None:
                self.device_s[fam] = self.device_s.get(fam, 0.0) + (e - s) / 1e9
                self.kernel_count[fam] = self.kernel_count.get(fam, 0) + 1
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
        self.device_ops = sorted(([n[:120], v] for n, v in by_name.items()),
                                 key=lambda kv: -kv[1])[:TOP]
        self.idle_gaps = label_gaps(gaps(busy, t0, t1), host) if dev else []
        self.bound_s: dict = {}
        self.launch_count: dict = {}
        for rec in launches:
            self.bound_s[rec[0]] = self.bound_s.get(rec[0], 0.0) + launch_bound_s(rec)
            self.launch_count[rec[0]] = self.launch_count.get(rec[0], 0) + 1

    def roofline_pct(self, family: str) -> Optional[float]:
        """100 x the launches' least time over the kernels' device time;
        None where nothing ran, or where the launches recorded are not the
        kernels traced (a share of unmatched counts would be wrong)."""
        n = self.launch_count.get(family, 0)
        if n == 0 or self.kernel_count.get(family, 0) != n:
            return None
        return 100.0 * self.bound_s[family] / self.device_s[family]


class Tracer:
    """Profiles [start_s, start_s + length_s) of the window when `on`;
    otherwise only keeps the harness's host spans. Drivers call poll(now)
    between units of work, and wrap each unit in span(name)."""

    def __init__(self, on: bool, start_s: float, length_s: float):
        self.on, self.start_s, self.end_s = on, start_s, start_s + length_s
        self.active = False
        self.done = not on
        self.launches: list = []
        self.slice: Optional[Slice] = None
        self._prof = None
        self._t0 = 0.0
        self._unpatch = None
        self.spans: list = []     # (name, start_s, end_s) on the harness clock

    def install(self) -> None:
        """Wrap the two kernel names models/llama.py calls, and start and
        stop the profiler once, so that its first start (CUPTI's set-up,
        seconds long) falls into set-up and not into the slice."""
        if not self.on:
            return
        with _profiler():
            _sync()
        from kjarni_tpu_torch.models import llama
        orig_int4, orig_flash = llama.int4_matvec, llama.flash_attention

        def int4_matvec(x, w4, scale):
            if self.active:
                M, K = x.shape
                xb = x.element_size() if M == 1 else 2
                self.launches.append(("int4", M, K, w4.shape[1], scale.shape[0], xb,
                                      x.element_size()))
            return orig_int4(x, w4, scale)

        def flash_attention(q, k, v, *, causal=False, scale=None, window=None,
                            q_offset=0, kv_len=None):
            if self.active and q.dtype.itemsize == 2:
                B, H, S, D = q.shape
                self.launches.append(("flash", B, H, k.shape[1], S, k.shape[2], D,
                                      causal, window, int(q_offset),
                                      k.shape[2] if kv_len is None else int(kv_len)))
            return orig_flash(q, k, v, causal=causal, scale=scale, window=window,
                              q_offset=q_offset, kv_len=kv_len)

        llama.int4_matvec, llama.flash_attention = int4_matvec, flash_attention

        def unpatch():
            llama.int4_matvec, llama.flash_attention = orig_int4, orig_flash
        self._unpatch = unpatch

    def poll(self, now_s: float) -> None:
        if self.done:
            return
        if not self.active and now_s >= self.start_s:
            _sync()
            self._prof = _profiler()
            self._prof.__enter__()
            self._t0 = time.perf_counter()
            self.active = True
        elif self.active and now_s >= self.end_s:
            self.stop()

    def stop(self) -> None:
        """End the slice (if it runs) and read it."""
        if not self.active:
            return
        _sync()
        window_s = time.perf_counter() - self._t0
        self.active = False
        self.done = True
        self._prof.__exit__(None, None, None)
        dev, host = _events(self._prof)
        self._prof = None
        self.slice = Slice(window_s, dev, host, self.launches)

    def close(self) -> None:
        self.stop()
        self.done = True
        if self._unpatch is not None:
            self._unpatch()
            self._unpatch = None

    @contextlib.contextmanager
    def span(self, name: str, clock):
        t0 = clock()
        if self.active:
            import torch
            with torch.profiler.record_function(SPAN_PREFIX + name):
                yield
        else:
            yield
        self.spans.append((name, t0, clock()))
