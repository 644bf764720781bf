"""Profiling and memory observability (port of kjarni_tpu/core/profiling.py).

The reference's three probes (SURVEY §5.1), on torch and the CUDA card:
  * GpuProfiler timestamp queries (gpu_ops/profiler.rs:33) -> a
    torch.profiler trace of the host and the card, written as a Chrome trace
    (chrome://tracing or Perfetto);
  * TracingAllocator RSS counters (utils/alloc_stats.rs:4) -> host RSS via
    /proc/self/status;
  * WgpuContext::print_memory_usage (gpu_ops/context.rs:278) ->
    device_memory_report() over the CUDA caching allocator's statistics.

The program's own spans: `annotate(name, ...)` marks a region of the engine,
the single stream or the model forward. It records exactly while a torch
profiler runs in the process (`trace()`, or any `torch.profiler.profile`);
otherwise it costs one flag read and returns a shared no-op context. A span
that records is kept in memory (`spans()`: name, start and end on
`time.perf_counter_ns()`, the span open around it on its thread, integer
counts, and with `device=True` the stream's time from the span's first
operation to its last, gaps included) and is put on the profiler's host timeline as a
FUNCTION-scope event, which draws nothing on the card's timeline.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from pathlib import Path
from typing import Iterator

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

logger = logging.getLogger(__name__)

TRACE_FILE = "trace.json"
MAX_SPANS = 100_000     # records kept per session; later ones are dropped, with a warning


class Span:
    """One recorded span: `name`, `start_ns` and `end_ns` on
    time.perf_counter_ns(), its `id` in the session, the `parent` span's id
    (None at the top of its thread), integer `counts`, and `device_ms` (the
    stream's time from the span's first operation to its last, gaps
    included; None on the CPU, or until spans() resolves it)."""

    __slots__ = ("name", "id", "parent", "counts", "start_ns", "end_ns", "device_ms",
                 "_events", "_rf")

    def __init__(self, name: str, counts: dict, device: bool):
        self.name, self.counts = name, counts
        self.id, self.parent = -1, None
        self.start_ns = self.end_ns = None
        self.device_ms = None
        self._events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True)) if device else None
        self._rf = None

    def count(self, **counts) -> None:
        """Add counts known only inside the span."""
        self.counts.update(counts)

    def __enter__(self) -> "Span":
        stack = _REC.stack()
        self.parent = stack[-1].id if stack else None
        _REC.add(self)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        self._rf = _RecordFunctionFast(self.name)
        self._rf.__enter__()
        if self._events is not None:
            self._events[0].record()
        return self

    def __exit__(self, *exc) -> None:
        if self._events is not None:
            self._events[1].record()
        self._rf.__exit__(None, None, None)
        self._rf = None
        self.end_ns = time.perf_counter_ns()
        stack = _REC.stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:       # a generator's span closed out of order
            stack.remove(self)


class _Off:
    """The shared context of a span that does not record; false, so that a
    caller computes counts only for a span that records (`if span:`)."""

    def __bool__(self) -> bool:
        return False

    def count(self, **counts) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass


_OFF = _Off()


class _Recorder:
    """The process's spans: the newest recording session's records."""

    def __init__(self):
        self.records: list = []
        self.full = False
        self.session = 0
        self.fresh = True        # the next span that finds a profiler starts a session
        self._local = threading.local()
        self._lock = threading.Lock()

    def stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def begin(self) -> None:
        with self._lock:
            if self.fresh:
                self.records, self.full = [], False
                self.session += 1
                self.fresh = False

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self.records) >= MAX_SPANS:
                if not self.full:
                    self.full = True
                    logger.warning("%d spans recorded in this session; later ones are "
                                   "not kept", MAX_SPANS)
                return
            span.id = len(self.records)
            self.records.append(span)


_REC = _Recorder()


def recording() -> bool:
    """True while a torch profiler runs in this process. The first call that
    finds one running after a call found none starts a new session."""
    if not _profiler_enabled():
        _REC.fresh = True
        return False
    if _REC.fresh:
        _REC.begin()
    return True


def session() -> int:
    """The number of the newest recording session (0 before the first)."""
    return _REC.session


def annotate(name: str, *, device: bool = False, **counts: int):
    """A named span (engine window, prefill, decode step, ...). Use as a
    context; `with annotate(...) as sp: sp.count(k=...)` adds counts known
    only inside it, and `sp` is false when it does not record. Records
    only while a profiler runs (module docstring); `device=True` also times
    the card between the span's ends with a pair of CUDA events on the
    current stream (pass it only for work on a CUDA card)."""
    if not recording():
        return _OFF
    return Span(name, counts, device)


def note(name: str, start_ns: int, end_ns: int) -> None:
    """Record a span stamped as it went (a request's wait, from its submit
    to its first token), while recording. It is not on the profiler's
    timeline."""
    if not recording():
        return
    span = Span(name, {}, False)
    stack = _REC.stack()
    span.parent = stack[-1].id if stack else None
    span.start_ns, span.end_ns = start_ns, end_ns
    _REC.add(span)


def spans() -> list[Span]:
    """The newest session's spans, in the order they began, with each
    finished span's `device_ms` resolved (one synchronize, then each CUDA
    event pair's elapsed time)."""
    recs = list(_REC.records)
    pending = [s for s in recs if s._events is not None and s.end_ns is not None]
    if pending:
        torch.cuda.synchronize()
        for s in pending:
            s.device_ms = s._events[0].elapsed_time(s._events[1])
            s._events = None
    return recs


def reset() -> None:
    """Clear the records; the next span that records starts a new session."""
    with _REC._lock:
        _REC.records, _REC.full = [], False
    _REC.fresh = True


@contextlib.contextmanager
def trace(log_dir: str | Path) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region (host ops, and the card's kernels when
    there is a card) and write it to <log_dir>/trace.json as a Chrome
    trace. Yields the profiler, whose key_averages() sums the region by
    op and kernel. The region's spans are a recording session of their own
    (spans())."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    _REC.fresh = True
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / TRACE_FILE))


def host_memory_mb() -> dict[str, float]:
    """Current/peak host RSS in MB (TracingAllocator analogue)."""
    out = {"rss_mb": 0.0, "peak_rss_mb": 0.0}
    try:
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith("VmRSS:"):
                out["rss_mb"] = float(line.split()[1]) / 1024
            elif line.startswith("VmHWM:"):
                out["peak_rss_mb"] = float(line.split()[1]) / 1024
    except OSError:
        pass
    return out


def device_memory_report() -> list[dict]:
    """Per-card allocator accounting (print_memory_usage analogue): one
    entry per CUDA card with live, peak and total MB, or one CPU entry with
    no device statistics when there is no card."""
    if not torch.cuda.is_available():
        return [{"device": "cpu", "live_buffer_mb": None}]
    report = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        report.append({
            "device": f"cuda:{i} {torch.cuda.get_device_name(i)}",
            "live_buffer_mb": stats.get("allocated_bytes.all.current", 0) / 1e6,
            "peak_mb": stats.get("allocated_bytes.all.peak", 0) / 1e6,
            "reserved_mb": stats.get("reserved_bytes.all.current", 0) / 1e6,
            "limit_mb": torch.cuda.get_device_properties(i).total_memory / 1e6,
        })
    return report


def print_memory_usage() -> None:
    host = host_memory_mb()
    print(f"[kjarni] host rss: {host['rss_mb']:.0f} MB "
          f"(peak {host['peak_rss_mb']:.0f} MB)")
    for entry in device_memory_report():
        if entry.get("live_buffer_mb") is not None:
            print(f"[kjarni] {entry['device']}: "
                  f"{entry['live_buffer_mb']:.0f} MB live"
                  + (f" (peak {entry['peak_mb']:.0f} MB)"
                     if "peak_mb" in entry else ""))
        else:
            print(f"[kjarni] {entry['device']}: memory stats unavailable")
