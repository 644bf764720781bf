"""Profiling and memory observability (port of kjarni_tpu/core/profiling.py).

The reference's three probes (SURVEY §5.1), on torch and the CUDA card:
  * GpuProfiler timestamp queries (gpu_ops/profiler.rs:33) -> a
    torch.profiler trace of the host and the card, written as a Chrome trace
    (chrome://tracing or Perfetto);
  * TracingAllocator RSS counters (utils/alloc_stats.rs:4) -> host RSS via
    /proc/self/status;
  * WgpuContext::print_memory_usage (gpu_ops/context.rs:278) ->
    device_memory_report() over the CUDA caching allocator's statistics.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterator

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | Path) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region (host ops, and the card's kernels when
    there is a card) and write it to <log_dir>/trace.json as a Chrome
    trace. Yields the profiler, whose key_averages() sums the region by
    op and kernel."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named sub-region inside a trace (decode step, prefill, ...): a
    record_function span, and an NVTX range on the card."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


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
