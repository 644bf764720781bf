"""The traced slice of a `--trace 1` run, and what is read from it.

A run with tracing on profiles one slice of its window with torch.profiler
(host ops and the card's kernels) and, over the same slice, records the shapes
of every launch of each kernel family. A family is a file,
`kbench/roofline/kernels/<family>.py` (`lookup.py` gives its contract): its
device kernels' names, the program's function whose calls are its launches,
the launch record and the launch's bound. A new family is a new file, with no
edit here. While the tracer is installed, every binding of each family's
function in the program's loaded modules is wrapped (a module that imports it
under its own name too); the wrappers pass their arguments through unchanged,
and only the outermost call records, so a function that calls itself through
its own module's name is one launch. The card is synchronised at both ends of
the slice, so the launches recorded are the kernels traced.

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
import importlib
import sys
import time
from pathlib import Path
from typing import Optional

from . import lookup

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


def kernel_family(name: str, families: dict) -> Optional[str]:
    """The family of `families` whose kernel names `name` holds, or None."""
    for fam, mod in families.items():
        if any(p in name for p in mod.KERNELS):
            return fam
    return None


def launch_bound_s(rec: tuple, families: Optional[dict] = None) -> float:
    """The least time of one recorded launch, (family, *its record), by its
    family's `bound_s`."""
    fams = lookup.kernel_families() if families is None else families
    return fams[rec[0]].bound_s(rec[1:])


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

    def __init__(self, window_s: float, dev: list, host: list, launches: list,
                 families: Optional[dict] = None):
        fams = lookup.kernel_families() if families is None else families
        self.window_s = window_s
        t0 = min([s for _, s, _ in dev + host], default=0)
        t1 = max([e for _, _, e in dev + host], default=0)
        busy = busy_intervals(dev)
        self.busy_s = sum(e - s for s, e in busy) / 1e9
        self.device_s: dict = {}
        self.kernel_count: dict = {}
        by_name: dict = {}
        for name, s, e in dev:
            fam = kernel_family(name, fams)
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
            self.bound_s[rec[0]] = self.bound_s.get(rec[0], 0.0) + launch_bound_s(rec, fams)
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

    def __init__(self, on: bool, start_s: float, length_s: float,
                 kroot: Path = lookup.KROOT):
        self.on, self.start_s, self.end_s = on, start_s, start_s + length_s
        self.kroot = kroot
        self.active = False
        self.done = not on
        self.launches: list = []
        self.slice: Optional[Slice] = None
        self._families: Optional[dict] = None
        self._prof = None
        self._t0 = 0.0
        self._bindings: list = []   # (module, name, the function it held)
        self.spans: list = []     # (name, start_s, end_s) on the harness clock

    def install(self) -> None:
        """Wrap every binding of each kernel family's entry function in the
        program's loaded modules, and start and stop the profiler once, so
        that its first start (CUPTI's set-up, seconds long) falls into set-up
        and not into the slice."""
        if not self.on:
            return
        with _profiler():
            _sync()
        self._families = lookup.kernel_families(self.kroot)
        for fam, mod in self._families.items():
            module, name = mod.ENTRY.split(":")
            entry = getattr(importlib.import_module(module), name)
            launch = self._wrap(fam, mod.record, entry)
            package = module.split(".")[0]
            for m in list(sys.modules.values()):
                if m is None or getattr(m, "__name__", "").split(".")[0] != package:
                    continue
                for attr in [k for k, v in getattr(m, "__dict__", {}).items()
                             if v is entry]:
                    self._bindings.append((m, attr, entry))
                    setattr(m, attr, launch)

    def _wrap(self, family: str, record, entry):
        """`entry` recording the launch of each outermost call while active.
        It shares the entry's attributes (the program's launch counters)."""
        depth = 0

        def launch(*args, **kwargs):
            nonlocal depth
            if depth == 0 and self.active:
                rec = record(args, kwargs)
                if rec is not None:
                    self.launches.append((family, *rec))
            depth += 1
            try:
                return entry(*args, **kwargs)
            finally:
                depth -= 1

        launch.__name__, launch.__qualname__ = entry.__name__, entry.__qualname__
        launch.__doc__ = entry.__doc__
        launch.__dict__ = entry.__dict__
        return launch

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
        fams = self._families if self._families is not None \
            else lookup.kernel_families(self.kroot)
        self.slice = Slice(window_s, dev, host, self.launches, fams)

    def close(self) -> None:
        self.stop()
        self.done = True
        for m, attr, entry in reversed(self._bindings):
            setattr(m, attr, entry)
        self._bindings = []

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
