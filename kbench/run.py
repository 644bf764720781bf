"""Runs one cell of the benchmark once and prints one JSON line.

    python3 -m kbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything is found by name: the workload's entry
in `BENCHMARK.json`, its cell file `kbench/cells/<workload>.json` (driver,
rate, slots, context, limits), its configuration file, its traffic mix
`kbench/traffic/<mix>.json` (read by `traffic.py`), its driver
`kbench/drivers/<driver>.py`, each metric's reader
`kbench/metrics/<metric>.py`, the configuration's architecture module
`kbench/arch/<family>.py` (by `model_type`: its checkpoint layout, reference
and useful FLOPs) and each kernel family `kbench/roofline/kernels/<family>.py`
(its kernel names, launches and bounds); `lookup.py` gives the contracts. A
new cell, mix, configuration, metric, architecture or kernel family is new
files and new entries, and no edit.

A run: the model is built from the seed on the card, the cell's traffic is
warmed up (set-up ends there: `setup_s` runs from the process's start), the
window runs for `--seconds`, and the last requests are drained. Then the peak
device memory is read, the program's state is freed and `check.py` decides
`correct`. With `--trace 0` the line carries the cell's end-to-end metrics;
with `--trace 1` its per-layer metrics, read from a profiled slice of the
window, with `busy_s`, `window_s` and the breakdown.

The run refuses (exit code not 0, no result) without a card, with fewer cards
than the cell asks for, or when `jax`, `jaxlib`, `flax` or `kjarni_tpu` is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

from . import lookup  # noqa: E402

KROOT = lookup.KROOT
BENCHMARK = KROOT.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "kjarni_tpu")
TRACE_AT = 0.4            # the traced slice starts this far into the window
TRACE_S = 6.0             # and lasts this long (at most half the window)


def log(msg: str) -> None:
    print(f"kbench: {msg}", file=sys.stderr, flush=True)


class Refused(Exception):
    """A run that must exit without a result."""


def load_parts(bench: dict, workload: str, kroot: Path = KROOT) -> tuple:
    """(workload entry, cell file, configuration file) of a workload."""
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    cell = json.loads((kroot / "cells" / f"{workload}.json").read_text())
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    conf = json.loads((kroot.parent / conf_entry["file"]).read_text())
    if cell["config"] != entry["config"] or cell["traffic"] != entry["traffic"]:
        raise Refused(f"cell file of {workload} disagrees with BENCHMARK.json")
    return entry, cell, conf


def metric_entries(bench: dict, workload: str, trace: bool) -> list:
    """The metrics a run of `workload` reports: with trace, the per-layer
    metrics that list it, or that list no cells and move one of its
    end-to-end metrics; else the end-to-end metrics that list it or none."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", ()) or
            ("workloads" not in m and m["moves"] in names)]


def reader(name: str, kroot: Path = KROOT):
    """The `read(run)` of metric `name`, from kbench/metrics/<name>.py."""
    return lookup.load(Path(kroot) / "metrics" / f"{name}.py").read


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (`kjarni_tpu_torch` is not `kjarni_tpu`)."""
    tops = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(tops.intersection(FORBIDDEN))


def require_chips(n: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise Refused("no CUDA device (torch.cuda.is_available() is false)")
    if torch.cuda.device_count() < n:
        raise Refused(f"the cell needs {n} cards, {torch.cuda.device_count()} found")


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def _requests(cell: dict, mix: dict, seconds: float, hf: dict, seed: int):
    from . import traffic
    V, bos = hf["vocab_size"], hf.get("bos_token_id")
    if mix["loop"] == "open":
        return traffic.open_loop(mix, cell["rate_per_s"], seconds, V, bos, seed)
    cycles = [traffic.closed_cycle(mix, c, V, bos, seed) for c in range(cell["cycles_ready"])]

    def client():
        c = 0
        while True:
            batch = cycles[c] if c < len(cycles) else traffic.closed_cycle(mix, c, V, bos, seed)
            yield from batch
            c += 1
    return client()


def execute(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", kroot: Path = KROOT, control: bool = False,
            t_start: float = T_START) -> dict:
    """One run. Returns {"result": the line's object, "checks", "readings",
    "window", "missing": metrics with nothing to read}; raises Refused where
    the run must not print a result."""
    import torch

    from . import check, model, traffic
    from .trace import Tracer
    entry, cell, conf = load_parts(bench, workload, kroot)
    hf = model.hf_config(conf)
    driver = importlib.import_module(f"kbench.drivers.{cell['driver']}")
    mix = traffic.load_mix(cell["traffic"], kroot / "traffic")
    tmp = Path(tempfile.mkdtemp(prefix="kbench-"))
    try:
        lm = model.build(conf, seed, cell["max_context"], device, tmp / "model", kroot)
        state = driver.setup(lm, cell)
        driver.warm(state, traffic.warm_requests(mix, hf["vocab_size"],
                                                 hf.get("bos_token_id"),
                                                 cell["warm_new_tokens"]))
        reqs = _requests(cell, mix, seconds, hf, seed)
        tracer = Tracer(trace, TRACE_AT * seconds, min(TRACE_S, seconds / 2), kroot)
        tracer.install()
        if device == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.2f} s")
        try:
            window = driver.run(state, reqs, seconds, tracer)
        finally:
            tracer.close()
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        log(f"window {window.end_s:.2f} s, {len(window.served)} requests, "
            f"peak {peak / 2 ** 30:.2f} GiB")
        found = forbidden_modules()
        if found:
            raise Refused(f"modules loaded that the run may not load: {found}")
        del state, lm
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        ok, checks, readings = check.judge(window, hf, seed, cell["check"], device,
                                           conf.get("quantize"), control, kroot)
        log(f"reference {time.perf_counter() - t_ref:.2f} s: {readings}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    run = types.SimpleNamespace(window=window, hf=hf, cell=cell, setup_s=setup_s,
                                slice=tracer.slice)
    metrics, missing = {}, []
    for m in metric_entries(bench, workload, trace):
        value = reader(m["name"], kroot)(run)
        if value is None or not math.isfinite(value):
            missing.append(m["name"])
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(1 for s in window.served if s.done_s is None)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": entry["chips"], "memory_peak_bytes": peak}
    result = {"correct": bool(ok), "attempted": len(window.served), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and tracer.slice is not None:
        dev["busy_s"] = tracer.slice.busy_s
        dev["window_s"] = tracer.slice.window_s
        result["breakdown"] = {"device_ops": tracer.slice.device_ops,
                               "idle_gaps": tracer.slice.idle_gaps}
    result["checks"] = checks
    return {"result": result, "checks": checks, "readings": readings, "window": window,
            "missing": missing}


def check_lines(checks: dict) -> list:
    out = []
    for name, c in checks.items():
        bound = f"limit {c['limit']}" if "limit" in c else f"at least {c['at_least']}"
        out.append(f"check {name} {c['value']} {bound}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m kbench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        bench = json.loads(BENCHMARK.read_text())
        entry, _, _ = load_parts(bench, args.workload)
        require_chips(entry["chips"])
        out = execute(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    except Refused as e:
        log(f"refused: {e}")
        return 2
    res = out["result"]
    res["device"]["power_limit_w"] = power_limit_w()
    for name in out["missing"]:
        log(f"{name}: nothing to read in this run")
    print(json.dumps(res))
    sys.stdout.flush()
    print("\n".join(check_lines(out["checks"])), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
