"""Finds an open-loop cell's knee once: the highest offered rate at which the
program's completions keep up with arrivals over the window.

    python3 -m kbench.tools.sweep --workload <name> --rates 2,3,4 --seeds 1,2,3 \\
        --seconds 51 [--fresh]

One process builds the model and warms up once, then offers each rate on each
seed for a window and drains it. Per rate and seed it prints the requests
offered, those in flight when the window closed, those finished inside it, how
long the drain took, the latency percentiles, and the median latency of the
first and of the last third of the arrivals. A rate keeps up while, on every
seed, the requests in flight at the close stay near rate x median latency
(Little's law: no queue left over) and the drain is no longer than a median
request; the cell's rate is four fifths of the highest such rate, written into
its cell file by hand.

`--fresh` draws each seed's set of requests and gaps anew (`traffic.pool`
with the seed) instead of reordering the one fixed set, to compare the fixed
set's tail with fresh draws' at one rate.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import tempfile
import time
from pathlib import Path

from kbench import model, run, traffic
from kbench.stats import percentile
from kbench.trace import Tracer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m kbench.tools.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="comma-separated, per second")
    ap.add_argument("--seeds", default="20260101", help="comma-separated")
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--fresh", action="store_true")
    args = ap.parse_args(argv)
    bench = json.loads(run.BENCHMARK.read_text())
    entry, cell, conf = run.load_parts(bench, args.workload)
    run.require_chips(entry["chips"])
    hf = model.hf_config(conf)
    mix = traffic.load_mix(cell["traffic"])
    driver = importlib.import_module(f"kbench.drivers.{cell['driver']}")
    seeds = [int(s) for s in args.seeds.split(",")]
    with tempfile.TemporaryDirectory(prefix="kbench-") as tmp:
        lm = model.build(conf, seeds[0], cell["max_context"], "cuda", Path(tmp) / "model")
        state = driver.setup(lm, cell)
        driver.warm(state, traffic.warm_requests(mix, hf["vocab_size"], hf.get("bos_token_id"),
                                                 cell["warm_new_tokens"]))
        for rate in (float(r) for r in args.rates.split(",")):
            for seed in seeds:
                pool_seed = seed if args.fresh else traffic.POOL_SEED
                reqs = traffic.open_loop(mix, rate, args.seconds, hf["vocab_size"],
                                         hf.get("bos_token_id"), seed, pool_seed)
                t0 = time.perf_counter()
                w = driver.run(state, reqs, args.seconds, Tracer(False, 0, 0))
                lat = [s.latency_s for s in w.served]
                third = max(1, len(lat) // 3)
                print(json.dumps({
                    "rate": rate, "seed": seed, "fresh": args.fresh, "offered": len(reqs),
                    "in_flight_at_close": sum(1 for s in w.served
                                              if s.done_s is None or s.done_s > args.seconds),
                    "unfinished": sum(1 for s in w.served if s.done_s is None),
                    "drain_s": w.end_s - args.seconds,
                    "p50_ms": 1e3 * percentile(lat, 50), "p90_ms": 1e3 * percentile(lat, 90),
                    "p50_first_third_ms": 1e3 * percentile(lat[:third], 50),
                    "p50_last_third_ms": 1e3 * percentile(lat[-third:], 50),
                    "windows": w.counters.get("windows"), "tokens": w.counters.get("tokens"),
                    "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
