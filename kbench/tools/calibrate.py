"""Readings that a cell's limit is set from, many seeds in one process.

    python3 -m kbench.tools.calibrate --workload <name> --seeds 1,2,3 --seconds 15

For each seed: one whole run at the cell's own load and sizes (a shorter
window, long enough to finish the mix's longest requests), then the check's
sample through the reference and through the control (the reference one
precision down in the program's place) and the sampler's planted faults.
Prints one JSON line per seed: the program's widest gaps, the control's and
the faults', their verdicts under the cell's limits, and the run's other
checks. Exits 1 when the control or a fault reads as correct on any seed. The
model is built anew for each seed, since the weights come from it. The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from kbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m kbench.tools.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    bench = json.loads(run.BENCHMARK.read_text())
    entry, _, _ = run.load_parts(bench, args.workload)
    run.require_chips(entry["chips"])
    passed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = run.execute(bench, args.workload, seed, args.seconds, False, control=True,
                          t_start=t0)
        res = out["result"]
        print(json.dumps({"seed": seed, **out["readings"], "correct": res["correct"],
                          "checks": res["checks"], "metrics": res["metrics"],
                          "attempted": res["attempted"],
                          "peak_gib": res["device"]["memory_peak_bytes"] / 2 ** 30,
                          "seconds": time.perf_counter() - t0}), flush=True)
        r = out["readings"]
        if r.get("control_correct") or any(r.get("faults_correct", {}).values()):
            passed.append(seed)
    if passed:
        print(f"the control or a fault reads as correct on seeds {passed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
