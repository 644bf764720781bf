"""The one traffic generator: a mix is a data file, `kbench/traffic/<mix>.json`.

Every seed gets the same set of requests and gaps in another order, so two
seeds offer the same work and differ only in which request comes when, which
tokens it holds and which weights serve it. The set is one random draw from
the mix's distributions (`POOL_SEED`): each request's prompt length, output
length and kind (greedy or sampled) drawn together, and, in an open loop, the
gaps between arrivals drawn as independent exponentials. The seed shuffles the
requests and, independently, the gaps.

An open loop's window is cut into `strata` blocks of equal length. The n =
rate x seconds requests, longest prompt first, are dealt to the blocks forth
and back (the first k to blocks 0..k-1, the next k to blocks k-1..0; the last
n mod k, the shortest, to the lightest blocks), so the blocks hold an equal
count and near-equal prefill work. Each block's arrivals
are its count + 1 exponential gaps (one draw) scaled to fill the block:
uniform order statistics, a Poisson process at the rate conditioned on the
block's count. Within a block the seed orders the requests and the gaps, so
arrivals and long prompts cluster as a Poisson stream's do; only the count and
the prefill work of each block are fixed. With one block this is the Poisson
process conditioned on n alone.

Keys of a mix file:
  source          where the distributions come from (one line)
  loop            "open" (arrivals at a rate the cell fixes) or "closed"
                  (one client: the next request when the last one ends)
  prompt_tokens   a length distribution (below), BOS included
  output_tokens   a length distribution: max_new_tokens of each request
  greedy_share    the share of requests decoded greedily; the rest sample
  sampling        temperature, top_k, top_p, min_p of the sampled requests
  strata          open loop only: the blocks the window is cut into (default 1)
  cycle           closed loop only: the size of the set the client sends in
                  a new order, cycle after cycle

A length distribution is {"dist": "lognormal", "median": m, "sigma": s,
"min": a, "max": b} (clipped to [a, b]), {"dist": "uniform", "min": a,
"max": b} or {"dist": "fixed", "value": n}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import random
from pathlib import Path
from typing import Optional

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
WARM_SEED = 0x5EED        # warm-up requests are the same in every run
POOL_SEED = 0xFA17        # the one draw of sizes and gaps that every seed reorders
FIRST_ID = 3              # ids 0-2 are special in the benchmark's vocabularies


@dataclasses.dataclass
class Request:
    index: int
    due_s: float                 # open loop: when it is due, from the window's start
    token_ids: list
    max_new_tokens: int
    greedy: bool
    sampling: Optional[dict]     # temperature, top_k, top_p, min_p; None if greedy
    seed: int


def load_mix(name: str, root: Path = TRAFFIC_DIR) -> dict:
    return json.loads((Path(root) / f"{name}.json").read_text())


def length(dist: dict, rng: random.Random) -> int:
    """One length drawn from a length distribution."""
    if dist["dist"] == "fixed":
        return int(dist["value"])
    if dist["dist"] == "uniform":
        return rng.randint(dist["min"], dist["max"])
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    x = rng.lognormvariate(math.log(dist["median"]), dist["sigma"])
    return int(min(max(round(x), dist["min"]), dist["max"]))


def pool(mix: dict, n: int, pool_seed: int = POOL_SEED) -> list[tuple[int, int, bool]]:
    """The set of n requests every seed reorders: (prompt length, output
    length, greedy), drawn together; exactly round(n x greedy_share) greedy."""
    rng = random.Random(f"pool:{pool_seed}:{n}")
    greedy = [i < round(n * mix.get("greedy_share", 1.0)) for i in range(n)]
    rng.shuffle(greedy)
    return [(length(mix["prompt_tokens"], rng), length(mix["output_tokens"], rng), g)
            for g in greedy]


def _requests(mix: dict, order: list, vocab: int, bos: Optional[int],
              rng: random.Random, due: list) -> list[Request]:
    sampling = mix.get("sampling")
    out = []
    for i, (p, o, greedy) in enumerate(order):
        head = [] if bos is None else [bos]
        ids = head + [rng.randrange(FIRST_ID, vocab) for _ in range(max(p - len(head), 1))]
        out.append(Request(i, due[i], ids, o, greedy, None if greedy else dict(sampling),
                           rng.randrange(2 ** 31)))
    return out


def open_loop(mix: dict, rate: float, seconds: float, vocab: int,
              bos: Optional[int], seed: int, pool_seed: int = POOL_SEED) -> list[Request]:
    """The requests due in a window of `seconds` at `rate` per second, in
    order of arrival. `pool_seed` other than POOL_SEED draws another set, to
    compare the fixed set with fresh draws."""
    if mix["loop"] != "open":
        raise ValueError("open_loop takes an open-loop mix")
    n = max(1, round(rate * seconds))
    k = min(int(mix.get("strata", 1)), n)
    blocks: list = [[] for _ in range(k)]
    ranked = sorted(pool(mix, n, pool_seed), reverse=True)
    full = n - n % k
    for i, req in enumerate(ranked[:full]):
        g, r = divmod(i, k)
        blocks[r if g % 2 == 0 else k - 1 - r].append(req)
    for req in ranked[full:]:       # the shortest: one each to the lightest blocks
        min(blocks, key=lambda b: (len(b), sum(p for p, _, _ in b))).append(req)
    drawn = random.Random(f"gaps:{pool_seed}:{n}")
    rng = random.Random(f"arrivals:{seed}")
    order, due = [], []
    for b, block in enumerate(blocks):
        gaps = [drawn.expovariate(rate) for _ in range(len(block) + 1)]
        rng.shuffle(block)
        rng.shuffle(gaps)
        scale = seconds / k / sum(gaps)
        t = b * seconds / k
        for g in gaps[:-1]:
            t += g * scale
            due.append(t)
        order += block
    return _requests(mix, order, vocab, bos, random.Random(seed), due)


def closed_cycle(mix: dict, cycle: int, vocab: int, bos: Optional[int],
                 seed: int) -> list[Request]:
    """One cycle of a closed-loop client: the set of `mix["cycle"]` requests,
    in the order the client sends them this cycle."""
    if mix["loop"] != "closed":
        raise ValueError("closed_cycle takes a closed-loop mix")
    rng = random.Random(seed * 1_000_003 + cycle)
    order = pool(mix, int(mix["cycle"]))
    rng.shuffle(order)
    return _requests(mix, order, vocab, bos, rng, [0.0] * len(order))


def warm_lengths(mix: dict) -> list[int]:
    """One prompt length for each size class the mix can draw: the clip
    bounds and every power of two between them, so that warm-up meets every
    prompt bucket the window will."""
    d = mix["prompt_tokens"]
    if d["dist"] == "fixed":
        return [int(d["value"])]
    out, b = {d["min"], d["max"]}, 1
    while b < d["max"]:
        if b > d["min"]:
            out.add(b)
        b *= 2
    return sorted(out)


def warm_requests(mix: dict, vocab: int, bos: Optional[int],
                  new_tokens: int) -> list[Request]:
    """Warm-up requests: for every length of warm_lengths, one greedy and
    (when the mix samples) one sampled request, the same in every run."""
    rng = random.Random(WARM_SEED)
    out = []
    kinds = [True] + ([False] if mix.get("greedy_share", 1.0) < 1.0 else [])
    for n in warm_lengths(mix):
        for greedy in kinds:
            ids = ([] if bos is None else [bos]) + \
                [rng.randrange(FIRST_ID, vocab) for _ in range(n - (bos is not None))]
            out.append(Request(len(out), 0.0, ids, new_tokens, greedy,
                               None if greedy else dict(mix["sampling"]), len(out)))
    return out
