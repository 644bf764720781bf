"""The traffic generator: deterministic per seed, the same work for every seed."""

import math
import statistics

from kbench import traffic
from kbench.stats import percentile

RAG = traffic.load_mix("rag-serve")
DOC = traffic.load_mix("doc-stream")


def _key(reqs):
    return [(r.due_s, r.token_ids, r.max_new_tokens, r.greedy, r.seed) for r in reqs]


def _size(r):
    return (len(r.token_ids), r.max_new_tokens, r.greedy)


def _gaps(reqs, seconds):
    """Between arrivals, from the window's start to the first and from the
    last to the window's end."""
    due = [0.0] + [r.due_s for r in reqs] + [seconds]
    return sorted(round(y - x, 9) for x, y in zip(due, due[1:]))


def test_same_seed_same_requests():
    a = traffic.open_loop(RAG, 2.5, 45, 32768, 1, 3141592653)
    b = traffic.open_loop(RAG, 2.5, 45, 32768, 1, 3141592653)
    assert _key(a) == _key(b)
    c = traffic.open_loop(RAG, 2.5, 45, 32768, 1, 3141592654)
    assert _key(a) != _key(c)


def test_every_seed_offers_the_same_work():
    one = dict(RAG, strata=1)
    a = traffic.open_loop(one, 2.5, 45, 32768, 1, 11)
    b = traffic.open_loop(one, 2.5, 45, 32768, 1, 2 ** 31 + 7)
    assert len(a) == len(b) == round(2.5 * 45)
    # the same requests: each prompt length keeps its output length and kind
    assert sorted(map(_size, a)) == sorted(map(_size, b))
    assert _gaps(a, 45) == _gaps(b, 45)
    # in another order: which request comes when, and the gaps' order
    assert list(map(_size, a)) != list(map(_size, b))
    assert [r.due_s for r in a] != [r.due_s for r in b]


def test_a_fresh_pool_draws_other_work():
    a = traffic.open_loop(RAG, 2.5, 45, 32768, 1, 11)
    b = traffic.open_loop(RAG, 2.5, 45, 32768, 1, 11, pool_seed=12)
    assert sorted(map(_size, a)) != sorted(map(_size, b))


def test_arrivals_are_poisson_in_the_window():
    """n arrivals in the window, their gaps drawn as exponentials at the rate
    (not quantiles): the mean gap is 1 / rate, their spread that of an
    exponential, and the seed's order clusters them."""
    rate, seconds = 4.0, 500
    reqs = traffic.open_loop(dict(RAG, strata=1), rate, seconds, 32768, 1, 5)
    due = [r.due_s for r in reqs]
    assert due == sorted(due) and 0 < due[0] and due[-1] < seconds
    assert len(reqs) == round(rate * seconds)
    g = _gaps(reqs, seconds)
    assert abs(statistics.mean(g) * rate - 1) < 0.01
    assert abs(statistics.stdev(g) / statistics.mean(g) - 1) < 0.1
    # the busiest 5 s of the window hold well over the mean count
    per = [sum(1 for d in due if k * 5 <= d < (k + 1) * 5) for k in range(seconds // 5)]
    assert max(per) > 1.3 * rate * 5


def test_lengths_follow_the_mix():
    reqs = traffic.open_loop(RAG, 4.0, 51, 32768, 1, 5)
    p = [len(r.token_ids) for r in reqs]
    o = [r.max_new_tokens for r in reqs]
    assert min(p) >= 384 and max(p) <= 6144 and min(o) >= 2 and max(o) <= 128
    assert abs(percentile(p, 50) / 1500 - 1) < 0.1 and abs(percentile(o, 50) / 13 - 1) < 0.2
    assert all(r.token_ids[0] == 1 and min(r.token_ids[1:]) >= traffic.FIRST_ID
               and max(r.token_ids) < 32768 for r in reqs)
    greedy = sum(r.greedy for r in reqs)
    assert abs(greedy - len(reqs) / 2) <= 1
    assert all(r.sampling is None for r in reqs if r.greedy)
    assert all(r.sampling["temperature"] == 0.7 for r in reqs if not r.greedy)


def test_length_distributions():
    import random
    rng = random.Random(1)
    ln = {"dist": "lognormal", "median": 100, "sigma": 0.5, "min": 1, "max": 10 ** 6}
    xs = [traffic.length(ln, rng) for _ in range(4000)]
    assert abs(statistics.median(xs) / 100 - 1) < 0.05
    uni = [traffic.length({"dist": "uniform", "min": 10, "max": 20}, rng) for _ in range(500)]
    assert min(uni) == 10 and max(uni) == 20
    assert traffic.length({"dist": "fixed", "value": 4}, rng) == 4


def test_closed_cycles():
    a = traffic.closed_cycle(DOC, 0, 32064, 1, 9)
    assert len(a) == DOC["cycle"]
    assert _key(a) == _key(traffic.closed_cycle(DOC, 0, 32064, 1, 9))
    b = traffic.closed_cycle(DOC, 1, 32064, 1, 9)
    assert sorted(len(r.token_ids) for r in a) == sorted(len(r.token_ids) for r in b)
    assert [len(r.token_ids) for r in a] != [len(r.token_ids) for r in b]
    assert all(r.max_new_tokens == 4 and r.greedy for r in a)
    assert all(1024 <= len(r.token_ids) <= 8000 for r in a)


def test_warm_up_meets_every_bucket():
    for mix, want in ((RAG, {512, 1024, 2048, 4096, 8192}), (DOC, {1024, 2048, 4096, 8192})):
        lens = traffic.warm_lengths(mix)
        assert {2 ** math.ceil(math.log2(n)) for n in lens} == want
    w = traffic.warm_requests(RAG, 32768, 1, 20)
    assert _key(w) == _key(traffic.warm_requests(RAG, 32768, 1, 20))
    assert {r.greedy for r in w} == {True, False}
    assert [len(r.token_ids) for r in w[::2]] == traffic.warm_lengths(RAG)


def test_strata_hold_equal_counts_and_work():
    """Each block of the window holds an equal count and near-equal work, and
    the same requests in every seed; within a block the seed orders them and
    the gaps, which stay exponential."""
    k, rate, seconds = RAG["strata"], 2.4, 51
    a = traffic.open_loop(RAG, rate, seconds, 32768, 1, 17)
    b = traffic.open_loop(RAG, rate, seconds, 32768, 1, 18)

    def blocks(rs):
        return [[r for r in rs if j * seconds / k <= r.due_s < (j + 1) * seconds / k]
                for j in range(k)]
    count = [len(x) for x in blocks(a)]
    assert sum(count) == len(a) and max(count) - min(count) <= 1
    work = [sum(len(r.token_ids) for r in x) for x in blocks(a)]
    assert max(work) / min(work) < 1.15
    assert [sorted(map(_size, x)) for x in blocks(a)] == [sorted(map(_size, x)) for x in blocks(b)]
    assert list(map(_size, a)) != list(map(_size, b))
    long = traffic.open_loop(RAG, 4.0, 600, 32768, 1, 5)
    g = _gaps(long, 600)
    assert abs(statistics.stdev(g) / statistics.mean(g) - 1) < 0.1
