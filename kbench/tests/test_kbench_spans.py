"""The readers of the program's spans (kbench/spans.py and their metrics) on
a traced run of the tiny benchmark on the CPU: the five that need no card
read finite values, the three of CUDA-event time read nothing, and the stream's
pad share is the bucket arithmetic of the prompts it prefilled."""

import math
import time

import pytest

from kbench import run, spans
from kbench.tests import tiny

HOST = {"tiny.rag": ("engine.first_token_ms.serve", "engine.pad_share.serve",
                     "engine.slot_occupancy.serve"),
        "tiny.doc": ("stream.first_token_host_ms.stream", "stream.pad_share.stream")}
DEVICE = {"tiny.rag": ("engine.admit_ms.serve", "engine.decode_step_ms.serve"),
          "tiny.doc": ("stream.prefill_device_ms.stream",)}
SEED = 2_718_281_828_459


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    b, k = tiny.make(tmp_path_factory.mktemp("kb_spans"))
    moves = {"tiny.rag": "request_p90_ms", "tiny.doc": "ttft_p90_ms"}
    b["per_layer"] = [{"name": name, "unit": "x", "moves": moves[cell], "workloads": [cell]}
                      for cell in HOST for name in HOST[cell] + DEVICE[cell]]
    return b, k


@pytest.fixture(autouse=True)
def _jax_loaded_by_other_tests(monkeypatch):
    """A run refuses when it finds JAX loaded; in one pytest process another
    test file may have loaded it first. Modules loaded before this test are
    not the run's."""
    before, orig = set(run.forbidden_modules()), run.forbidden_modules
    monkeypatch.setattr(run, "forbidden_modules",
                        lambda modules=None: [m for m in orig(modules) if m not in before])


def _traced(bench, workload):
    b, k = bench
    return run.execute(b, workload, SEED, 2.0, True, device="cpu", kroot=k,
                       t_start=time.perf_counter())


@pytest.mark.parametrize("workload", ["tiny.rag", "tiny.doc"])
def test_span_readers_on_the_cpu(bench, workload):
    out = _traced(bench, workload)
    metrics = out["result"]["metrics"]
    assert out["result"]["correct"] is True
    assert set(metrics) == set(HOST[workload])
    assert all(math.isfinite(m["value"]) for m in metrics.values())
    assert set(out["missing"]) == set(DEVICE[workload])
    for name in ("engine.pad_share.serve", "engine.slot_occupancy.serve",
                 "stream.pad_share.stream"):
        if name in metrics:
            assert 0.0 <= metrics[name]["value"] < 100.0
    if workload == "tiny.doc":
        assert metrics["stream.first_token_host_ms.stream"]["value"] > 0.0


def test_stream_pad_share_is_the_bucket_arithmetic(bench):
    from kjarni_tpu_torch.core.bucketing import seq_bucket
    out = _traced(bench, "tiny.doc")
    prefills = spans.named("kjarni.stream.prefill")
    lengths = [s.counts["prompt_tokens"] for s in prefills]
    sent = [len(s.request.token_ids) for s in out["window"].served]
    at = next(i for i in range(len(sent)) if sent[i:i + len(lengths)] == lengths)
    assert lengths and at >= 0
    buckets = [seq_bucket(n, 512) for n in lengths]
    assert [s.counts["bucket"] for s in prefills] == buckets
    want = 100.0 * (1.0 - sum(lengths) / sum(buckets))
    assert out["result"]["metrics"]["stream.pad_share.stream"]["value"] == pytest.approx(want)


def test_readers_report_nothing_without_program_spans(monkeypatch):
    """A program whose profiling module has no spans() (the benchmark's
    parent) gives empty lists, and the readers None."""
    from kjarni_tpu_torch.core import profiling
    monkeypatch.delattr(profiling, "spans")
    assert spans.named("kjarni.engine.admit_wave") == []
    assert spans.pad_share([]) is None and spans.mean_device_ms([]) is None
