"""The whole harness on the CPU at a tiny size: cells found by name, the result
line, planted faults that must turn `correct` false, the control, and the
refusals."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from kbench import run
from kbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("kb"))


def _run(bench, workload, seed=987654321012, trace=False, control=False):
    b, k = bench
    return run.execute(b, workload, seed, 2.0, trace, device="cpu", kroot=k,
                       control=control, t_start=time.perf_counter())


@pytest.mark.parametrize("workload", ["tiny.rag", "tiny.doc"])
def test_a_new_cell_is_files_and_entries(bench, workload):
    out = _run(bench, workload)
    res = out["result"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 3
    want = {"tiny.rag": {"request_p90_ms", "setup_s"}, "tiny.doc": {"ttft_p90_ms", "setup_s"}}
    assert set(res["metrics"]) == want[workload]
    assert list(res)[-1] == "checks"
    assert res["checks"]["max_logit_gap"]["value"] <= tiny.LIMIT
    assert json.loads(json.dumps(res)) == res


def test_traced_run_reports_per_layer_metrics(bench):
    res = _run(bench, "tiny.rag", trace=True)["result"]
    # the dummy metric lists no cells and moves ttft_p90_ms: not this cell's
    assert set(res["metrics"]) == {"engine.window_ms.serve",
                                   "engine.tokens_per_window.serve", "mfu.serve"}
    assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res
    doc = _run(bench, "tiny.doc", trace=True)["result"]
    assert set(doc["metrics"]) == {"stream.ttft_p50_ms", "dummy.requests"}


def _fault_token(monkeypatch, workload):
    """A token altered where it is produced."""
    if workload == "tiny.rag":
        from kjarni_tpu_torch.generate.continuous import ContinuousEngine
        orig = ContinuousEngine._window

        def window(self, k, plain, kb, pos):
            out = orig(self, k, plain, kb, pos)
            for row, s in enumerate(self._slots):
                if s.active and not s.sampled:
                    out[row][-1] = (out[row][-1] + 1) % self.cfg.vocab_size
            return out
        monkeypatch.setattr(ContinuousEngine, "_window", window)
    else:
        from kjarni_tpu_torch.models.decoder_lm import DecoderLM
        orig = DecoderLM._decode

        def decode(self, *a, **kw):
            for i, t in enumerate(orig(self, *a, **kw)):
                yield (t + 1) % self.config.vocab_size if i == 1 else t
        monkeypatch.setattr(DecoderLM, "_decode", decode)


def _fault_state(monkeypatch, workload):
    """A decode step that leaves its state unchanged: K/V never written."""
    from kjarni_tpu_torch.models import llama
    orig = llama._cache_write

    def write(cache, new, pos_start):
        if new.shape[2] != 1:
            orig(cache, new, pos_start)
    monkeypatch.setattr(llama, "_cache_write", write)


def _fault_half_batch(monkeypatch, workload):
    """Half of the batch left out: in each batched decode step the first
    half of the slots (those admission fills first) gets the second half's
    logits."""
    from kjarni_tpu_torch.models import llama
    orig = llama.forward

    def forward(*a, **kw):
        logits, ck, cv = orig(*a, **kw)
        if torch.is_tensor(a[5]) and logits.shape[0] > 1:
            h = logits.shape[0] // 2
            logits = torch.cat([logits[h:2 * h], logits[h:]])
        return logits, ck, cv
    monkeypatch.setattr(llama, "forward", forward)


def _fault_no_top_p(monkeypatch, workload):
    """A sampler that skips top-p: sampled slots draw from every token."""
    from kjarni_tpu_torch.generate import continuous
    monkeypatch.setattr(continuous, "top_p_filter", lambda logits, p: logits)


def _fault_other_row(monkeypatch, workload):
    """A sampler that draws each sampled slot's token from another sampled
    slot's row."""
    from kjarni_tpu_torch.generate import continuous
    orig = continuous._sample_slot

    def sample(logits, generators, rows, *a):
        if len(rows) > 1:
            idx = torch.tensor(rows, device=logits.device)
            logits = logits.clone()
            logits[idx] = logits[idx.roll(1)]
        return orig(logits, generators, rows, *a)
    monkeypatch.setattr(continuous, "_sample_slot", sample)


FAULTS = [("tiny.rag", _fault_token, "max_logit_gap"),
          ("tiny.rag", _fault_state, "max_logit_gap"),
          ("tiny.rag", _fault_half_batch, "max_logit_gap"),
          ("tiny.rag", _fault_no_top_p, "nucleus_excess"),
          ("tiny.rag", _fault_other_row, "nucleus_excess"),
          ("tiny.doc", _fault_token, "max_logit_gap"),
          ("tiny.doc", _fault_state, "max_logit_gap")]


@pytest.mark.parametrize("workload,fault,number", FAULTS,
                         ids=[f"{w}-{f.__name__[7:]}" for w, f, _ in FAULTS])
def test_planted_fault_fails_the_run(bench, monkeypatch, workload, fault, number):
    fault(monkeypatch, workload)
    res = _run(bench, workload)["result"]
    assert res["correct"] is False
    assert res["checks"][number]["value"] > tiny.LIMIT


def test_control_fails_the_limit(bench):
    """The reference one precision down in the program's place (fp8 inputs
    and weights for this f32 stand-in's linear layers) reads a gap above the
    limit that the program keeps."""
    reads = [_run(bench, "tiny.rag", seed=s, control=True)["readings"] for s in (1, 2, 3)]
    assert all(r["max_logit_gap"] <= tiny.LIMIT for r in reads)
    assert all(r["nucleus_excess"] <= tiny.LIMIT for r in reads)
    assert min(r["control_gap"] for r in reads) > tiny.LIMIT
    assert not any(r["control_correct"] for r in reads)
    # the sampler's faults, read from the reference's rows, fail the limit
    assert not any(any(r["faults_correct"].values()) for r in reads)


def test_forbidden_modules_compare_whole_names():
    assert run.forbidden_modules(["kjarni_tpu_torch", "kjarni_tpu_torch.models"]) == []
    assert run.forbidden_modules(["jax.numpy", "kjarni_tpu.ops", "flaxen"]) == \
        ["jax", "kjarni_tpu"]


def test_a_run_loads_no_jax(bench, tmp_path):
    """A whole run in a fresh process leaves no JAX module loaded."""
    b, k = bench
    code = ("import json, sys, time; from pathlib import Path; from kbench import run; "
            f"run.execute(json.loads({json.dumps(json.dumps(b))}), 'tiny.rag', 5, 1.0, False, "
            f"device='cpu', kroot=Path({str(k)!r}), t_start=time.perf_counter()); "
            "print(run.forbidden_modules())")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "mistral-7b-int4.rag-serve", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and kbench/, no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "kbench", tmp_path / "kbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cmd = json.loads((REPO / "BENCHMARK.json").read_text())["command"]
    out = subprocess.run([sys.executable, *cmd[1:], "--workload", "mistral-7b-int4.rag-serve",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""
