"""A tiny benchmark for the CPU tests: a configuration, two mixes, two cells and
a dummy per-layer metric, added as files and entries only, in a scratch copy
of the harness's data folders (with its architecture modules and kernel
families, to which a test may add files of its own)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

KBENCH = Path(__file__).resolve().parents[1]

TINY = {"architectures": ["MistralForCausalLM"], "bos_token_id": 1, "eos_token_id": 2,
        "hidden_size": 256, "intermediate_size": 512, "max_position_embeddings": 4096,
        "model_type": "mistral", "num_attention_heads": 4, "num_hidden_layers": 2,
        "num_key_value_heads": 2, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
        "sliding_window": None, "tie_word_embeddings": False, "vocab_size": 512,
        "source": "a tiny stand-in for the CPU tests", "dtype": "f32", "quantize": "int4",
        "reduced": [], "assumed": []}
LIMIT = 1e-3     # f32 program against the f32 reference, both on the CPU
DUMMY_METRIC = '''"""dummy.requests: requests of the window (a test of the lookup by name)."""


def read(run):
    return float(len(run.window.served))
'''


def make(root: Path, model_type: str = "mistral",
         arch_files: tuple = ()) -> tuple[dict, Path]:
    """(the benchmark dict, the harness root) of the tiny benchmark;
    `arch_files` are further architecture modules, copied into its `arch/`."""
    k = Path(root) / "kbench"
    for d in ("cells", "traffic", "configs"):
        (k / d).mkdir(parents=True, exist_ok=True)
    for d in ("metrics", "arch", "roofline/kernels"):
        if not (k / d).exists():
            shutil.copytree(KBENCH / d, k / d, ignore=shutil.ignore_patterns("__pycache__"))
    for f in arch_files:
        shutil.copy(f, k / "arch" / Path(f).name)
    (k / "metrics" / "dummy.requests.py").write_text(DUMMY_METRIC)
    conf = dict(TINY, model_type=model_type)
    (k / "configs" / "tiny.json").write_text(json.dumps(conf))
    rag = json.loads((KBENCH / "traffic" / "rag-serve.json").read_text())
    rag["prompt_tokens"].update(median=40, min=10, max=200)
    rag["output_tokens"].update(median=10, min=4, max=24)
    rag["sampling"]["top_p"] = 0.3      # a nucleus that the tiny model's flat logits keep narrow
    (k / "traffic" / "tiny-rag.json").write_text(json.dumps(rag))
    doc = json.loads((KBENCH / "traffic" / "doc-stream.json").read_text())
    doc["prompt_tokens"].update(min=8, max=80)
    doc["cycle"] = 5
    (k / "traffic" / "tiny-doc.json").write_text(json.dumps(doc))
    check = {"max_logit_gap": LIMIT, "sample_tokens": 200, "sample_requests": 40,
             "min_scored": 8}
    cells = {"tiny.rag": {"config": "tiny", "traffic": "tiny-rag", "driver": "engine",
                          "chips": 1, "slots": 6, "steps_per_sync": 4, "max_context": 512,
                          "rate_per_s": 12.0, "warm_new_tokens": 4,
                          "check": dict(check, max_nucleus_excess=LIMIT)},
             "tiny.doc": {"config": "tiny", "traffic": "tiny-doc", "driver": "stream",
                          "chips": 1, "max_context": 512, "cycles_ready": 2,
                          "warm_new_tokens": 4, "check": dict(check, sample_tokens=20)}}
    for name, c in cells.items():
        (k / "cells" / f"{name}.json").write_text(json.dumps(c))
    bench = {
        "configs": [{"name": "tiny", "file": "kbench/configs/tiny.json"}],
        "workloads": [{"name": n, "config": "tiny", "traffic": c["traffic"], "chips": 1}
                      for n, c in cells.items()],
        "end_to_end": [{"name": "request_p90_ms", "unit": "ms", "workloads": ["tiny.rag"]},
                       {"name": "ttft_p90_ms", "unit": "ms", "workloads": ["tiny.doc"]},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "engine.window_ms.serve", "unit": "ms",
                       "moves": "request_p90_ms", "workloads": ["tiny.rag"]},
                      {"name": "engine.tokens_per_window.serve", "unit": "tokens",
                       "moves": "request_p90_ms", "workloads": ["tiny.rag"]},
                      {"name": "mfu.serve", "unit": "%", "moves": "request_p90_ms",
                       "workloads": ["tiny.rag"]},
                      {"name": "stream.ttft_p50_ms", "unit": "ms", "moves": "ttft_p90_ms",
                       "workloads": ["tiny.doc"]},
                      {"name": "dummy.requests", "unit": "requests", "moves": "ttft_p90_ms"}]}
    return bench, k
