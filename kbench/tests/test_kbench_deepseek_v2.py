"""DeepSeek-V2 in the harness on the CPU: the architecture file found by
`model_type` in a scratch root, its layout's draws, its useful FLOPs counted
by hand, the `moe` kernel family's bound of a launch with an empty expert,
and a tiny DeepSeek-V2 cell through the engine, sound under a tight limit
that its fp8 control fails."""

import json
import time
from pathlib import Path

import pytest
import torch

from kbench import lookup, run, weights
from kbench.roofline import costs
from kbench.roofline.peaks import BF16_FLOP_PER_S, HBM_BYTES_PER_S
from kbench.tests import tiny

ARCH_FILE = Path(__file__).resolve().parents[1] / "arch" / "deepseek_v2.py"
DS = {"model_type": "deepseek_v2", "vocab_size": 512, "hidden_size": 64,
      "intermediate_size": 96, "moe_intermediate_size": 32, "num_hidden_layers": 3,
      "num_attention_heads": 4, "num_key_value_heads": 4, "n_routed_experts": 8,
      "n_shared_experts": 1, "num_experts_per_tok": 2, "first_k_dense_replace": 1,
      "moe_layer_freq": 1, "kv_lora_rank": 32, "q_lora_rank": None, "qk_nope_head_dim": 16,
      "qk_rope_head_dim": 16, "v_head_dim": 16, "norm_topk_prob": False,
      "routed_scaling_factor": 1.0, "scoring_func": "softmax", "topk_method": "greedy",
      "hidden_act": "silu", "max_position_embeddings": 163840, "rms_norm_eps": 1e-6,
      "rope_theta": 10000,
      "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                       "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                       "mscale_all_dim": 0.707},
      "attention_bias": False, "tie_word_embeddings": False, "bos_token_id": 1,
      "eos_token_id": 2}
SEED = 2 ** 31 + 4242
CELL = "tiny-ds.rag"
EXPERT = "model.layers.{}.mlp.experts.{}.gate_proj.weight"


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The tiny benchmark with a DeepSeek-V2 configuration and an engine cell
    added as files and entries."""
    b, k = tiny.make(tmp_path_factory.mktemp("kb"), arch_files=(ARCH_FILE,))
    conf = dict(DS, source="a tiny stand-in", dtype="f32", reduced=[], assumed=[])
    (k / "configs" / "tiny-ds.json").write_text(json.dumps(conf))
    cell = json.loads((k / "cells" / "tiny.rag.json").read_text())
    (k / "cells" / f"{CELL}.json").write_text(json.dumps(dict(cell, config="tiny-ds")))
    b["configs"].append({"name": "tiny-ds", "file": "kbench/configs/tiny-ds.json"})
    b["workloads"].append({"name": CELL, "config": "tiny-ds", "traffic": "tiny-rag",
                           "chips": 1})
    b["end_to_end"][0]["workloads"].append(CELL)
    b["per_layer"].append({"name": "moe.rows_per_expert.serve", "unit": "rows",
                           "moves": "request_p90_ms", "workloads": [CELL]})
    return b, k


def _run(bench, seed, trace=False, control=False):
    b, k = bench
    return run.execute(b, CELL, seed, 2.0, trace, device="cpu", kroot=k, control=control,
                       t_start=time.perf_counter())


def test_found_by_model_type(bench):
    assert lookup.architecture(DS, bench[1]).MODEL_TYPES == ("deepseek_v2",)
    assert lookup.architecture(DS).MODEL_TYPES == ("deepseek_v2",)


def test_the_layout_draws_dense_layer_zero_and_expert_stacks(bench):
    kroot = bench[1]
    kinds = weights.kinds(DS, kroot)
    assert kinds[EXPERT] == weights.Kind((32, 64), False, (1, 3), 8)
    assert kinds["model.layers.{}.mlp.gate_proj.weight"] == weights.Kind((96, 64), False, (0, 1))
    assert kinds["model.layers.{}.mlp.shared_experts.down_proj.weight"] == \
        weights.Kind((64, 32), False, (1, 3))
    assert kinds["model.layers.{}.self_attn.kv_b_proj.weight"].shape == (4 * 32, 32)
    stack = weights.draw(DS, SEED, EXPERT, "cpu", kroot=kroot)
    g = torch.Generator().manual_seed(weights.kind_seed(SEED, EXPERT))
    want = torch.randn((2, 8, 32, 64), generator=g, dtype=torch.bfloat16) * weights.PROJ_STD
    assert torch.equal(stack, want)            # [layers, experts, *shape], one call
    sw = weights.SeededWeights(DS, SEED, "cpu", kroot)
    assert torch.equal(sw.get(EXPERT.format(2, 7)), stack[1, 7])
    assert EXPERT.format(0, 0) not in sw and "model.layers.1.mlp.gate_proj.weight" not in sw
    assert weights.draw(DS, SEED, "model.layers.{}.mlp.gate.weight", "cpu",
                        kroot=kroot).shape == (2, 8, 64)


@pytest.mark.parametrize("prompt,new", [(1, 1), (10, 1), (7, 4)])
def test_useful_flops_by_hand(bench, prompt, new):
    """Per token: q 64 x 4 x 32, kv_a 64 x 48, kv_b 32 x 4 x 32, o 64 x 64;
    layer 0's SwiGLU 3 x 64 x 96; layers 1-2: the router 64 x 8, two experts
    and the shared one, 3 x 3 x 64 x 32; per (query, key) pair and layer
    4 x (32 + 16); the head 64 x 512 where a token is sampled."""
    attn = 64 * 128 + 64 * 48 + 32 * 128 + 64 * 64
    per_token = 3 * attn + 3 * 64 * 96 + 2 * (64 * 8 + 3 * 3 * 64 * 32)
    pair, head = 2 * 3 * 4 * 48, 64 * 512
    want = 2 * per_token * prompt + pair * prompt * (prompt + 1) / 2 + 2 * head
    for j in range(1, new):
        want += 2 * (per_token + head) + pair * (prompt + j)
    assert costs.useful_flops(DS, prompt, new, kroot=bench[1]) == want


def test_moe_bound_counts_only_the_experts_that_received_rows(bench):
    moe = lookup.kernel_families(bench[1])["moe"]
    x = torch.zeros(10, 64, dtype=torch.bfloat16)
    w = torch.zeros(4, 64, 96, dtype=torch.bfloat16)
    offs = torch.tensor([3, 3, 10, 10], dtype=torch.int32)   # experts 1 and 3 empty
    rec = moe.record((x, w, offs), {})
    assert rec[:5] == (10, 64, 96, 4, 2) and rec[5] is offs
    nbytes = 2 * (2 * 64 * 96 + 10 * 64 + 10 * 96)
    assert moe.bound_s(rec) == max(2 * 10 * 64 * 96 / BF16_FLOP_PER_S,
                                   nbytes / HBM_BYTES_PER_S)
    big = (4096, 2048, 2816, 64, 2, torch.full((64,), 4096, dtype=torch.int32))
    assert moe.bound_s(big) == 2 * 4096 * 2048 * 2816 / BF16_FLOP_PER_S   # compute-bound
    assert moe.record((x.float(), w.float(), offs), {}) is None           # f32: not the kernel


def test_a_tiny_cell_is_sound_and_its_fp8_control_is_refused(bench):
    """The engine serving the tiny DeepSeek-V2 from the seed, judged by the
    reference under the tiny cells' limit (1e-3, f32 against f32); the
    reference one precision down in its place reads above it."""
    reads = [_run(bench, s, control=True) for s in (11, 2 ** 33 + 5)]
    for out in reads:
        res, r = out["result"], out["readings"]
        assert res["correct"] is True and res["failed"] == 0
        assert r["max_logit_gap"] <= tiny.LIMIT and r["nucleus_excess"] <= tiny.LIMIT
        assert r["control_gap"] > tiny.LIMIT and not r["control_correct"]


def test_traced_run_reads_rows_per_expert(bench):
    res = _run(bench, 12345, trace=True)["result"]
    rows = res["metrics"]["moe.rows_per_expert.serve"]["value"]
    # 6 slots at top-2 over 8 experts in decode, more rows in admission waves
    assert rows >= 6 * 2 / 8
