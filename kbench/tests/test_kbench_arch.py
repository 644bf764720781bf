"""Architectures found by `model_type`, from files: a toy mixture-of-experts
added to a scratch harness root as one file (`toy_moe.py`, with a leading
dense layer, then experts and a router), its layout drawn and served by the
seam, its reference judging a window, its FLOPs counted; and the lookup's
refusals."""

import shutil
from pathlib import Path

import pytest
import torch

from kbench import check, lookup, weights
from kbench.drivers.common import Served, Window
from kbench.reference import decoder
from kbench.roofline import costs
from kbench.tests import tiny
from kbench.traffic import Request

TOY_FILE = Path(__file__).resolve().parent / "toy_moe.py"
TOY = {"model_type": "toy_moe", "hidden_size": 64, "intermediate_size": 96,
       "num_hidden_layers": 3, "n_routed_experts": 4, "num_experts_per_tok": 2,
       "vocab_size": 128, "rms_norm_eps": 1e-6}
SEED = 2 ** 31 + 77
EXPERT = "model.layers.{}.mlp.experts.{}.down_proj.weight"


@pytest.fixture(scope="module")
def kroot(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("kb"), arch_files=(TOY_FILE,))[1]


def test_found_by_model_type(kroot):
    assert lookup.architecture(TOY, kroot).MODEL_TYPES == ("toy_moe",)
    assert "mistral" in lookup.architecture(tiny.TINY, kroot).MODEL_TYPES
    with pytest.raises(ValueError, match="no architecture module"):
        lookup.architecture(TOY)          # the harness's own root has no toy


def test_unclaimed_and_doubly_claimed_model_types_raise(kroot, tmp_path):
    with pytest.raises(ValueError, match=str(kroot / "arch")):
        lookup.architecture(dict(TOY, model_type="gpt_neox"), kroot)
    shutil.copytree(kroot / "arch", tmp_path / "arch")
    shutil.copy(TOY_FILE, tmp_path / "arch" / "toy_moe_again.py")
    with pytest.raises(ValueError, match="claimed by several"):
        lookup.architecture(TOY, tmp_path)


def test_layer_ranges_and_experts_are_drawn_as_one_stack(kroot):
    kinds = weights.kinds(TOY, kroot)
    assert kinds[EXPERT] == weights.Kind((64, 96), False, (1, 3), 4)
    assert kinds["model.layers.{}.mlp.down_proj.weight"].layers == (0, 1)
    stack = weights.draw(TOY, SEED, EXPERT, "cpu", kroot=kroot)
    g = torch.Generator().manual_seed(weights.kind_seed(SEED, EXPERT))
    want = torch.randn((2, 4, 64, 96), generator=g, dtype=torch.bfloat16) * weights.PROJ_STD
    assert torch.equal(stack, want)       # one generator call: [layers, experts, *shape]
    dense = weights.draw(TOY, SEED, "model.layers.{}.mlp.down_proj.weight", "cpu", kroot=kroot)
    assert dense.shape == (1, 64, 96)


def test_the_seam_serves_the_layout(kroot):
    sw = weights.SeededWeights(TOY, SEED, "cpu", kroot)
    assert EXPERT.format(1, 0) in sw and EXPERT.format(2, 3) in sw
    assert EXPERT.format(0, 0) not in sw          # layer 0 is dense
    assert EXPERT.format(1, 4) not in sw and EXPERT.format(3, 0) not in sw
    assert "model.layers.0.mlp.down_proj.weight" in sw
    assert "model.layers.1.mlp.down_proj.weight" not in sw
    assert "model.layers.0.mlp.gate.weight" not in sw
    assert sw.has_any("model.layers.0.mlp.gate.weight", "model.layers.2.mlp.gate.weight")
    stack = weights.draw(TOY, SEED, EXPERT, "cpu", kroot=kroot)
    assert torch.equal(sw.get(EXPERT.format(2, 3)), stack[1, 3])
    assert torch.equal(sw.get(EXPERT.format(1, 0)), stack[0, 0])
    assert sw.draws == 1                          # the kind drawn once
    with pytest.raises(KeyError):
        sw.get(EXPERT.format(0, 1))
    with pytest.raises(ValueError, match="indices"):   # a kind its pattern cannot hold
        weights.stack_shape(TOY, EXPERT, weights.Kind((4,), False))


def test_reference_and_flops_are_the_toys(kroot):
    seqs, rows = [[3, 5, 7, 9], [11, 13]], [[1, 3], [0]]
    via = decoder.logits_at(TOY, SEED, seqs, rows, "cpu", kroot=kroot)
    direct = lookup.architecture(TOY, kroot).logits_at(
        TOY, SEED, seqs, rows, torch.device("cpu"), quant=None, precision="f32")
    assert [r.shape for r in via] == [(2, 128), (1, 128)]
    assert all(torch.equal(a, b) for a, b in zip(via, direct))
    low = decoder.logits_at(TOY, SEED, seqs, rows, "cpu", precision="fp8", kroot=kroot)
    assert 0 < float((low[0] - via[0]).abs().max()) < 0.1 * float(via[0].abs().max())
    hid, inter, V = 64, 96, 128
    per_token = 3 * hid * inter + 2 * (4 * hid + 2 * 3 * hid * inter)
    assert costs.useful_flops(TOY, 10, 3, kroot=kroot) == 2 * (12 * per_token + 3 * hid * V)


def _served(kroot, index, prompt, n, altered=False):
    """A greedy request served by the toy reference itself, its last token
    turned into the one the reference ranks last where `altered`."""
    seq, tokens = list(prompt), []
    for _ in range(n):
        row = decoder.logits_at(TOY, SEED, [seq], [[len(seq) - 1]], "cpu", kroot=kroot)[0][0]
        tokens.append(int(row.argmax()))
        seq.append(tokens[-1])
    if altered:
        tokens[-1] = int(row.argmin())
    req = Request(index, -1.0, list(prompt), n, True, None, index)
    return Served(req, 0.0, first_s=0.1, done_s=0.5, tokens=tokens)


def test_judge_uses_the_toy_reference(kroot):
    limits = {"max_logit_gap": 1e-3, "sample_tokens": 100, "sample_requests": 10,
              "min_scored": 4}
    prompts = [[1, 4, 9], [1, 16, 25, 36], [1, 49]]
    sound = Window([_served(kroot, i, p, 3) for i, p in enumerate(prompts)], 1.0, 0.5, {}, [])
    ok, checks, _ = check.judge(sound, TOY, SEED, limits, "cpu", None, kroot=kroot)
    assert ok and checks["max_logit_gap"]["value"] <= 1e-5
    served = [_served(kroot, i, p, 3, altered=(i == 1)) for i, p in enumerate(prompts)]
    ok, checks, _ = check.judge(Window(served, 1.0, 0.5, {}, []), TOY, SEED, limits, "cpu",
                                None, kroot=kroot)
    assert not ok and checks["max_logit_gap"]["value"] > limits["max_logit_gap"]
    with pytest.raises(ValueError, match="toy_moe"):   # no toy in the harness's own root
        check.judge(sound, TOY, SEED, limits, "cpu", None)
