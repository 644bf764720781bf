"""The yardstick's identity: bits and numbers pinned from the harness as it
stood when the llama family was its only architecture and its two kernel
families were written into `trace.py`. The weights of every kind, the
reference's logits (f32 and the fp8 control, with and without int4), useful
FLOPs and launch bounds must come out exactly as they did then
(`torch.equal` / `==`), now that each comes from an architecture module or a
kernel family found by name.

The logits are hashed as computed with one CPU thread: a matrix product's
rounding can follow the thread count.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from kbench import model, trace, weights
from kbench.reference import decoder
from kbench.roofline import costs
from kbench.tests import tiny

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
SEED = 2 ** 31 + 12345

KINDS = {
    "mistral": {
        "model.embed_tokens.weight":
            ((512, 256), "2826817ba3619555f8a728bb"),
        "model.norm.weight":
            ((256,), "3716bbdf8bfea32377ef12c1"),
        "model.layers.{}.input_layernorm.weight":
            ((2, 256), "66abdb22501e59ef611a7012"),
        "model.layers.{}.post_attention_layernorm.weight":
            ((2, 256), "4d4d8897a9d2db8a0a4e6bee"),
        "model.layers.{}.self_attn.o_proj.weight":
            ((2, 256, 256), "bcb902207e0b488f9edc15e0"),
        "model.layers.{}.mlp.down_proj.weight":
            ((2, 256, 512), "4d578d82572c7d4a2f69977e"),
        "lm_head.weight":
            ((512, 256), "18ce7e2a0b6ecf623bf1738d"),
        "model.layers.{}.self_attn.q_proj.weight":
            ((2, 256, 256), "1214ccbf52f811e6b750e9f1"),
        "model.layers.{}.self_attn.k_proj.weight":
            ((2, 128, 256), "2d6ee1e526ebe93c9b070c52"),
        "model.layers.{}.self_attn.v_proj.weight":
            ((2, 128, 256), "9e13bfb839d8fe5893381592"),
        "model.layers.{}.mlp.gate_proj.weight":
            ((2, 512, 256), "afddcd1d13c49c161de59286"),
        "model.layers.{}.mlp.up_proj.weight":
            ((2, 512, 256), "6a80fda11eda8f1f7a5968dc"),
    },
    "phi3": {
        "model.embed_tokens.weight":
            ((512, 128), "1d2ab5fa2183bb708deb09b1"),
        "model.norm.weight":
            ((128,), "992d2fabf8003e2b459e6a28"),
        "model.layers.{}.input_layernorm.weight":
            ((2, 128), "e31cc46cf183428e3ab3c338"),
        "model.layers.{}.post_attention_layernorm.weight":
            ((2, 128), "b9d8cd2e0debdb235855b6e9"),
        "model.layers.{}.self_attn.o_proj.weight":
            ((2, 128, 128), "2f5347b6f983d90b0ff75789"),
        "model.layers.{}.mlp.down_proj.weight":
            ((2, 128, 256), "f74e727ca1d310f0f0259258"),
        "lm_head.weight":
            ((512, 128), "bb5a157033401645407804a2"),
        "model.layers.{}.self_attn.qkv_proj.weight":
            ((2, 384, 128), "1aff946e2b49ed49e5eb204f"),
        "model.layers.{}.mlp.gate_up_proj.weight":
            ((2, 512, 128), "7dfc4c1f91a8db02e617b71a"),
    },
}
LOGITS = {
    ("mistral", "f32", None): ("ac57db282312b7de77afb570", "462514ffcd5b81586c14f14c"),
    ("mistral", "f32", "int4"): ("2757fd39c8d1e13bf6e665f5", "dfd96220698adc9c1872ecb1"),
    ("mistral", "fp8", None): ("e3ad7aee5f8eb81f299cdf4c", "f25a9693bbdc68a7326216d1"),
    ("mistral", "fp8", "int4"): ("e8093c61fdbbc47cd55aa089", "714c6e15f984a29ae608a7fc"),
    ("phi3", "f32", None): ("942fbf79459dbfd14fec1806", "fd325241f70378a23d6a0297"),
    ("phi3", "f32", "int4"): ("261a3ead76398e16b0f8196e", "2a362c232d3d7850a1901019"),
    ("phi3", "fp8", None): ("2bbd2941b9496471e18de0b5", "613e5e773e63f11273f60946"),
    ("phi3", "fp8", "int4"): ("62d508e23143c9008b4c3a60", "173e43407ba5636de85f5374"),
}
FLOPS = {
    ("mistral7b", 1, 1): 14227603456.0,
    ("mistral7b", 5, 3): 98530492416.0,
    ("mistral7b", 1500, 13): 21708654247936.0,
    ("mistral7b", 6144, 128): 97879586766848.0,
    ("phi35", 1, 1): 7445151744.0,
    ("phi35", 5, 3): 51336314880.0,
    ("phi35", 1500, 13): 11410941542400.0,
    ("phi35", 6144, 128): 53208831492096.0,
    ("tiny", 1, 1): 2623488.0,
    ("tiny", 5, 3): 17358848.0,
    ("tiny", 1500, 13): 5913223168.0,
    ("tiny", 6144, 128): 55104372736.0,
}
LAYOUTS = {
    "mistral-7b-instruct-v0.3.int4.json": "1d5005bae3c0e32ab1e679f2",
    "phi-3.5-mini-instruct.bf16.json": "bd49af731146973f63c1e0a0",
}
BOUNDS = [
    (("int4", 1024, 4096, 14336, 32, 2, 2), 0.00012159664740950455),
    (("int4", 1, 4096, 6144, 32, 4, 4), 4.003075820895522e-06),
    (("flash", 2, 32, 8, 1024, 1024, 128, True, None, 0, 1024), 1.73879134479272e-05),
    (("flash", 1, 32, 8, 512, 8192, 128, True, 4096, 700, 1212), 8.112945957532862e-06),
]


def _phi3() -> dict:
    """A tiny Phi-3 with LongRoPE: short factors up to 256 tokens, long past."""
    u = np.sort(np.random.default_rng(35).uniform(0.0, 1.0, (2, 16)), axis=1)
    return {"architectures": ["Phi3ForCausalLM"], "bos_token_id": 1, "eos_token_id": 2,
            "pad_token_id": 0, "hidden_size": 128, "intermediate_size": 256,
            "max_position_embeddings": 8192, "original_max_position_embeddings": 256,
            "model_type": "phi3", "num_attention_heads": 4, "num_hidden_layers": 2,
            "num_key_value_heads": 4, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
            "sliding_window": 262144, "tie_word_embeddings": False, "vocab_size": 512,
            "rope_scaling": {"type": "longrope",
                             "short_factor": [1.0 + float(x) ** 4 for x in u[0]],
                             "long_factor": [1.0 + 59.0 * float(x) for x in u[1]]}}


TINY = {"mistral": model.hf_config(tiny.TINY), "phi3": _phi3()}
LENGTHS = {"mistral": [40, 90], "phi3": [100, 300]}


def _sha(t: torch.Tensor) -> str:
    t = t.contiguous()
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:24]


def _conf(name: str) -> dict:
    return model.hf_config(json.loads((CONFIGS / name).read_text()))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(KINDS))
def test_every_kind_draws_the_same_bits(name):
    cfg = TINY[name]
    assert list(weights.kinds(cfg)) == list(KINDS[name])      # the draw order too
    for pattern, (shape, sha) in KINDS[name].items():
        t = weights.draw(cfg, SEED, pattern, "cpu")
        assert (tuple(t.shape), _sha(t)) == (shape, sha), pattern


@pytest.mark.parametrize("key", sorted(LOGITS, key=str), ids=lambda k: "-".join(map(str, k)))
def test_reference_logits_are_the_same_bits(key, one_thread):
    name, precision, quant = key
    rng = np.random.default_rng(3)
    seqs = [[1] + [int(i) for i in rng.integers(3, 512, n - 1)] for n in LENGTHS[name]]
    rows = [list(range(n - 6, n)) for n in LENGTHS[name]]
    out = decoder.logits_at(TINY[name], SEED, seqs, rows, "cpu", quant=quant,
                            precision=precision)
    assert tuple(_sha(r) for r in out) == LOGITS[key]


@pytest.mark.parametrize("conf", sorted(LAYOUTS))
def test_published_layouts_are_the_same(conf):
    kinds = weights.kinds(_conf(conf))
    assert all(k.layers is None and k.experts is None for k in kinds.values())
    flat = json.dumps([[p, list(k.shape), k.is_norm] for p, k in kinds.items()])
    assert hashlib.sha256(flat.encode()).hexdigest()[:24] == LAYOUTS[conf]


def test_useful_flops_are_the_same():
    cfgs = {"mistral7b": _conf("mistral-7b-instruct-v0.3.int4.json"),
            "phi35": _conf("phi-3.5-mini-instruct.bf16.json"), "tiny": TINY["mistral"]}
    for (name, prompt, new), want in FLOPS.items():
        assert costs.useful_flops(cfgs[name], prompt, new) == want, (name, prompt, new)


@pytest.mark.parametrize("rec,want", BOUNDS, ids=lambda v: str(v[0]) if isinstance(v, tuple) else "")
def test_launch_bounds_are_the_same(rec, want):
    assert trace.launch_bound_s(rec) == want
