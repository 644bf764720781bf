"""The plain reference against transformers' published model code and against
the port, at tiny sizes on the CPU."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from kbench import weights
from kbench.reference import decoder

KBENCH = Path(__file__).resolve().parents[1]
TINY = {"bos_token_id": 1, "eos_token_id": 2, "pad_token_id": 0, "hidden_size": 128,
        "intermediate_size": 256, "max_position_embeddings": 8192,
        "num_attention_heads": 4, "num_hidden_layers": 2, "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0, "tie_word_embeddings": False, "vocab_size": 512}


def _phi3(orig=256):
    u = np.sort(np.random.default_rng(35).uniform(0.0, 1.0, (2, 16)), axis=1)
    return dict(TINY, model_type="phi3", architectures=["Phi3ForCausalLM"],
                num_key_value_heads=4, original_max_position_embeddings=orig,
                sliding_window=262144,
                rope_scaling={"type": "longrope",
                              "short_factor": [1.0 + float(x) ** 4 for x in u[0]],
                              "long_factor": [1.0 + 59.0 * float(x) for x in u[1]]})


def _mistral():
    return dict(TINY, model_type="mistral", architectures=["MistralForCausalLM"],
                num_key_value_heads=2, sliding_window=None)


def _ids(n, seed=1):
    return [1] + [int(i) for i in np.random.default_rng(seed).integers(3, 512, n - 1)]


def _hf_logits(hf, seed, ids):
    transformers = pytest.importorskip("transformers")
    kind = {"phi3": "Phi3", "mistral": "Mistral"}[hf["model_type"]]
    cfg = getattr(transformers, f"{kind}Config")(
        **{k: v for k, v in hf.items() if k != "architectures"})
    m = getattr(transformers, f"{kind}ForCausalLM")(cfg).eval()
    sd = {}
    for pat in weights.kinds(hf):
        t = weights.draw(hf, seed, pat, "cpu").float()
        if "{}" in pat:
            sd.update({pat.format(i): t[i] for i in range(hf["num_hidden_layers"])})
        else:
            sd[pat] = t
    assert not m.load_state_dict(sd, strict=False).missing_keys
    with torch.no_grad():
        return m(torch.tensor([ids])).logits[0]


@pytest.mark.parametrize("hf,n", [(_mistral(), 90), (_phi3(), 100), (_phi3(), 300)],
                         ids=["mistral", "phi3-short-factors", "phi3-long-factors"])
def test_reference_is_the_published_model(hf, n):
    """transformers' modeling code on the same weights: Mistral, and Phi-3's
    LongRoPE on both of its factor lists."""
    ids = _ids(n)
    ref = decoder.logits_at(hf, 7, [ids], [list(range(n))], "cpu")[0]
    assert float((ref - _hf_logits(hf, 7, ids)).abs().max()) < 1e-4


def test_reference_agrees_with_the_port_on_mistral():
    """The port's f32 forward on the CPU (its plain paths) against the
    reference, int4 quantized by both sides' own code."""
    from kbench import model
    hf = dict(_mistral(), hidden_size=256, intermediate_size=512)
    conf = dict(hf, dtype="f32", quantize="int4")
    lm = model.build(conf, 11, 512, "cpu", Path(__import__("tempfile").mkdtemp()) / "m")
    from kjarni_tpu_torch.models import llama
    ids = _ids(200, 4)
    ck, cv = llama.init_cache(lm.config, 1, 512, torch.float32, "cpu")
    port = llama.forward_all_logits(lm.params, lm.config, torch.tensor([ids]), ck, cv, 0)[0][0]
    ref = decoder.logits_at(hf, 11, [ids], [list(range(200))], "cpu", quant="int4")[0]
    assert float((port - ref).abs().max()) < 1e-4 * float(ref.abs().max())


def test_int4_scheme_matches_the_stated_one():
    w = torch.randn(48, 512, generator=torch.Generator().manual_seed(0))   # [N, K]
    deq = decoder.int4_dequant(w)                                         # [K, N]
    wt = w.t()
    for g in range(4):       # groups of 128 rows of K
        blk = wt[g * 128:(g + 1) * 128]
        scale = blk.abs().amax(dim=0) / 7.0
        q = torch.clamp(torch.round(blk / scale), -8, 7)
        assert torch.equal(deq[g * 128:(g + 1) * 128], q * scale)


def test_control_is_one_precision_down():
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(1))
    y = decoder.fp8_rows(x)
    rel = ((y - x).abs() / x.abs().clamp_min(1e-3)).max()
    assert 0.005 < float(rel) <= 0.0625 + 1e-6          # e4m3: 3 mantissa bits


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_the_yardstick_imports_nothing_of_the_program():
    """The reference, the architecture modules, the weights they draw, the
    cost functions and the kernel families import neither JAX, the JAX
    package nor the port (a family names its entry function as a string)."""
    files = [f for d in ("reference", "arch", "roofline", "roofline/kernels")
             for f in (KBENCH / d).glob("*.py")] + \
        [KBENCH / n for n in ("weights.py", "stats.py", "lookup.py")]
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "flax", "kjarni_tpu", "kjarni_tpu_torch"}
        assert not bad, (f, bad)
