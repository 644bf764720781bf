"""The port's generation slice against the JAX package's, on the CPU.

The same tiny HF llama checkpoint (tests/helpers.py) goes through
`kjarni_tpu.Generator` and `kjarni_tpu_torch.Generator(device="cpu")`, both
in f32; greedy token ids and text must be equal for generate, a prefix-reuse
follow-up and generate_stream, with and without int4 weights. Hidden 256, so
int4 takes the grouped form (g = 128).
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from helpers import build_word_tokenizer, save_torch_model

from kjarni_tpu.generate.sampling import GenerationConfig as JaxGenerationConfig
from kjarni_tpu.tasks.generator import Generator as JaxGenerator
from kjarni_tpu_torch.generate.sampling import GenerationConfig
from kjarni_tpu_torch.core.errors import InvalidConfigError
from kjarni_tpu_torch.models.decoder_lm import resolve_dtype
from kjarni_tpu_torch.tasks.generator import Generator

ROOT = Path(__file__).resolve().parent.parent
PROMPT = "hello world the doctor and the nurse love this great product"
FOLLOW = "the physician was the best and it is safe"
GREEDY = dict(preset="greedy", max_new_tokens=24, max_length=128)


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    from transformers import LlamaConfig, LlamaForCausalLM
    d = tmp_path_factory.mktemp("torch_llama_lm")
    vocab_map = build_word_tokenizer(d / "tokenizer.json", bert_style=False)
    config = LlamaConfig(vocab_size=len(vocab_map), hidden_size=256,
                         intermediate_size=512, num_hidden_layers=2,
                         num_attention_heads=8, num_key_value_heads=4,
                         max_position_embeddings=128, bos_token_id=2,
                         eos_token_id=3, tie_word_embeddings=False)
    torch.manual_seed(11)
    model = LlamaForCausalLM(config).eval()
    with torch.no_grad():   # larger weights than HF's init: less repetitive text
        for p in model.parameters():
            if p.dim() == 2:
                p.normal_(0.0, 0.08)
    save_torch_model(d, model, config)
    return d


@pytest.mark.parametrize("quantize", [None, "int4"])
def test_generate_reuse_and_stream_match_jax(llama_dir, quantize):
    jg = JaxGenerator(str(llama_dir), quantize=quantize)
    tg = Generator(str(llama_dir), device="cpu", quantize=quantize)
    if quantize:   # grouped int4: two groups of 128 rows in the head
        assert tg.lm.params["lm_head"]["scale"].shape[0] == 2

    # generate
    assert tg.generate(PROMPT, **GREEDY) == jg.generate(PROMPT, **GREEDY)
    assert tg.lm._session_ids == jg.lm._session_ids
    assert len(tg.lm._session_ids) > len(tg.lm.encode_prompt(PROMPT))

    # follow-up extending the session: only the new suffix is prefilled
    extra = tg.lm.encode_prompt(FOLLOW, add_bos=False)
    follow = list(tg.lm._session_ids) + extra
    kw = dict(max_new_tokens=16, max_length=128)
    assert tg.lm.generate(token_ids=follow, config=GenerationConfig.greedy(**kw)) == \
        jg.lm.generate(token_ids=follow, config=JaxGenerationConfig.greedy(**kw))
    assert tg.lm.last_prefill_tokens == jg.lm.last_prefill_tokens == len(extra)
    assert tg.lm._session_ids == jg.lm._session_ids

    # stream on another prompt
    t_ids = [st.id for st in tg.generate_stream(FOLLOW, **GREEDY)]
    j_ids = [st.id for st in jg.generate_stream(FOLLOW, **GREEDY)]
    assert t_ids == j_ids and len(t_ids) > 0


def test_kv_bucket_segments_match_full_cache(llama_dir):
    full = Generator(str(llama_dir), device="cpu")
    seg = Generator(str(llama_dir), device="cpu")
    seg.lm._kv_bucket_step = 16          # buckets 16, 32, 48, ...
    kw = dict(preset="greedy", max_new_tokens=40, max_length=128)
    assert seg.generate(PROMPT, **kw) == full.generate(PROMPT, **kw)
    assert [s.id for s in seg.generate_stream(FOLLOW, **kw)] == \
        [s.id for s in full.generate_stream(FOLLOW, **kw)]


def test_sampled_generation_is_seeded(llama_dir):
    g = Generator(str(llama_dir), device="cpu")
    kw = dict(max_new_tokens=12, max_length=128, seed=5)
    assert g.generate(PROMPT, **kw) == g.generate(PROMPT, **kw)


def test_no_card_and_no_cpu_request_raises(llama_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present: Generator() would run on it")
    with pytest.raises(InvalidConfigError, match="device='cpu'"):
        Generator(str(llama_dir))


@pytest.mark.parametrize("kw", [dict(tp=2), dict(execution_plan="balanced")])
def test_options_outside_the_slice_raise(llama_dir, kw):
    # tp = 2 outside a process group of 2 ranks names the launcher; execution
    # plans are ported, and "balanced" is none of them
    match = ("torchrun --nproc-per-node 2" if "tp" in kw
             else "unknown execution plan 'balanced'")
    with pytest.raises(InvalidConfigError, match=match):
        Generator(str(llama_dir), device="cpu", **kw)


def test_native_checkpoint_dir_raises(tmp_path):
    """A kjarni_ckpt dir the port did not write (the JAX package's Orbax
    format) raises, naming the port's converter."""
    (tmp_path / "config.json").write_text("{}")
    (tmp_path / "kjarni_ckpt").mkdir()
    with pytest.raises(InvalidConfigError, match="native checkpoint.*convert_model"):
        Generator(str(tmp_path), device="cpu")


def test_card_dtype_is_bf16():
    """"auto" is bf16 on the card and f32 on the CPU; f32 is taken on the
    card too (both kernels have an f32 form), and f16 nowhere."""
    cuda = torch.device("cuda")
    assert resolve_dtype("auto", cuda) == torch.bfloat16
    assert resolve_dtype("auto", torch.device("cpu")) == torch.float32
    assert resolve_dtype("f32", cuda) == torch.float32
    with pytest.raises(InvalidConfigError, match="bf16 or f32"):
        resolve_dtype(torch.float16, cuda)


def test_safetensors_roundtrip_matches_jax_loader(tmp_path):
    """The port's writer and reader against the JAX package's reader: bf16
    comes back as torch.bfloat16, and a tensor at an offset its dtype does
    not divide (after 3 int8 bytes) still reads."""
    import numpy as np
    from kjarni_tpu.weights.safetensors_loader import ModelWeights as JaxWeights
    from kjarni_tpu_torch.weights.safetensors_loader import ModelWeights, save_file
    g = torch.Generator().manual_seed(0)
    tensors = {"a.i8": torch.tensor([1, -2, 3], dtype=torch.int8),
               "b.bf16": torch.randn(4, 6, generator=g).to(torch.bfloat16),
               "c.f32": torch.randn(5, generator=g)}
    save_file(tensors, tmp_path / "model.safetensors")
    ws, jws = ModelWeights(tmp_path), JaxWeights(tmp_path)
    for name, t in tensors.items():
        got = ws.get(name)
        assert got.dtype == t.dtype and torch.equal(got, t)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(jws.get(name), np.float32))


def test_bpe_tokenizer_matches_jax():
    from kjarni_tpu.tokenizer_native import BPETokenizer as JaxBPE
    from kjarni_tpu_torch.tokenizer_native import BPETokenizer, bytes_to_unicode
    enc = bytes_to_unicode()
    vocab = {c: i for i, c in enumerate(enc.values())}
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("Ġ", "w"), ("o", "r")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    specials = {"<|eot_id|>": len(vocab)}
    text = "hello world<|eot_id|> héllo, 42 worlds!"
    tb, jb = BPETokenizer(vocab, merges, specials), JaxBPE(vocab, merges, specials)
    ids = tb.encode(text)
    assert ids == jb.encode(text) and specials["<|eot_id|>"] in ids
    assert tb.decode(ids, skip_special_tokens=False) == \
        jb.decode(ids, skip_special_tokens=False) == text


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, the CLI, the C ABI's bridge and build and
    the browser export with its jsvm included, imports neither jax nor
    kjarni_tpu. The __main__ modules run the CLI when imported: the parser
    is built instead."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import kjarni_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(kjarni_tpu_torch.__path__,"
        " 'kjarni_tpu_torch.') if not m.name.endswith('__main__')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "from kjarni_tpu_torch.cli.main import build_parser\n"
        "build_parser()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'kjarni_tpu' or m.startswith('kjarni_tpu.')]\n"
        "print(json.dumps({'modules': mods, 'bad': bad}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(res["modules"]) > 20 and res["bad"] == []
    for sub in ("cli.main", "cli.display", "config_file", "ffi.bridge", "ffi.build",
                "export.browser", "export.jsvm.interp", "export.jsvm.parser",
                "parallel.train", "parallel.dryrun", "parallel.tensor", "serve_spmd"):
        assert f"kjarni_tpu_torch.{sub}" in res["modules"], sub


def test_chip_smoke_imports_neither():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    roots = {name.split(".")[0] for name in names}
    assert "kjarni_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "kjarni_tpu"}
