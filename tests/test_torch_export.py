"""The port's browser export (kjarni_tpu_torch/export) against the JAX package's.

Bundles of a BERT encoder and a GPT-2 decoder, in f32 and int8, must be the
same bytes (manifest.json, weights.bin, tokenizer.json) from either package:
the port reads the weights through its own loaders into host numpy and
writes the same records. Q8_MIN_SIZE is lowered in both modules, as the JAX
tests do, so the tiny tensors take the q8 path. One index exports to the same
search JSON from both. The port's jsvm copy runs web/kjarni.js against a
bundle (`selftest_bundle`), and `load_browser_bundle` reads back the arrays
the JAX reader reads.
"""

import json

import numpy as np
import pytest
import torch

from helpers import build_word_tokenizer, save_torch_model, tiny_bert_dir

from kjarni_tpu.export import browser as jbrowser
from kjarni_tpu_torch.core.errors import InvalidConfigError
from kjarni_tpu_torch.export import browser as tbrowser

FILES = ("manifest.json", "weights.bin", "tokenizer.json")


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    from transformers import GPT2Config, GPT2LMHeadModel
    bert = tmp_path_factory.mktemp("export_bert")
    tiny_bert_dir(bert, seed=5)
    gpt = tmp_path_factory.mktemp("export_gpt")
    vm = build_word_tokenizer(gpt / "tokenizer.json", bert_style=False)
    config = GPT2Config(vocab_size=len(vm), n_embd=32, n_layer=2, n_head=4, n_positions=64,
                        bos_token_id=2, eos_token_id=3)
    torch.manual_seed(17)
    save_torch_model(gpt, GPT2LMHeadModel(config).eval(), config)
    return {"bert": bert, "gpt2": gpt}


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("kind", ["bert", "gpt2"])
def test_bundle_bytes_equal_jax(model_dirs, tmp_path, monkeypatch, kind, quantize):
    monkeypatch.setattr(jbrowser, "Q8_MIN_SIZE", 256)
    monkeypatch.setattr(tbrowser, "Q8_MIN_SIZE", 256)
    got = tbrowser.export_browser_model(model_dirs[kind], tmp_path / "port", quantize)
    want = jbrowser.export_browser_model(model_dirs[kind], tmp_path / "jax", quantize)
    assert got == want
    assert got["kind"] == ("gpt2" if kind == "gpt2" else "encoder")
    if quantize:
        assert any(r["dtype"] == "q8" for r in got["tensors"])
    for f in FILES:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    tm, tt = tbrowser.load_browser_bundle(tmp_path / "port")
    jm, jt = jbrowser.load_browser_bundle(tmp_path / "jax")
    assert tm == jm and tt.keys() == jt.keys()
    for name in tt:
        np.testing.assert_array_equal(tt[name], jt[name])


def test_unsupported_arch_raises_as_jax(tmp_path):
    d = tmp_path / "model"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"model_type": "nomic_bert", "vocab_size": 8,
                                               "n_embd": 8, "n_layer": 1, "n_head": 2}))
    with pytest.raises(InvalidConfigError, match="BERT-family encoders and GPT-2"):
        tbrowser.export_browser_model(d, tmp_path / "out")
    with pytest.raises(Exception, match="BERT-family encoders and GPT-2"):
        jbrowser.export_browser_model(d, tmp_path / "out_jax")


def test_search_index_json_equal_jax(model_dirs, tmp_path):
    """One index (written by the port's Indexer on the CPU) exports to the
    same bytes from both packages."""
    from kjarni_tpu_torch import Indexer
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "a.txt").write_text("keeping data safe with quality service")
    (docs / "b.md").write_text("the doctor and the nurse\n\ni love this product")
    Indexer(str(model_dirs["bert"]), device="cpu", quiet=True).create(tmp_path / "idx", [docs])
    got = tbrowser.export_search_index(tmp_path / "idx", tmp_path / "port.json")
    want = jbrowser.export_search_index(tmp_path / "idx", tmp_path / "jax.json")
    assert got["docs"] == want["docs"] == 2 and got["dim"] == want["dim"] == 32
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_selftest_runs_web_kjarni_js_through_the_port_jsvm(model_dirs, tmp_path):
    """web/kjarni.js, executed by the port's jsvm copy against the port's
    bundle, embeds to a unit vector; its summary equals the JAX selftest's
    on the JAX bundle (the same bytes) apart from the seconds."""
    tbrowser.export_browser_model(model_dirs["bert"], tmp_path / "port")
    jbrowser.export_browser_model(model_dirs["bert"], tmp_path / "jax")
    got = tbrowser.selftest_bundle(tmp_path / "port")
    want = jbrowser.selftest_bundle(tmp_path / "jax")
    assert got["kind"] == "encoder" and got["engine"] == "jsvm"
    assert abs(got["norm"] - 1.0) <= 1e-3
    got.pop("seconds")
    want.pop("seconds")
    assert got == want
