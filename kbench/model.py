"""Builds the program's model for a configuration file, through its normal
constructor.

A configuration file holds the published `config.json` values at its top
level, and beside them what the benchmark adds: `source`, `dtype`,
`quantize`, `reduced` and `assumed`. The model directory, made under TMPDIR
for one run and removed with it, holds only that `config.json` and a
word-level `tokenizer.json` over the vocabulary (requests are sent as token
ids). The weights are `weights.SeededWeights`, put in place of
`weights/safetensors_loader.ModelWeights` for the construction alone: the
harness's one seam into the program. No weight file is written.

The configuration's `model_type` picks the architecture module
(`kbench/arch/<family>.py`) whose layout the seeded checkpoint follows; a new
architecture is a new file there, with no edit here. The program builds the
model for that `model_type` by itself.
"""

from __future__ import annotations

import json
from pathlib import Path

from . import lookup
from .weights import SeededWeights

EXTRA_KEYS = ("source", "dtype", "quantize", "reduced", "assumed")


def hf_config(conf: dict) -> dict:
    """The published config.json values of a configuration file."""
    return {k: v for k, v in conf.items() if k not in EXTRA_KEYS}


def tokenizer_json(vocab: int) -> dict:
    """A word-level tokenizer: [PAD], [UNK], then w2, w3, ... (whitespace
    split), so that every id decodes."""
    words = {"[PAD]": 0, "[UNK]": 1}
    words.update({f"w{i}": i for i in range(2, vocab)})
    return {"version": "1.0", "truncation": None, "padding": None, "added_tokens": [],
            "normalizer": None, "pre_tokenizer": {"type": "Whitespace"},
            "post_processor": None, "decoder": None,
            "model": {"type": "WordLevel", "vocab": words, "unk_token": "[UNK]"}}


def build(conf: dict, seed: int, max_context: int, device, model_dir: Path,
          kroot: Path = lookup.KROOT):
    """The program's DecoderLM of configuration `conf` with weights from
    `seed`, on `device`. Every stop token is dropped, so each request runs
    to its max_new_tokens, as serving benchmarks run random weights."""
    from kjarni_tpu_torch.models import decoder_lm
    hf = hf_config(conf)
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "config.json").write_text(json.dumps(hf))
    (model_dir / "tokenizer.json").write_text(json.dumps(tokenizer_json(hf["vocab_size"])))
    source = SeededWeights(hf, seed, device, kroot)
    seam = decoder_lm.ModelWeights
    decoder_lm.ModelWeights = lambda _dir: source
    try:
        lm = decoder_lm.DecoderLM(model_dir, dtype=conf["dtype"], max_context=max_context,
                                  quantize=conf.get("quantize"), device=device)
    finally:
        decoder_lm.ModelWeights = seam
        source.release()
    lm.stop_token_ids = set()
    return lm
