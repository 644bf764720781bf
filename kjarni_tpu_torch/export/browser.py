"""Browser deployment: export an encoder to a static bundle for web/kjarni.js.

The port of kjarni_tpu/export/browser.py: the same bundles, byte for byte,
read through kjarni_tpu_torch's weight loaders (models/bert.py, models/gpt2.py)
into host numpy. The export computes nothing on a device.

Rebuild of the reference's WASM story (crates/kjarni-wasm/src/lib.rs:42 —
standalone browser BERT embeddings + index via wasm-bindgen + SIMD128).
The compute engine (PyTorch on the CUDA card) has no browser target, so the
browser path is a separate thin artifact — a static
weight bundle (manifest.json + weights.bin + tokenizer.json) consumed by a
dependency-free JavaScript engine (web/kjarni.js) that implements WordPiece/
WordLevel tokenization, the BERT forward, mean pooling, cosine similarity,
and an in-memory index (the kjarni-wasm Model / WasmIndexBuilder / WasmSearch
surface). No build toolchain is needed on either side: `kjarni export-browser
<model> -o dist/` then serve dist/ + web/ as static files.

Format: weights.bin is the concatenation of little-endian tensors;
manifest.json carries the encoder config and per-tensor {name, shape,
offset (bytes), size (elements), dtype} records. dtype is "f32" (default)
or "q8" — int8 per-output-channel quantized (mirrors the reference's
quantized browser bundles, crates/kjarni-wasm/src/lib.rs:1064
from_quantized_bytes; the search widget defaults to a q8 model,
kjarni-search.js:14). A q8 record's int8 payload sits at `offset` and its
float32 scales at `scale_offset` (`scale_size` elements): for a stacked
[L, K, N] matmul weight the scales are per (layer, output-channel) [L, N];
the JS engine dequantizes in the matmul inner loop. Quantized bundles are
~4x smaller over the wire — the reason the reference ships q8 to browsers.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np

from ..core.errors import InvalidConfigError
from ..models import bert as kbert
from ..weights.safetensors_loader import ModelWeights


def _to_numpy(tree):
    """A param tree of CPU tensors as numpy arrays (None leaves stay)."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return None if tree is None else tree.numpy()


def _flatten(prefix: str, tree) -> list[tuple[str, np.ndarray]]:
    out = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.extend(_flatten(f"{prefix}.{k}" if prefix else k, v))
    elif tree is None:
        pass
    else:
        out.append((prefix, np.asarray(tree, dtype=np.float32)))
    return out


# minimum element count for a tensor to be worth quantizing (tests shrink
# this to exercise q8 on tiny fixtures)
Q8_MIN_SIZE = 65536


def _quantizable(name: str, arr: np.ndarray) -> bool:
    """int8-quantize the large matmul weights and token-embedding tables;
    keep norms, biases, and the small positional/type tables exact."""
    if arr.ndim < 2 or arr.size < Q8_MIN_SIZE:
        return False
    low = name.lower()
    if any(s in low for s in ("norm", "bias", "position", "token_type",
                              "wpe", "pooler")):
        return False
    if low.endswith((".b", "_b")):
        return False
    return True


def _quantize_q8(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8: treat the tensor as
    [..., K, N] and scale per [..., N] (reduce over the contraction axis K;
    for embedding tables the 'channel' is the hidden dim, so lookups
    dequantize with one scale vector)."""
    red_axis = arr.ndim - 2
    scale = np.maximum(np.abs(arr).max(axis=red_axis), 1e-12) / 127.0
    q = np.clip(np.round(arr / np.expand_dims(scale, red_axis)),
                -127, 127).astype(np.int8)
    return q, scale.astype("<f4")


def _write_bundle(out_dir: Path, model_dir: Path, kind: str, config: dict,
                  params: dict, quantize: str | None = None) -> dict:
    if quantize not in (None, "int8"):
        raise InvalidConfigError(
            f"unknown browser quantize mode '{quantize}' (expected 'int8')")
    tensors = _flatten("", params)
    records = []
    offset = 0
    blobs = []

    def pad4():
        # keep every record 4-byte aligned: Float32Array views on the
        # ArrayBuffer require byteOffset % 4 == 0
        nonlocal offset
        rem = offset % 4
        if rem:
            blobs.append(b"\x00" * (4 - rem))
            offset += 4 - rem

    for name, arr in tensors:
        if quantize == "int8" and _quantizable(name, arr):
            q, scale = _quantize_q8(arr)
            q = np.ascontiguousarray(q)
            rec = {"name": name, "shape": list(arr.shape),
                   "offset": offset, "size": int(q.size), "dtype": "q8"}
            offset += q.nbytes
            blobs.append(q.tobytes())
            pad4()
            rec["scale_offset"] = offset
            rec["scale_size"] = int(scale.size)
            offset += scale.nbytes
            blobs.append(np.ascontiguousarray(scale).tobytes())
            records.append(rec)
            continue
        arr = np.ascontiguousarray(arr, dtype="<f4")
        records.append({"name": name, "shape": list(arr.shape),
                        "offset": offset, "size": int(arr.size),
                        "dtype": "f32"})
        offset += arr.nbytes
        blobs.append(arr.tobytes())

    manifest = {
        "format": "kjarni-browser-v1",
        "kind": kind,
        "config": config,
        "tensors": records,
        "weights_bytes": offset,
        "quantize": quantize,
    }
    (out_dir / "manifest.json").write_text(json.dumps(manifest))
    with open(out_dir / "weights.bin", "wb") as f:
        for b in blobs:
            f.write(b)
    tok = model_dir / "tokenizer.json"
    if tok.exists():
        shutil.copy(tok, out_dir / "tokenizer.json")
    return manifest


def export_browser_model(model_dir: Path, out_dir: Path,
                         quantize: str | None = None) -> dict:
    """Export a BERT-family encoder OR a GPT-2 decoder to a browser bundle.

    Returns the manifest dict. Encoders drive KjarniModel (embeddings/index,
    kjarni-wasm's main module); GPT-2 drives KjarniGPT (the WasmGPT
    counterpart, kjarni-models/src/wasm/mod.rs:47).
    """
    model_dir = Path(model_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    hf_cfg = json.loads((model_dir / "config.json").read_text())
    if hf_cfg.get("model_type") == "gpt2":
        import torch

        from ..models import gpt2 as kgpt2
        cfg = kgpt2.Gpt2Config.from_hf(hf_cfg)
        ws = ModelWeights(model_dir)
        params = kgpt2.load_params(ws, cfg, dtype=torch.float32, device="cpu")
        params = _to_numpy(params)
        params.pop("lm_head")  # tied to embed; JS reuses wte
        config = {
            "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.hidden_size,
            "num_layers": cfg.num_layers,
            "num_heads": cfg.num_heads,
            "max_seq_len": cfg.max_seq_len,
            "layer_norm_eps": cfg.layer_norm_eps,
            "eos_token_id": (cfg.eos_token_ids[0]
                             if cfg.eos_token_ids else None),
        }
        return _write_bundle(out_dir, model_dir, "gpt2", config, params,
                             quantize)

    cfg = kbert.BertConfig.from_hf(hf_cfg)
    if cfg.flavor not in ("bert", "distilbert", "roberta", "mpnet"):
        raise InvalidConfigError(
            f"browser export supports BERT-family encoders and GPT-2, "
            f"not '{cfg.flavor}'")
    if cfg.flavor == "mpnet":
        raise InvalidConfigError(
            "browser export does not implement MPNet relative attention yet")

    ws = ModelWeights(model_dir)
    params = kbert._load_f32(ws, cfg)   # the f32 numpy tree load_params moves to a device
    config = {
        "flavor": cfg.flavor,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "num_layers": cfg.num_layers,
        "num_heads": cfg.num_heads,
        "intermediate_size": cfg.intermediate_size,
        "max_position_embeddings": cfg.max_position_embeddings,
        "type_vocab_size": cfg.type_vocab_size,
        "pad_token_id": cfg.pad_token_id,
        "layer_norm_eps": cfg.layer_norm_eps,
        "activation": cfg.activation,
        "position_offset": cfg.position_offset,
    }
    return _write_bundle(out_dir, model_dir, "encoder", config, params,
                         quantize)


def export_search_index(index_dir: Path, out_file: Path,
                        decimals: int = 5) -> dict:
    """Export an on-disk RAG index to the search widget's JSON format.

    Counterpart of the reference's browser index blob (the kjarni-search.js
    widget fetches a prebuilt index next to the model,
    crates/kjarni-wasm/src/kjarni-search.js:14): every document's text,
    metadata, and PRECOMPUTED embedding vector, so the widget only embeds
    the query at search time. Vectors are rounded to `decimals` places —
    they are L2-normalized, so 5 decimals keeps cosine error < 1e-4 while
    roughly halving the JSON payload.
    """
    from ..rag.index import IndexReader

    # the stored vectors are read on the host: nothing here is scored
    reader = IndexReader.open(Path(index_dir), "cpu")
    docs = []
    for seg in reader.segments:
        emb = np.round(np.asarray(seg.embeddings, dtype=np.float64), decimals)
        for i, text in enumerate(seg.docs):
            docs.append({"text": text, "metadata": seg.meta[i],
                         "vector": emb[i].tolist()})
    payload = {"dim": reader.dimension, "model": reader.model, "docs": docs}
    out_file = Path(out_file)
    out_file.parent.mkdir(parents=True, exist_ok=True)
    out_file.write_text(json.dumps(payload))
    return {"docs": len(docs), "dim": reader.dimension,
            "bytes": out_file.stat().st_size}


def selftest_bundle(out_dir: Path) -> dict:
    """Execute web/kjarni.js against an exported bundle via the in-tree jsvm.

    This runs the ACTUAL shipped JavaScript (not a mirror): the jsvm
    interpreter (kjarni_tpu_torch/export/jsvm) loads web/kjarni.js, constructs
    KjarniModel/KjarniGPT from the bundle's real manifest + weights.bin +
    tokenizer.json, and drives an embed (encoders) or a short greedy
    generation (gpt2). Counterpart of the reference's wasm-bindgen tests
    (crates/kjarni-wasm/src/lib.rs:42) for an image with no JS runtime.
    Returns a summary dict; raises on any failure.
    """
    import time

    import numpy as np

    from .jsvm import load_module
    from .jsvm.interp import ArrayBuffer

    out_dir = Path(out_dir)
    js_path = Path(__file__).resolve().parents[2] / "web" / "kjarni.js"
    if not js_path.exists():
        raise FileNotFoundError(f"web/kjarni.js not found at {js_path}")

    manifest = json.loads((out_dir / "manifest.json").read_text())
    weights = ArrayBuffer(bytearray((out_dir / "weights.bin").read_bytes()))
    tok = json.loads((out_dir / "tokenizer.json").read_text())

    interp, exports = load_module(js_path)
    t0 = time.time()
    if manifest["kind"] == "gpt2":
        gpt = interp.call_method(exports.props["KjarniGPT"], "fromBuffers",
                                 manifest, weights, tok, raw=True)
        text = interp.call_method(gpt, "generate", "the", 4)
        if not isinstance(text, str):
            raise AssertionError("KjarniGPT.generate did not return a string")
        return {"kind": "gpt2", "engine": "jsvm", "generated": text,
                "seconds": round(time.time() - t0, 2)}

    model = interp.call_method(exports.props["KjarniModel"], "fromBuffers",
                               manifest, weights, tok, raw=True)
    vec = np.asarray(interp.call_method(model, "embed",
                                        "kjarni browser selftest"))
    h = manifest["config"]["hidden_size"]
    if vec.shape != (h,):
        raise AssertionError(f"embed returned shape {vec.shape}, want ({h},)")
    if not np.all(np.isfinite(vec)):
        raise AssertionError("embed returned non-finite values")
    norm = float(np.linalg.norm(vec))
    if abs(norm - 1.0) > 1e-3:
        raise AssertionError(f"embed is not L2-normalized (norm={norm})")
    sim = interp.call_method(model, "similarity", "a cat", "a dog")
    return {"kind": "encoder", "engine": "jsvm", "dim": h,
            "norm": round(norm, 6), "similarity": round(float(sim), 6),
            "seconds": round(time.time() - t0, 2)}


def load_browser_bundle(out_dir: Path) -> tuple[dict, dict]:
    """Read a bundle back into {name: array} (round-trip tests / JS oracle)."""
    out_dir = Path(out_dir)
    manifest = json.loads((out_dir / "manifest.json").read_text())
    raw = (out_dir / "weights.bin").read_bytes()
    tensors = {}
    for rec in manifest["tensors"]:
        if rec.get("dtype") == "q8":
            q = np.frombuffer(raw, dtype=np.int8, count=rec["size"],
                              offset=rec["offset"]).reshape(rec["shape"])
            s = np.frombuffer(raw, dtype="<f4", count=rec["scale_size"],
                              offset=rec["scale_offset"])
            s = s.reshape(rec["shape"][:-2] + rec["shape"][-1:])
            tensors[rec["name"]] = (q.astype(np.float32)
                                    * np.expand_dims(s, -2))
        else:
            a = np.frombuffer(raw, dtype="<f4", count=rec["size"],
                              offset=rec["offset"])
            tensors[rec["name"]] = a.reshape(rec["shape"])
    return manifest, tensors
