"""Encoder model wrappers: SentenceEncoder, CrossEncoder, SequenceClassifier
(port of kjarni_tpu/models/encoder_models.py).

Each wrapper owns a tokenizer, a frozen BertConfig and a param dict on its
device, and runs `bert.encode_auto` eagerly. Batches are padded to the same
(batch, seq) buckets as the JAX package, so both run the same rows.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.errors import WeightLoadError
from ..ops.pooling import PoolingStrategy, pool
from ..tokenizer import KjarniTokenizer
from ..weights.safetensors_loader import ModelWeights
from . import bert as kbert
from ..parallel.comm import Comm, require_world
from ..parallel.inference import rows_data_parallel
from .decoder_lm import auto_dtype, resolve_device


def _l2_normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


class _EncoderBase:
    """Shared load path: config.json + tokenizer.json + safetensors -> params
    on the device.

    `device=None` means the CUDA card and raises when there is none; pass
    `device="cpu"` to run on the CPU. `dtype="auto"` is bf16 on the card and
    f32 on the CPU; f32 runs on the card too (no kernel here needs bf16).

    `dp=N` (SPMD, one process per rank over a process group of N ranks):
    every rank holds the whole encoder, encodes and pools (or scores) its
    share of each batch's rows, and only those per-row results are
    all-gathered (parallel/inference.py), so every rank returns the whole
    batch's results. `hidden_states` is not split.
    """

    def __init__(self, model_dir: Path, dtype="auto", device=None,
                 dp: Optional[int] = None):
        self._dp = None
        if dp is not None and dp > 1:
            require_world(dp, "dp")
            self._dp = Comm()
        self.device = resolve_device(device)
        dtype = auto_dtype(dtype, self.device)
        model_dir = Path(model_dir)
        self.model_dir = model_dir
        hf_cfg = json.loads((model_dir / "config.json").read_text())
        self.hf_config = hf_cfg
        self.config = kbert.BertConfig.from_hf(hf_cfg)
        self.tokenizer = KjarniTokenizer.from_file(
            model_dir / "tokenizer.json", pad_token_id=self.config.pad_token_id)
        ws = ModelWeights(model_dir)
        self.params = kbert.load_params(ws, self.config, dtype, self.device)
        self._weights = ws

    def _encode(self, params: dict, ids: torch.Tensor, mask: torch.Tensor,
                token_type: torch.Tensor) -> torch.Tensor:
        return kbert.encode_auto(params, self.config, ids, mask, token_type)

    def _rows(self, fn, ids: torch.Tensor, mask: torch.Tensor,
              token_type: torch.Tensor) -> torch.Tensor:
        """fn(ids, mask, token_type) -> one result per row; under dp, over
        this rank's share of the rows, gathered."""
        if self._dp is None:
            return fn(ids, mask, token_type)
        return rows_data_parallel(fn, self._dp, ids, mask, token_type)

    def _device_batch(self, ids: np.ndarray, mask: np.ndarray, tt: np.ndarray):
        """Host batch -> device tensors (ids and token types as int64)."""
        return (torch.from_numpy(ids.astype(np.int64)).to(self.device),
                torch.from_numpy(mask).to(self.device),
                torch.from_numpy(tt.astype(np.int64)).to(self.device))

    @property
    def hidden_size(self) -> int:
        return self.config.hidden_size

    @property
    def max_seq_len(self) -> int:
        return self.config.max_position_embeddings - self.config.position_offset

    def hidden_states(self, texts: Sequence[str], pairs: Sequence[str] | None = None
                      ) -> tuple[torch.Tensor, np.ndarray, np.ndarray]:
        """(hidden [rows, S, H] on the device, ids, mask); rows is the batch
        bucket, so callers slice by the true batch length."""
        ids, mask, tt = self._tokens(texts, pairs)
        with torch.inference_mode():
            hidden = self._encode(self.params, *self._device_batch(ids, mask, tt))
        return hidden, ids, mask

    def _tokens(self, texts: Sequence[str], pairs: Sequence[str] | None = None):
        """(ids, mask, token types) of the padded batch bucket, on the host."""
        ids, mask = self.tokenizer.encode_batch(
            texts, pairs=pairs, max_len=self.max_seq_len, padding="right",
            pad_batch=True)
        # token_type ids: second segment = 1 for pair inputs on BERT-type models
        if pairs is not None and self.config.type_vocab_size > 1:
            tt = self._pair_type_ids(texts, pairs, ids.shape[1], ids.shape[0])
        else:
            tt = np.zeros_like(ids)
        return ids, mask, tt

    def _pair_type_ids(self, texts, pairs, width, rows=None) -> np.ndarray:
        encs = self.tokenizer.tk.encode_batch(list(zip(texts, pairs)))
        tt = np.zeros((rows or len(texts), width), dtype=np.int32)
        for i, e in enumerate(encs):
            type_ids = e.type_ids[:width]
            tt[i, :len(type_ids)] = type_ids
        return tt


class SentenceEncoder(_EncoderBase):
    """Text -> embedding (cf. sentence_encoder/model.rs:33).

    Defaults mirror the reference: mean pooling + L2 normalization.
    """

    MAX_ENCODE_BATCH = 512  # chunk huge corpora to bound activation memory

    def encode_batch(self, texts: Sequence[str], *,
                     pooling: PoolingStrategy | str = PoolingStrategy.MEAN,
                     normalize: bool = True) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.hidden_size), dtype=np.float32)
        if isinstance(pooling, str):
            pooling = PoolingStrategy(
                {"lastToken": "last", "last_token": "last"}.get(pooling, pooling))
        chunks = []
        for i in range(0, len(texts), self.MAX_ENCODE_BATCH):
            batch = list(texts[i:i + self.MAX_ENCODE_BATCH])

            def embed(ids, mask, tt):
                return pool(pooling, self._encode(self.params, ids, mask, tt), mask)
            with torch.inference_mode():
                pooled = self._rows(embed, *self._device_batch(*self._tokens(batch)))
            chunks.append(pooled.float().cpu().numpy()[:len(batch)])
        pooled = np.concatenate(chunks, axis=0)
        if normalize:
            pooled = _l2_normalize(pooled)
        return pooled

    def encode(self, text: str, **kw) -> np.ndarray:
        return self.encode_batch([text], **kw)[0]

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.encode_batch([a, b])
        return float(va @ vb)


class CrossEncoder(_EncoderBase):
    """Query-document relevance scoring (cf. cross_encoder/model.rs:32)."""

    MAX_PAIR_BATCH = 256

    def __init__(self, model_dir: Path, dtype="auto", device=None,
                 dp: Optional[int] = None):
        super().__init__(model_dir, dtype, device, dp)
        self.head = _load_classification_head(self._weights, self.hf_config, self.device)

    def _score(self, params: dict, head_params: dict, ids: torch.Tensor,
               mask: torch.Tensor, token_type: torch.Tensor) -> torch.Tensor:
        def score(i, m, t):
            return _head_forward(self.head, head_params, self._encode(params, i, m, t),
                                 m)[:, 0]
        return self._rows(score, ids, mask, token_type)

    def predict_pairs(self, pairs: Sequence[tuple[str, str]]) -> np.ndarray:
        """Raw relevance logits, first column (cf. model.rs:170 predict_pairs)."""
        if not pairs:
            return np.zeros((0,), dtype=np.float32)
        if len(pairs) > self.MAX_PAIR_BATCH:
            return np.concatenate([
                self.predict_pairs(pairs[i:i + self.MAX_PAIR_BATCH])
                for i in range(0, len(pairs), self.MAX_PAIR_BATCH)])
        queries = [q for q, _ in pairs]
        docs = [d for _, d in pairs]
        ids, mask = self.tokenizer.encode_batch(
            queries, pairs=docs, max_len=self.max_seq_len, pad_batch=True)
        if self.config.type_vocab_size > 1:
            tt = self._pair_type_ids(queries, docs, ids.shape[1], ids.shape[0])
        else:
            tt = np.zeros_like(ids)
        with torch.inference_mode():
            scores = self._score(self.params, self.head.params,
                                 *self._device_batch(ids, mask, tt))
        return scores.float().cpu().numpy()[:len(pairs)]

    def predict_pair(self, query: str, document: str) -> float:
        return float(self.predict_pairs([(query, document)])[0])

    def rerank(self, query: str, documents: Sequence[str]) -> list[tuple[int, float]]:
        if not documents:
            return []
        scores = self.predict_pairs([(query, d) for d in documents])
        order = np.argsort(-scores)
        return [(int(i), float(scores[i])) for i in order]

    def rerank_top_k(self, query: str, documents: Sequence[str], k: int):
        return self.rerank(query, documents)[:k]


# ---------------------------------------------------------------------------
# Classification head (auto-detected, cf. cpu/encoder/classifier.rs:101)
# ---------------------------------------------------------------------------

class _HeadSpec:
    def __init__(self, kind: str, activation: str, pooling: str, params: dict,
                 labels: Optional[list[str]]):
        self.kind = kind              # pre_classifier | pooler | plain
        self.activation = activation  # tanh | relu | none
        self.pooling = pooling        # cls | last
        self.params = params
        self.labels = labels

    @property
    def num_classes(self) -> int:
        return self.params["classifier"]["w"].shape[-1]


def _lin(ws: ModelWeights, name: str, device: torch.device | str = "cpu") -> dict:
    """An f32 linear {"w": [in, out], "b": [out]} on `device` (the JAX package
    keeps head weights in f32 whatever the encoder's dtype)."""
    p = {"w": ws.get(f"{name}.weight").float().t().contiguous().to(device)}
    if f"{name}.bias" in ws:
        p["b"] = ws.get(f"{name}.bias").float().to(device)
    return p


def _load_classification_head(ws: ModelWeights, hf_cfg: dict,
                              device: torch.device | str = "cpu") -> _HeadSpec:
    """Detection cascade matching classifier.rs from_weights (order matters)."""
    labels = None
    id2label = hf_cfg.get("id2label")
    if isinstance(id2label, dict) and id2label:
        labels = [v for _, v in sorted(id2label.items(), key=lambda kv: int(kv[0]))]
    pooling = "last" if hf_cfg.get("model_type") == "bart" else "cls"

    def lin(name):
        return _lin(ws, name, device)

    if ws.has_any("classification_head.dense.weight"):
        params = {"pre": lin("classification_head.dense"),
                  "classifier": lin("classification_head.out_proj")}
        return _HeadSpec("pre_classifier", "tanh", pooling, params, labels)
    if ws.has_any("classifier.dense.weight"):
        params = {"pre": lin("classifier.dense"),
                  "classifier": lin("classifier.out_proj")}
        return _HeadSpec("pre_classifier", "tanh", pooling, params, labels)
    if ws.has_any("pre_classifier.weight"):
        params = {"pre": lin("pre_classifier"), "classifier": lin("classifier")}
        return _HeadSpec("pre_classifier", "relu", pooling, params, labels)
    if ws.has_any("bert.pooler.dense.weight"):
        params = {"pre": lin("bert.pooler.dense"), "classifier": lin("classifier")}
        return _HeadSpec("pooler", "tanh", pooling, params, labels)
    if ws.has_any("classifier.weight"):
        return _HeadSpec("plain", "none", pooling, {"classifier": lin("classifier")},
                         labels)
    raise WeightLoadError(
        "Could not auto-detect a classification head (checked classification_head.dense, "
        "classifier.dense, pre_classifier, bert.pooler, classifier)")


def _head_forward(head: _HeadSpec, params: dict, hidden: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Pool, then the head in f32 (a bf16 hidden state is promoted, as JAX
    promotes bf16 @ f32)."""
    if head.pooling == "last":
        lengths = mask.to(torch.int64).sum(dim=1)
        idx = (lengths - 1).clamp_min(0)
        x = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
    else:
        x = hidden[:, 0, :]
    x = x.float()
    if "pre" in params:
        x = x @ params["pre"]["w"]
        if "b" in params["pre"]:
            x = x + params["pre"]["b"]
        if head.activation == "tanh":
            x = torch.tanh(x)
        elif head.activation == "relu":
            x = torch.relu(x)
    c = params["classifier"]
    x = x @ c["w"]
    return x + c["b"] if "b" in c else x


class SequenceClassifier(_EncoderBase):
    """Text -> label scores (cf. sequence_classifier/mod.rs:42)."""

    def __init__(self, model_dir: Path, dtype="auto", device=None,
                 dp: Optional[int] = None):
        super().__init__(model_dir, dtype, device, dp)
        self.head = _load_classification_head(self._weights, self.hf_config, self.device)
        self.labels = self.head.labels
        self.is_multi_label = (
            self.hf_config.get("problem_type") == "multi_label_classification")

    def _logits(self, params: dict, head_params: dict, ids: torch.Tensor,
                mask: torch.Tensor, token_type: torch.Tensor) -> torch.Tensor:
        def logits(i, m, t):
            return _head_forward(self.head, head_params, self._encode(params, i, m, t), m)
        return self._rows(logits, ids, mask, token_type)

    def predict_logits(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.head.num_classes), dtype=np.float32)
        ids, mask = self.tokenizer.encode_batch(texts, max_len=self.max_seq_len,
                                                pad_batch=True)
        tt = np.zeros_like(ids)
        with torch.inference_mode():
            logits = self._logits(self.params, self.head.params,
                                  *self._device_batch(ids, mask, tt))
        return logits.float().cpu().numpy()[:len(texts)]

    def classify_scores_batch(self, texts: Sequence[str],
                              multi_label: Optional[bool] = None) -> np.ndarray:
        logits = self.predict_logits(texts)
        ml = self.is_multi_label if multi_label is None else multi_label
        if ml:
            return 1.0 / (1.0 + np.exp(-logits))
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    def classify_batch(self, texts: Sequence[str], top_k: int = 1,
                       multi_label: Optional[bool] = None) -> list[list[tuple[str, float]]]:
        scores = self.classify_scores_batch(texts, multi_label)
        labels = self.labels or [f"LABEL_{i}" for i in range(scores.shape[1])]
        out = []
        for row in scores:
            ranked = sorted(zip(labels, row.tolist()), key=lambda t: -t[1])
            out.append([(l, float(s)) for l, s in ranked[:top_k]])
        return out

    def classify(self, text: str) -> tuple[str, float]:
        return self.classify_batch([text], top_k=1)[0][0]
