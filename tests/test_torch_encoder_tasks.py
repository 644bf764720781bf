"""kjarni_tpu_torch's encoder wrappers and task APIs (Embedder, Classifier,
Reranker) against the JAX package's, on the CPU, in f32.

Both packages load the same tiny checkpoints (tests/helpers.py's
tiny_bert_dir, tests/test_nomic.py's make_nomic_dir, and BERT dirs with each
classification-head layout of the detection cascade), and take the same
texts through their tokenizers. Tolerances are the JAX tests' own:
embeddings atol 2e-4 / rtol 1e-3 and cosine >= 0.999; classifier and
cross-encoder logits atol 5e-4; labels, argmaxes and rerank orders exactly.
"""

import json

import numpy as np
import pytest
import torch

from helpers import build_word_tokenizer, tiny_bert_dir
from test_nomic import make_nomic_dir

from kjarni_tpu.models import encoder_models as jem
from kjarni_tpu.tasks.classifier import Classifier as JaxClassifier
from kjarni_tpu.tasks.embedder import Embedder as JaxEmbedder
from kjarni_tpu.tasks.reranker import Reranker as JaxReranker
from kjarni_tpu_torch.core.errors import (InvalidConfigError, TaskValidationError,
                                          WeightLoadError)
from kjarni_tpu_torch.models import encoder_models as tem
from kjarni_tpu_torch.tasks.classifier import Classifier
from kjarni_tpu_torch.tasks.embedder import Embedder, cosine_similarity
from kjarni_tpu_torch.tasks.reranker import Reranker

TEXTS = ["i love this product", "terrible quality", "the best purchase ever made",
         "hello world", "doctor physician nurse and the data"]
DOCS = ["i love this", "terrible quality", "data safe keeping",
        "the worst purchase ever", "keeping data safe is good"]
QUERY = "keeping data safe"


def _assert_embeddings(got, want):
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                  * np.linalg.norm(want, axis=-1))
    assert (cos >= 0.999).all()


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    out = {}

    def mk(name):
        return tmp_path_factory.mktemp(name)

    out["bert"] = mk("bert")
    tiny_bert_dir(out["bert"])
    out["nomic"] = mk("nomic")
    make_nomic_dir(out["nomic"], seed=2)
    out["sentiment"] = mk("sentiment")
    tiny_bert_dir(out["sentiment"], num_labels=2, seed=1)
    out["multi"] = mk("multi")
    tiny_bert_dir(out["multi"], num_labels=4, seed=3,
                  problem_type="multi_label_classification")
    out["cross"] = mk("cross")
    tiny_bert_dir(out["cross"], num_labels=1, seed=5)
    return out


class TestEmbedder:
    @pytest.mark.parametrize("model,pooling,normalize", [
        ("bert", "mean", True), ("bert", "cls", False), ("bert", "max", True),
        ("bert", "last", False), ("nomic", "mean", True)])
    def test_embed_batch_matches_jax(self, dirs, model, pooling, normalize):
        d = str(dirs[model])
        got = Embedder(d, device="cpu", pooling=pooling,
                       normalize=normalize).embed_batch(TEXTS)
        want = JaxEmbedder(d, device="cpu", pooling=pooling,
                           normalize=normalize).embed_batch(TEXTS)
        assert got.shape == want.shape == (len(TEXTS), 32)
        _assert_embeddings(got, want)
        if normalize:
            np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)

    def test_similarity_and_ranking_match_jax(self, dirs):
        d = str(dirs["bert"])
        emb, jemb = Embedder(d, device="cpu"), JaxEmbedder(d, device="cpu")
        assert emb.dim == jemb.dim == 32
        _assert_embeddings(emb.embed("hello world")[None],
                           jemb.embed("hello world")[None])
        assert abs(emb.similarity("doctor", "physician")
                   - jemb.similarity("doctor", "physician")) < 1e-4
        np.testing.assert_allclose(emb.similarities(QUERY, DOCS),
                                   jemb.similarities(QUERY, DOCS), atol=1e-4)
        assert [i for i, _ in emb.rank_by_similarity(QUERY, DOCS)] == \
            [i for i, _ in jemb.rank_by_similarity(QUERY, DOCS)]
        assert emb.similarities(QUERY, []) == []
        assert emb.embed_batch([]).shape == (0, 32)
        assert cosine_similarity(np.zeros(3), np.ones(3)) == 0.0

    def test_long_batches_are_chunked(self, dirs, monkeypatch):
        """More texts than MAX_ENCODE_BATCH run in chunks with the same result."""
        enc = tem.SentenceEncoder(dirs["bert"], device="cpu")
        whole = enc.encode_batch(TEXTS)
        monkeypatch.setattr(tem.SentenceEncoder, "MAX_ENCODE_BATCH", 2)
        np.testing.assert_allclose(enc.encode_batch(TEXTS), whole, atol=1e-6)


class TestClassifier:
    def test_single_label_matches_jax(self, dirs):
        d = str(dirs["sentiment"])
        clf, jclf = Classifier(d, device="cpu"), JaxClassifier(d, device="cpu")
        np.testing.assert_allclose(clf._clf.predict_logits(TEXTS),
                                   jclf._clf.predict_logits(TEXTS), atol=5e-4)
        got, want = clf.classify_batch(TEXTS), jclf.classify_batch(TEXTS)
        assert [r.label for r in got] == [r.label for r in want]
        assert clf.labels == jclf.labels == ["NEGATIVE", "POSITIVE"]
        assert not clf.is_multi_label
        for r in got:
            assert abs(sum(s for _, s in r.all_scores) - 1.0) < 1e-5
        np.testing.assert_allclose(clf.classify_scores(TEXTS[0]),
                                   jclf.classify_scores(TEXTS[0]), atol=5e-4)
        assert [l for l, _ in clf.classify_top_k(TEXTS[1], 1)] == \
            [l for l, _ in jclf.classify_top_k(TEXTS[1], 1)]
        assert all(s >= 0.3 for _, s in clf.classify_with_threshold(TEXTS[2], 0.3))
        assert str(got[0]).startswith(got[0].label)
        assert clf.classify_batch([]) == []

    def test_multi_label_matches_jax(self, dirs):
        d = str(dirs["multi"])
        clf, jclf = Classifier(d, device="cpu"), JaxClassifier(d, device="cpu")
        assert clf.is_multi_label and jclf.is_multi_label
        got, want = clf.classify_batch(TEXTS), jclf.classify_batch(TEXTS)
        for g, w in zip(got, want):
            assert [l for l, _ in g.all_scores] == [l for l, _ in w.all_scores]
            np.testing.assert_allclose([s for _, s in g.all_scores],
                                       [s for _, s in w.all_scores], atol=5e-4)
        logits = clf._clf.predict_logits(TEXTS[:1])
        np.testing.assert_allclose(clf.classify_scores(TEXTS[0]),
                                   1 / (1 + np.exp(-logits[0])), atol=1e-6)

    def test_labels_override_and_mode_override(self, dirs):
        d = str(dirs["multi"])
        labels = ["joy", "anger", "fear", "surprise"]
        clf = Classifier(d, device="cpu", labels=labels, multi_label=False)
        jclf = JaxClassifier(d, device="cpu", labels=labels, multi_label=False)
        assert clf.labels == labels and not clf.is_multi_label
        got, want = clf.classify_batch(TEXTS), jclf.classify_batch(TEXTS)
        assert [r.label for r in got] == [r.label for r in want]
        assert all(r.label in labels for r in got)
        with pytest.raises(TaskValidationError):
            Classifier(d, device="cpu", labels=["a", "b"])


class TestReranker:
    def test_rerank_matches_jax(self, dirs):
        d = str(dirs["cross"])
        rr, jrr = Reranker(d, device="cpu"), JaxReranker(d, device="cpu")
        pairs = [(QUERY, doc) for doc in DOCS]
        np.testing.assert_allclose(rr.score_pairs(pairs), jrr.score_pairs(pairs),
                                   atol=5e-4)
        assert abs(rr.score(QUERY, DOCS[0]) - jrr.score(QUERY, DOCS[0])) < 5e-4
        got, want = rr.rerank(QUERY, DOCS), jrr.rerank(QUERY, DOCS)
        assert [r.index for r in got] == [r.index for r in want]
        assert [r.text for r in got] == [DOCS[r.index] for r in got]
        assert [r.index for r in rr.rerank_top_k(QUERY, DOCS, 2)] == \
            [r.index for r in jrr.rerank_top_k(QUERY, DOCS, 2)]
        # midway between two scores, so a last-bit difference cannot cross it
        threshold = float(np.mean(sorted(r.score for r in got)[1:3]))
        assert [r.index for r in rr.rerank_with_threshold(QUERY, DOCS, threshold)] == \
            [r.index for r in jrr.rerank_with_threshold(QUERY, DOCS, threshold)]
        assert rr.rerank(QUERY, []) == []

    def test_long_pair_lists_are_chunked(self, dirs, monkeypatch):
        ce = tem.CrossEncoder(dirs["cross"], device="cpu")
        pairs = [(QUERY, doc) for doc in DOCS]
        whole = ce.predict_pairs(pairs)
        monkeypatch.setattr(tem.CrossEncoder, "MAX_PAIR_BATCH", 2)
        np.testing.assert_allclose(ce.predict_pairs(pairs), whole, atol=1e-6)


# the classification-head layouts of the detection cascade, in its order:
# kind -> {tensor name prefix: (out features, has bias)}
_HEADS = {
    "classification_head": {"classification_head.dense": (32, True),
                            "classification_head.out_proj": (3, True)},
    "classifier_dense": {"classifier.dense": (32, True),
                         "classifier.out_proj": (3, True)},
    "pre_classifier": {"pre_classifier": (32, True), "classifier": (3, True)},
    "bert_pooler": {"bert.pooler.dense": (32, True), "classifier": (3, True)},
    "plain": {"classifier": (3, False)},
    "none": {},
}


def _head_dir(d, kind):
    """A tiny BERT encoder (unprefixed names) with one head layout."""
    from transformers import BertConfig, BertModel
    from safetensors.torch import save_file
    d.mkdir(parents=True, exist_ok=True)
    vocab = build_word_tokenizer(d / "tokenizer.json")
    config = BertConfig(vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=64,
                        max_position_embeddings=64, pad_token_id=0,
                        id2label={0: "a", 1: "b", 2: "c"})
    torch.manual_seed(11)
    sd = {k: v.contiguous() for k, v in BertModel(config).state_dict().items()}
    g = torch.Generator().manual_seed(12)
    for name, (out, bias) in _HEADS[kind].items():
        sd[f"{name}.weight"] = torch.randn(out, 32, generator=g) * 0.3
        if bias:
            sd[f"{name}.bias"] = torch.randn(out, generator=g) * 0.1
    save_file(sd, str(d / "model.safetensors"))
    (d / "config.json").write_text(json.dumps(config.to_dict()))


@pytest.mark.parametrize("kind,spec", [
    ("classification_head", ("pre_classifier", "tanh")),
    ("classifier_dense", ("pre_classifier", "tanh")),
    ("pre_classifier", ("pre_classifier", "relu")),
    ("bert_pooler", ("pooler", "tanh")),
    ("plain", ("plain", "none"))])
def test_head_kinds_match_jax(tmp_path, kind, spec):
    _head_dir(tmp_path, kind)
    clf = tem.SequenceClassifier(tmp_path, device="cpu")
    jclf = jem.SequenceClassifier(tmp_path)
    assert (clf.head.kind, clf.head.activation) == spec == \
        (jclf.head.kind, jclf.head.activation)
    assert clf.head.num_classes == 3 and clf.labels == ["a", "b", "c"]
    got, want = clf.predict_logits(TEXTS), jclf.predict_logits(TEXTS)
    np.testing.assert_allclose(got, want, atol=5e-4)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert clf.predict_logits([]).shape == (0, 3)


def test_no_head_is_refused(tmp_path):
    _head_dir(tmp_path, "none")
    with pytest.raises(WeightLoadError):
        tem.SequenceClassifier(tmp_path, device="cpu")
    with pytest.raises(WeightLoadError):
        tem.CrossEncoder(tmp_path, device="cpu")


@pytest.mark.parametrize("task", [Embedder, Classifier, Reranker])
def test_device_none_without_a_card_raises(dirs, monkeypatch, task):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = {Embedder: "bert", Classifier: "sentiment", Reranker: "cross"}[task]
    with pytest.raises(InvalidConfigError, match="no CUDA device"):
        task(str(dirs[d]))
    with pytest.raises(InvalidConfigError, match="no CUDA device"):
        tem.SentenceEncoder(dirs["bert"], device=None)


@pytest.mark.parametrize("task", [Embedder, Classifier, Reranker])
def test_data_parallel_is_not_ported(dirs, task):
    """dp = 2 outside a process group of 2 ranks raises and names the
    launcher (tests/test_torch_parallel_serving.py runs dp inside one)."""
    d = {Embedder: "bert", Classifier: "sentiment", Reranker: "cross"}[task]
    with pytest.raises(InvalidConfigError, match=r"dp=2 .*torchrun --nproc-per-node 2"):
        task(str(dirs[d]), device="cpu", dp=2)


def test_f32_on_request_and_bf16_by_name(dirs):
    """dtype names resolve as in the JAX package; the encoder takes f32 and
    bf16 on any device (it has no kernel that needs bf16)."""
    enc = tem.SentenceEncoder(dirs["bert"], dtype="bf16", device="cpu")
    assert enc.params["layers"]["q"]["w"].dtype == torch.bfloat16
    assert enc.encode_batch(TEXTS).dtype == np.float32
    enc32 = tem.SentenceEncoder(dirs["bert"], dtype="f32", device="cpu")
    cos = (enc.encode_batch(TEXTS) * enc32.encode_batch(TEXTS)).sum(-1)
    assert (cos > 0.99).all()
