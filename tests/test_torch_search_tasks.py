"""The port's Indexer and Searcher task APIs (and /v1/search) against the JAX
package's, on the CPU, in f32.

Both packages index the same folder of documents with the same tiny BERT
(tests/helpers.py's tiny_bert_dir) and search it with and without a tiny
cross-encoder reranker; the port runs with `device="cpu"`. The stored
embeddings are held within the encoder tests' atol 2e-4 / rtol 1e-3; docs,
metadata and manifests exactly (chunk ids are time-based and not stored);
result ids, texts and metadata exactly in every mode, semantic and hybrid
scores within 1e-5 and rerank scores within the cross-encoder tests' atol
5e-4. Also `Indexer.add` onto an existing index, the progress sequence,
cancellation, and /v1/search on the port's server against the JAX server's.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

from helpers import VOCAB_WORDS, tiny_bert_dir

from kjarni_tpu import serve as jserve
from kjarni_tpu.rag.index import IndexReader as JaxReader
from kjarni_tpu.tasks.indexer import Indexer as JaxIndexer
from kjarni_tpu.tasks.searcher import SearchOptions as JaxOptions
from kjarni_tpu.tasks.searcher import Searcher as JaxSearcher
from kjarni_tpu_torch import serve as tserve
from kjarni_tpu_torch.core.cancellation import CancellationToken
from kjarni_tpu_torch.core.errors import CancelledError
from kjarni_tpu_torch.rag.index import MANIFEST, IndexReader, MetadataFilter
from kjarni_tpu_torch.rag.progress import ProgressStage
from kjarni_tpu_torch.tasks.indexer import Indexer
from kjarni_tpu_torch.tasks.searcher import SearchOptions, Searcher

QUERIES = ["keeping data safe", "i love this product", "the doctor and the nurse"]
CHUNKS = dict(chunk_size=120, chunk_overlap=30, batch_size=8)
SCORE_ATOL = 1e-5
RERANK_ATOL = 5e-4


def _write_docs(root, n, seed):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        paras = [" ".join(rng.choice(VOCAB_WORDS, rng.integers(4, 30)))
                 for _ in range(rng.integers(1, 5))]
        (root / f"doc{i:02d}.{'md' if i % 2 else 'txt'}").write_text("\n\n".join(paras))
    return root


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("search_tasks")
    tiny_bert_dir(base / "model", seed=9)
    tiny_bert_dir(base / "ce", num_labels=1, seed=10)
    _write_docs(base / "docs", 12, seed=1)
    _write_docs(base / "more", 5, seed=2)
    return base


@pytest.fixture(scope="module")
def indexes(dirs):
    """The same folder indexed by each package (one segment)."""
    out = {}
    for name, cls, kw in (("port", Indexer, dict(device="cpu")), ("jax", JaxIndexer, {})):
        idx = cls(str(dirs / "model"), quiet=True, **CHUNKS, **kw)
        stats = idx.create(dirs / f"idx_{name}", [dirs / "docs"])
        out[name] = (dirs / f"idx_{name}", stats)
    return out


def _same_results(got, want, atol=SCORE_ATOL):
    assert [(r.document_id, r.text, r.metadata) for r in got] == \
        [(r.document_id, r.text, r.metadata) for r in want]
    np.testing.assert_allclose([r.score for r in got], [r.score for r in want],
                               atol=atol, rtol=0)


def _segments(root):
    m = json.loads((root / MANIFEST).read_text())
    return m, [root / s["id"] for s in m["segments"]]


def test_index_contents_equal_jax(indexes):
    (tp, ts), (jp, js) = indexes["port"], indexes["jax"]
    assert (ts.documents, ts.chunks, ts.bytes) == (js.documents, js.chunks, js.bytes)
    assert ts.documents == 12 and ts.chunks > 16
    (tm, tsegs), (jm, jsegs) = _segments(tp), _segments(jp)
    assert tm == jm and len(tsegs) == 1
    for a, b in zip(tsegs, jsegs):
        for f in ("docs.json", "meta.json", "bm25.json"):
            assert (a / f).read_text() == (b / f).read_text(), f
        np.testing.assert_allclose(np.load(a / "embeddings.npy"),
                                   np.load(b / "embeddings.npy"), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("mode", ["semantic", "keyword", "hybrid"])
@pytest.mark.parametrize("rerank", [False, True], ids=["plain", "rerank"])
def test_search_equals_jax(dirs, indexes, mode, rerank):
    ce = str(dirs / "ce") if rerank else None
    t = Searcher(str(dirs / "model"), reranker_model=ce, device="cpu", quiet=True)
    j = JaxSearcher(str(dirs / "model"), reranker_model=ce, quiet=True)
    # the JAX index through both searchers, and each package's own index
    for q in QUERIES:
        want = j.search(indexes["jax"][0], q, mode=mode, top_k=5)
        assert want
        for idx in (indexes["jax"][0], indexes["port"][0]):
            _same_results(t.search(idx, q, mode=mode, top_k=5), want,
                          RERANK_ATOL if rerank else SCORE_ATOL)
    if rerank:
        scores = [r.score for r in want]
        assert scores == sorted(scores, reverse=True)


def test_search_options_equal_jax(dirs, indexes):
    t = Searcher(str(dirs / "model"), reranker_model=str(dirs / "ce"), device="cpu",
                 quiet=True)
    j = JaxSearcher(str(dirs / "model"), reranker_model=str(dirs / "ce"), quiet=True)
    src = str(dirs / "docs" / "doc03.md")
    from kjarni_tpu.rag.index import MetadataFilter as JaxFilter
    for mode in ("semantic", "keyword", "hybrid"):
        for flt, min_score in ((("source", src), None), (("must_not", "chunk_index", "0"), 0.0)):
            tf, jf = MetadataFilter(), JaxFilter()
            getattr(tf, flt[0])(*flt[1:])
            getattr(jf, flt[0])(*flt[1:])
            to = SearchOptions(mode=mode, top_k=4, rerank=False, min_score=min_score, filter=tf)
            jo = JaxOptions(mode=mode, top_k=4, rerank=False, min_score=min_score, filter=jf)
            _same_results(t.search_with_options(indexes["port"][0], QUERIES[0], to),
                          j.search_with_options(indexes["jax"][0], QUERIES[0], jo))


def test_add_onto_an_existing_index_equals_jax(dirs, tmp_path):
    out = {}
    for name, cls, kw in (("port", Indexer, dict(device="cpu")), ("jax", JaxIndexer, {})):
        idx = cls(str(dirs / "model"), quiet=True, **CHUNKS, **kw)
        root = tmp_path / name
        idx.create(root, [dirs / "docs" / "doc00.txt", dirs / "docs" / "doc01.md"])
        stats = idx.add(root, [dirs / "more"])
        out[name] = (root, stats)
    (tp, ts), (jp, js) = out["port"], out["jax"]
    assert (ts.documents, ts.chunks, ts.bytes) == (js.documents, js.chunks, js.bytes)
    (tm, tsegs), (jm, jsegs) = _segments(tp), _segments(jp)
    assert tm == jm and len(tsegs) == 2
    assert tm["total_docs"] == sum(s["num_docs"] for s in tm["segments"])
    for a, b in zip(tsegs, jsegs):
        assert (a / "docs.json").read_text() == (b / "docs.json").read_text()
    t, j = IndexReader.open(tp, "cpu"), JaxReader.open(jp)
    assert len(t) == len(j) == tm["total_docs"]
    q = np.load(tsegs[1] / "embeddings.npy")[0]
    _same_results(t.search_semantic(q, 6), j.search_semantic(q, 6))
    _same_results(t.search_hybrid("data safe", q, 6), j.search_hybrid("data safe", q, 6))
    assert t.search_semantic(q, 1)[0].document_id == tm["segments"][0]["num_docs"]
    # a fresh path: add() creates the index
    Indexer(str(dirs / "model"), quiet=True, device="cpu", **CHUNKS).add(
        tmp_path / "fresh", [dirs / "more"])
    assert len(IndexReader.open(tmp_path / "fresh", "cpu")) == \
        json.loads((jp / MANIFEST).read_text())["segments"][1]["num_docs"]


def test_progress_sequence_equals_jax(dirs, tmp_path):
    seen = {"port": [], "jax": []}
    Indexer(str(dirs / "model"), quiet=True, device="cpu", **CHUNKS).create(
        tmp_path / "p", [dirs / "docs"], progress=seen["port"].append)
    JaxIndexer(str(dirs / "model"), quiet=True, **CHUNKS).create(
        tmp_path / "j", [dirs / "docs"], progress=seen["jax"].append)
    rows = {k: [(int(p.stage), p.current, p.total, p.message) for p in v]
            for k, v in seen.items()}
    assert rows["port"] == rows["jax"]
    stages = [r[0] for r in rows["port"]]
    assert stages[0] == ProgressStage.SCANNING and stages[-1] == ProgressStage.COMMITTING
    assert stages == sorted(stages) and stages.count(ProgressStage.EMBEDDING) > 1


def test_cancellation_raises_and_commits_nothing(dirs, tmp_path):
    tok = CancellationToken()
    tok.cancel()
    idx = Indexer(str(dirs / "model"), quiet=True, device="cpu", **CHUNKS)
    with pytest.raises(CancelledError):
        idx.create(tmp_path / "c", [dirs / "docs"], cancellation=tok)
    assert not (tmp_path / "c" / MANIFEST).exists()
    idx.create(tmp_path / "d", [dirs / "docs" / "doc00.txt"])
    with pytest.raises(CancelledError):
        idx.add(tmp_path / "d", [dirs / "more"], cancellation=tok)
    assert len(IndexReader.open(tmp_path / "d", "cpu")) == \
        json.loads((tmp_path / "d" / MANIFEST).read_text())["total_docs"]


def _post(base, body):
    req = urllib.request.Request(base + "/v1/search", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_v1_search_equals_jax_server(dirs, indexes):
    models = {"search": str(dirs / "model")}
    servers = []
    for mod, kw in ((jserve, {}), (tserve, dict(device="cpu"))):
        srv = mod.KjarniHTTPServer(("127.0.0.1", 0), mod.make_handler(mod._Engine(models, **kw)))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
    try:
        jb, tb = (f"http://127.0.0.1:{s.server_port}" for s in servers)
        for body in ({"index": str(indexes["port"][0]), "query": QUERIES[0]},
                     {"index": str(indexes["jax"][0]), "query": QUERIES[1],
                      "mode": "semantic", "top_k": 3},
                     {"index": str(indexes["port"][0]), "query": QUERIES[2],
                      "mode": "keyword", "top_k": 20}):
            (jc, jo), (tc, to) = _post(jb, body), _post(tb, body)
            assert tc == jc == 200 and to["results"]
            assert [(r["text"], r["metadata"]) for r in to["results"]] == \
                [(r["text"], r["metadata"]) for r in jo["results"]]
            np.testing.assert_allclose([r["score"] for r in to["results"]],
                                       [r["score"] for r in jo["results"]],
                                       atol=SCORE_ATOL, rtol=0)
        code, out = _post(tb, {"index": str(dirs / "none"), "query": "x"})
        assert code == _post(jb, {"index": str(dirs / "none"), "query": "x"})[0] == 400
        assert "no index manifest" in out["error"]
    finally:
        for s in servers:
            s.shutdown()
