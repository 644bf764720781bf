"""The port's search primitives and RAG index against the JAX package's, on
the CPU.

The same seeded numpy inputs go through `kjarni_tpu.search` / `kjarni_tpu.rag`
and `kjarni_tpu_torch.search` / `kjarni_tpu_torch.rag`. The host modules the
port copies (tokenize, BM25, RRF, the splitter, the loader, progress) must
give equal values. VectorStore is held on both of its branches: numpy below
4,096 rows, and the device branch at or above it (the port's `torch.mv` on
`device="cpu"`, the JAX package's `jnp` matmul on its CPU): ids exactly,
scores within 1e-5. An index written by either package, over several
segments, is read by the other with equal results in every mode, and so is
a SearchIndex file.
"""

import numpy as np
import pytest

from kjarni_tpu.rag import index as jindex
from kjarni_tpu.rag import loader as jloader
from kjarni_tpu.rag import progress as jprogress
from kjarni_tpu.rag import search_index as jsi
from kjarni_tpu.rag import splitter as jsplitter
from kjarni_tpu.search import bm25 as jbm25
from kjarni_tpu.search import hybrid as jhybrid
from kjarni_tpu.search import types as jtypes
from kjarni_tpu.search import vector as jvector
from kjarni_tpu_torch.core.errors import InvalidConfigError
from kjarni_tpu_torch.rag import index as tindex
from kjarni_tpu_torch.rag import loader as tloader
from kjarni_tpu_torch.rag import progress as tprogress
from kjarni_tpu_torch.rag import search_index as tsi
from kjarni_tpu_torch.rag import splitter as tsplitter
from kjarni_tpu_torch.search import bm25 as tbm25
from kjarni_tpu_torch.search import hybrid as thybrid
from kjarni_tpu_torch.search import types as ttypes
from kjarni_tpu_torch.search import vector as tvector

WORDS = ["data", "safe", "keeping", "quality", "service", "love", "product", "doctor",
         "nurse", "physician", "great", "terrible", "purchase", "best", "worst", "hello",
         "world", "mondays", "made", "ever", "x", "a1", "b2", "the", "and"]
SCORE_ATOL = 1e-5


def _texts(n, seed, lo=3, hi=14):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, rng.integers(lo, hi + 1)))
            for _ in range(n)]


def _embeddings(n, dim, seed):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)


def _same_scored(got, want):
    """(id, score) lists: ids exactly, scores within SCORE_ATOL."""
    assert [i for i, _ in got] == [i for i, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               atol=SCORE_ATOL, rtol=0)


def _same_results(got, want):
    """SearchResult lists: ids, texts and metadata exactly, scores within
    SCORE_ATOL."""
    assert [(r.document_id, r.text, r.metadata) for r in got] == \
        [(r.document_id, r.text, r.metadata) for r in want]
    np.testing.assert_allclose([r.score for r in got], [r.score for r in want],
                               atol=SCORE_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the copied host modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", ["Hello World", "I am a test", "", "   ",
                                  "hello, world! how are you?", "Ünïcode 42 ab_cd x9",
                                  *_texts(4, seed=1)])
def test_tokenize_equals_jax(text):
    assert tbm25.tokenize(text) == jbm25.tokenize(text)


def test_bm25_scores_and_dict_form_equal_jax():
    docs = _texts(60, seed=2)
    t, j = tbm25.Bm25Index(), jbm25.Bm25Index()
    for i, d in enumerate(docs):
        t.add_document(i, d)
        j.add_document(i, d)
    for q in ["data safe", "keeping quality service", "nothing here", "the the", ""]:
        assert t.search(q, 10) == j.search(q, 10)
    assert t.to_dict() == j.to_dict()
    # each package reads the other's dict form
    assert tbm25.Bm25Index.from_dict(j.to_dict()).search("love product", 7) == \
        j.search("love product", 7)
    assert jbm25.Bm25Index.from_dict(t.to_dict()).search("love product", 7) == \
        t.search("love product", 7)
    assert tbm25.Bm25Params() == tbm25.Bm25Params(**vars(jbm25.Bm25Params()))


def test_rrf_equals_jax():
    rng = np.random.default_rng(3)
    kw = [(int(i), float(rng.random())) for i in rng.permutation(40)[:15]]
    sem = [(int(i), float(rng.random())) for i in rng.permutation(40)[:15]]
    for limit in (1, 5, 30):
        assert thybrid.hybrid_search(kw, sem, limit) == jhybrid.hybrid_search(kw, sem, limit)
        assert tsi.hybrid_search_weighted(kw, sem, limit, 0.3, 0.7) == \
            jsi.hybrid_search_weighted(kw, sem, limit, 0.3, 0.7)
    assert thybrid.RRF_K == jhybrid.RRF_K == 60.0


@pytest.mark.parametrize("chunk_size,overlap", [(1000, 200), (50, 10), (40, 0), (7, 3)])
def test_splitter_chunks_equal_jax(chunk_size, overlap):
    text = "\n\n".join(_texts(12, seed=4, lo=2, hi=30)) + "\n\n" + "z" * 130
    t = tsplitter.TextSplitter(tsplitter.SplitterConfig(chunk_size, overlap))
    j = jsplitter.TextSplitter(jsplitter.SplitterConfig(chunk_size, overlap))
    assert t.split(text) == j.split(text)
    assert t.split_with_metadata(text, {"source": "s"}) == \
        j.split_with_metadata(text, {"source": "s"})
    assert tsplitter.SplitterConfig.with_chunk_size(chunk_size) == \
        tsplitter.SplitterConfig(**vars(jsplitter.SplitterConfig.with_chunk_size(chunk_size)))
    with pytest.raises(ValueError):
        tsplitter.TextSplitter(tsplitter.SplitterConfig(10, 10))


def _doc_tree(root):
    (root / "sub").mkdir(parents=True)
    (root / ".hidden").mkdir()
    for i, text in enumerate(_texts(6, seed=5, lo=20, hi=90)):
        (root / ("sub" if i % 2 else ".") / f"doc{i}.{'md' if i % 3 else 'txt'}"
         ).write_text(text.replace(" data ", "\n\n"))
    (root / "image.png").write_bytes(b"\x89PNG")
    (root / ".hidden" / "secret.txt").write_text("hidden words")
    (root / "skip_me.txt").write_text("excluded words")
    return root


@pytest.mark.parametrize("kw", [{}, dict(recursive=False), dict(extensions=["md"]),
                                dict(exclude_patterns=["skip_me"], include_hidden=True)])
def test_loader_chunks_and_metadata_equal_jax(tmp_path, kw):
    root = _doc_tree(tmp_path / "docs")
    splitter = dict(chunk_size=120, chunk_overlap=30)
    t = tloader.DocumentLoader(tloader.LoaderConfig(
        splitter=tsplitter.SplitterConfig(**splitter), **kw))
    j = jloader.DocumentLoader(jloader.LoaderConfig(
        splitter=jsplitter.SplitterConfig(**splitter), **kw))
    tc, jc = t.load_paths([root, root / "doc0.txt"]), j.load_paths([root, root / "doc0.txt"])
    assert len(tc) == len(jc) > 0
    assert [(c.text, c.metadata.to_dict()) for c in tc] == \
        [(c.text, c.metadata.to_dict()) for c in jc]
    assert tloader.TEXT_EXTENSIONS == jloader.TEXT_EXTENSIONS


def test_types_and_progress_equal_jax():
    for s in ("keyword", "BM25", "semantic", "vector", "Hybrid"):
        assert ttypes.SearchMode.parse(s).value == jtypes.SearchMode.parse(s).value
    with pytest.raises(ValueError, match="Unknown search mode"):
        ttypes.SearchMode.parse("fuzzy")
    md = dict(source="a.txt", chunk_index=2, total_chunks=5, page=1,
              sections=["A", "B"], custom={"k": "v"})
    assert ttypes.ChunkMetadata(**md).to_dict() == jtypes.ChunkMetadata(**md).to_dict()
    for name, args in [("scanning", (3,)), ("loading", (4, 9)), ("embedding", (5, 9)),
                       ("writing", (6,)), ("committing", ())]:
        t, j = getattr(tprogress.Progress, name)(*args), getattr(jprogress.Progress, name)(*args)
        assert (int(t.stage), t.current, t.total, t.message) == \
            (int(j.stage), j.current, j.total, j.message)
    assert [s.name for s in tprogress.ProgressStage] == \
        [s.name for s in jprogress.ProgressStage]


# ---------------------------------------------------------------------------
# VectorStore, both branches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [500, 5000], ids=["numpy_branch", "device_branch"])
def test_vector_store_search_equals_jax(n):
    emb = _embeddings(n, 32, seed=6)
    queries = _embeddings(4, 32, seed=7)
    t, j = tvector.VectorStore(emb, device="cpu"), jvector.VectorStore(emb)
    assert (n >= tvector._DEVICE_MIN_ROWS) == (n >= jvector._DEVICE_MIN_ROWS)
    # the whole ranking (limit > n) on the numpy branch, whose arithmetic is
    # the JAX package's own; the device branch rounds in another order, so
    # rows whose scores lie within 1e-7 of each other may swap deep down
    limits = (1, 10, 100) + ((n + 3,) if n < tvector._DEVICE_MIN_ROWS else ())
    for q in queries:
        for limit in limits:
            _same_scored(t.search(q, limit), j.search(q, limit))
        _same_scored(t.search_with_threshold(q, 50, 0.2),
                     j.search_with_threshold(q, 50, 0.2))
    assert (t._device_matrix is not None) == (n >= tvector._DEVICE_MIN_ROWS)
    assert t.search(queries[0][:5], 3) == j.search(queries[0][:5], 3) == []


@pytest.mark.parametrize("n", [500, 5000], ids=["numpy_branch", "device_branch"])
def test_vector_store_normalize_and_add_after_search(n):
    """normalize and add drop the device copy: a row added after a search,
    made to be the query's top-1, is found (a stale cached matrix misses it)."""
    emb = _embeddings(n, 32, seed=8) * 3.0
    q = _embeddings(1, 32, seed=9)[0]
    t, j = tvector.VectorStore(emb, device="cpu"), jvector.VectorStore(emb)
    _same_scored(t.search(q, 5), j.search(q, 5))
    t.normalize()
    j.normalize()
    np.testing.assert_array_equal(t.matrix, j.matrix)
    _same_scored(t.search(q, 5), j.search(q, 5))
    assert t.add(q * 2.0) == j.add(q * 2.0) == n
    got, want = t.search(q, 5), j.search(q, 5)
    _same_scored(got, want)
    assert got[0][0] == n and abs(got[0][1] - 1.0) < SCORE_ATOL
    assert t.add_batch(emb[:2]) == j.add_batch(emb[:2]) == [n + 1, n + 2]
    _same_scored(t.search(emb[0], 3), j.search(emb[0], 3))


def test_vector_store_helpers_equal_jax():
    a, b = _embeddings(2, 16, seed=10)
    for fn in ("cosine_similarity", "dot_product", "euclidean_distance"):
        assert getattr(tvector.VectorStore, fn)(a, b) == getattr(jvector.VectorStore, fn)(a, b)
        assert getattr(tvector.VectorStore, fn)(a, b[:3]) == \
            getattr(jvector.VectorStore, fn)(a, b[:3])
    t = tvector.VectorStore(dimension=16, device="cpu")
    j = jvector.VectorStore(dimension=16)
    assert t.is_empty and t.search(a, 3) == j.search(a, 3) == []
    with pytest.raises(ValueError):
        t.add(a[:4])
    t.add(a)
    assert t.get(0).tolist() == a.tolist() and t.get(1) is None
    assert t.to_dict() == j.from_dict(t.to_dict()).to_dict()
    assert tvector.VectorStore.from_dict(t.to_dict(), device="cpu").dimension == 16
    with pytest.raises(ValueError, match="2-D"):
        tvector.VectorStore([1.0, 2.0], device="cpu")


def test_vector_store_without_a_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None would run on it")
    with pytest.raises(InvalidConfigError, match="device='cpu'"):
        tvector.VectorStore(_embeddings(3, 4, seed=0))


# ---------------------------------------------------------------------------
# the on-disk index and SearchIndex, across packages
# ---------------------------------------------------------------------------

def _write(mod, root, texts, emb, metas, seg):
    w = mod.IndexWriter.open(root, mod.IndexConfig(model="m", max_docs_per_segment=seg))
    w.add_batch(texts, emb, metas)
    w.commit()


def _filters(mod):
    """No filter, a must term, and a source glob with a must-not term."""
    return [None, mod.MetadataFilter().must("lang", "en"),
            mod.MetadataFilter().source("dir/b*").must_not("lang", "de")]


def _reader(mod, root):
    return mod.IndexReader.open(root, "cpu") if mod is tindex else mod.IndexReader.open(root)


@pytest.mark.parametrize("writer,reader", [(tindex, jindex), (jindex, tindex)],
                         ids=["port_writes", "jax_writes"])
@pytest.mark.parametrize("n,seg", [(30, 7), (4200, 4096)],
                         ids=["numpy_segments", "device_segment"])
def test_index_written_by_one_package_reads_in_the_other(tmp_path, writer, reader, n, seg):
    texts = _texts(n, seed=11)
    emb = _embeddings(n, 24, seed=12)
    metas = [{"source": f"dir/{'a' if i % 3 else 'b'}{i % 5}.txt", "lang": "en" if i % 2 else "de",
              "chunk_index": str(i)} for i in range(n)]
    root = tmp_path / "idx"
    _write(writer, root, texts, emb, metas, seg)
    same = tmp_path / "same"
    _write(reader, same, texts, emb, metas, seg)
    assert (root / "manifest.json").read_text() == (same / "manifest.json").read_text()
    for f in ("docs.json", "meta.json", "bm25.json", "embeddings.npy"):
        assert (root / "segment_000000" / f).read_bytes() == \
            (same / "segment_000000" / f).read_bytes(), f
    got, want = _reader(reader, root), _reader(reader, same)
    ref = _reader(writer, root)
    assert len(got) == len(ref) == n and got.segment_count() == -(-n // seg)
    queries = _embeddings(3, 24, seed=13)
    readers = [(got, reader), (want, reader), (ref, writer)]
    for q, text in zip(queries, ["data safe keeping", "love product", "nurse the"]):
        for k in range(3):
            outs = []
            for r, mod in readers:
                f = _filters(mod)[k]
                outs.append((r.search_semantic(q, 8, f), r.search_keywords(text, 8, f),
                             r.search_hybrid(text, q, 8, f)))
            assert outs[0][0] and outs[0][2]
            for out in outs[1:]:
                for a, b in zip(out, outs[0]):
                    _same_results(a, b)
    gid = n - 1
    assert got.get_document(gid) == ref.get_document(gid) == texts[gid]
    assert got.get_metadata(gid) == ref.get_metadata(gid) == metas[gid]


def test_index_errors_equal_jax(tmp_path):
    from kjarni_tpu_torch.core.errors import IndexError_
    with pytest.raises(IndexError_, match="no index manifest"):
        tindex.IndexReader.open(tmp_path, "cpu")
    w = tindex.IndexWriter.open(tmp_path / "i", tindex.IndexConfig(dimension=4))
    with pytest.raises(IndexError_, match="embedding dim"):
        w.add("x", np.zeros(3, np.float32))
    w.add("x", np.zeros(4, np.float32))
    w.commit()
    with pytest.raises(IndexError_, match="already committed"):
        w.commit()
    with pytest.raises(IndexError_, match="out of range"):
        tindex.IndexReader.open(tmp_path / "i", "cpu")._local(-1)


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_search_index_saved_by_one_package_loads_in_the_other(tmp_path, saver):
    n = 40
    texts = _texts(n, seed=14)
    emb = _embeddings(n, 16, seed=15)
    metas = [{"source": f"s{i % 4}"} for i in range(n)]
    t = tsi.SearchIndex.build(texts, emb, metas, device="cpu")
    j = jsi.SearchIndex.build(texts, emb, metas)
    assert t.to_json() == j.to_json()
    path = tmp_path / "index.json.gz"
    (t if saver == "port" else j).save_to_file(path)
    t2 = tsi.SearchIndex.load_from_file(path, device="cpu")
    j2 = jsi.SearchIndex.load_from_file(path)
    q = _embeddings(1, 16, seed=16)[0]
    for a, b in ((t2, j2), (t, j2)):
        _same_results(a.search_semantic(q, 6), b.search_semantic(q, 6))
        _same_results(a.search_keywords("data safe", 6), b.search_keywords("data safe", 6))
        _same_results(a.search_hybrid("data safe", q, 6), b.search_hybrid("data safe", q, 6))
        _same_results(a.search_hybrid_weighted("love", q, 6, 0.8, 0.2),
                      b.search_hybrid_weighted("love", q, 6, 0.8, 0.2))
    assert t2.remove_by_source("s1") == j2.remove_by_source("s1") == 10
    _same_results(t2.search_semantic(q, 6), j2.search_semantic(q, 6))
    assert len(t2) == len(j2) == 30 and t2.dimension == 16
    assert t2.get_document(29) == j2.get_document(29) and t2.get_document(30) is None
