"""BM25 + hybrid fusion tests (parity: reference hybrid_search.py suites)."""

import numpy as np
import pytest

from fastpyvectordb_jax import CollectionConfig, Filter
from fastpyvectordb_jax.embeddings import HashingEmbedder
from fastpyvectordb_jax.hybrid import BM25Config, BM25Index, HybridCollection

DOCS = {
    "d1": "machine learning with neural networks",
    "d2": "deep neural networks for vision",
    "d3": "cooking pasta with tomato sauce",
    "d4": "the stock market crashed today",
    "d5": "neural style transfer for images",
}


@pytest.fixture()
def bm25():
    idx = BM25Index()
    for k, v in DOCS.items():
        idx.add_document(k, v)
    return idx


class TestBM25:
    def test_exact_term_ranks_first(self, bm25):
        hits = bm25.search("pasta sauce", k=3)
        assert hits[0][0] == "d3" and hits[0][1] > 0

    def test_common_term_ranks_all_matching(self, bm25):
        ids = [h[0] for h in bm25.search("neural networks", k=5)]
        assert set(ids) == {"d1", "d2", "d5"}
        # doc with both terms beats docs with one
        assert ids[0] in ("d1", "d2")

    def test_unknown_term_empty(self, bm25):
        assert bm25.search("xylophone", k=3) == []

    def test_idf_rare_beats_common(self, bm25):
        assert bm25.idf("pasta") > bm25.idf("neural")
        assert bm25.idf("neverseen") == 0.0

    def test_remove_document(self, bm25):
        assert bm25.remove_document("d3")
        assert not bm25.remove_document("d3")
        assert bm25.search("pasta", k=3) == []
        assert bm25.n_docs == 4

    def test_score_matches_formula(self, bm25):
        import math
        k1, b = bm25.config.k1, bm25.config.b
        # "pasta" appears once in d3 (length 5)
        df, n = 1, 5
        idf = math.log((n - df + 0.5) / (df + 0.5) + 1)
        dl, avgdl = 5, bm25.avg_doc_len
        tf = 1
        want = idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl / avgdl))
        assert bm25.score("pasta", "d3") == pytest.approx(want, rel=1e-9)

    def test_serialization_roundtrip(self, bm25):
        idx2 = BM25Index.from_dict(bm25.to_dict())
        assert idx2.search("neural networks", 5) == bm25.search(
            "neural networks", 5)
        assert idx2.avg_doc_len == bm25.avg_doc_len


@pytest.fixture()
def hybrid(tmp_path):
    emb = HashingEmbedder(128)
    col = HybridCollection(
        CollectionConfig(name="h", dimensions=128, metric="cosine"),
        base_path=tmp_path / "h", text_fields=["text"])
    ids = list(DOCS)
    vecs = np.stack([emb.embed(DOCS[i]) for i in ids])
    col.insert_batch(vecs, ids, [{"text": DOCS[i], "n": j}
                                 for j, i in enumerate(ids)])
    return col, emb


class TestHybridCollection:
    def test_keyword_search(self, hybrid):
        col, _ = hybrid
        hits = col.keyword_search("tomato pasta", k=2)
        assert hits[0].id == "d3"

    def test_keyword_search_with_filter(self, hybrid):
        col, _ = hybrid
        hits = col.keyword_search("neural", k=5, filter=Filter.gt("n", 1))
        assert {h.id for h in hits} == {"d5"}

    def test_hybrid_fusion_beats_single_system(self, hybrid):
        col, emb = hybrid
        q = "neural networks for images"
        res = col.hybrid_search(emb.embed(q), q, k=3, alpha=0.5)
        assert res[0].id in ("d5", "d2")
        assert all(0 <= r.vector_score <= 1 and 0 <= r.keyword_score <= 1
                   for r in res)
        # fused score is the declared blend
        for r in res:
            assert r.score == pytest.approx(
                0.5 * r.vector_score + 0.5 * r.keyword_score, abs=1e-9)

    def test_alpha_extremes(self, hybrid):
        col, emb = hybrid
        q = "pasta"
        kw_only = col.hybrid_search(emb.embed(q), q, k=1, alpha=0.0)
        assert kw_only[0].id == "d3"
        vec_only = col.hybrid_search(emb.embed(DOCS["d4"]), q, k=1, alpha=1.0)
        assert vec_only[0].id == "d4"

    def test_weight_override(self, hybrid):
        col, emb = hybrid
        res = col.hybrid_search(emb.embed("pasta"), "pasta", k=1,
                                vector_weight=0.0, keyword_weight=1.0)
        assert res[0].id == "d3" and res[0].score == res[0].keyword_score

    def test_delete_removes_from_bm25(self, hybrid):
        col, _ = hybrid
        col.delete("d3")
        assert col.keyword_search("pasta", k=3) == []

    def test_update_metadata_reindexes(self, hybrid):
        col, _ = hybrid
        col.update_metadata("d4", {"text": "quantum computing breakthrough"},
                            merge=False)
        hits = col.keyword_search("quantum", k=2)
        assert hits and hits[0].id == "d4"

    def test_persistence_roundtrip(self, hybrid, tmp_path):
        col, emb = hybrid
        col.save()
        col2 = HybridCollection(
            CollectionConfig(name="h", dimensions=128),
            base_path=col.base_path)
        assert col2.text_fields == ["text"]
        hits = col2.keyword_search("pasta", k=1)
        assert hits[0].id == "d3"
        res = col2.hybrid_search(emb.embed("neural"), "neural", k=2)
        assert res


def test_wal_recovery_keeps_bm25_for_replayed_docs(tmp_path):
    """BM25 snapshot must load BEFORE WAL replay: documents recovered
    from the WAL stay keyword-searchable after a crash."""
    import numpy as np
    from fastpyvectordb_jax import CollectionConfig
    from fastpyvectordb_jax.hybrid import HybridCollection

    cfg = lambda: CollectionConfig(name="h", dimensions=8,
                                   durability="wal")
    rng = np.random.default_rng(0)
    col = HybridCollection(cfg(), base_path=tmp_path / "h",
                           text_fields=["text"])
    col.insert(rng.standard_normal(8).astype(np.float32), "a",
               {"text": "alpha document about pelicans"})
    col.save()  # snapshot covers A
    col.insert(rng.standard_normal(8).astype(np.float32), "b",
               {"text": "beta document about walruses"})
    # crash: no save — B lives only in the WAL
    col2 = HybridCollection(cfg(), base_path=tmp_path / "h",
                            text_fields=["text"])
    assert col2.count() == 2
    hits = col2.keyword_search("walruses", k=3)
    assert any(h.id == "b" for h in hits), [h.id for h in hits]
    hits = col2.keyword_search("pelicans", k=3)
    assert any(h.id == "a" for h in hits)


def test_update_metadata_empty_text_unindexes():
    import numpy as np
    from fastpyvectordb_jax import CollectionConfig
    from fastpyvectordb_jax.hybrid import HybridCollection
    col = HybridCollection(CollectionConfig(name="u", dimensions=4),
                           text_fields=["title"])
    col.insert(np.ones(4, np.float32), "x", {"title": "ancient scrolls"})
    assert col.keyword_search("scrolls", k=2)
    col.update_metadata("x", {"title": ""}, merge=False)
    assert not col.keyword_search("scrolls", k=2)


def test_hybrid_search_dot_metric_normalized():
    import numpy as np
    from fastpyvectordb_jax import CollectionConfig
    from fastpyvectordb_jax.hybrid import HybridCollection
    col = HybridCollection(CollectionConfig(name="d", dimensions=4,
                                            metric="ip"),
                           text_fields=["text"])
    col.insert_batch(np.eye(4, dtype=np.float32) * [[3], [2], [1], [0.5]],
                     ["a", "b", "c", "d"],
                     [{"text": t} for t in ("aa", "bb", "cc", "dd")])
    res = col.hybrid_search(np.ones(4, np.float32), "aa", k=4, alpha=0.5)
    # vector similarities must be in [0, 1] with the best hit at 1
    vs = {r.id: r.vector_score for r in res}
    assert all(0.0 <= v <= 1.0 for v in vs.values()), vs
    assert res[0].id == "a"  # highest inner product AND the keyword hit


def test_native_blob_persistence(tmp_path):
    """Native BM25 persists as a binary state blob (no text replay on
    load) and reloads bit-identically; a python-impl reload of the same
    container decodes the blob host-side."""
    from fastpyvectordb_jax import native
    if not native.available():
        pytest.skip("no C++ toolchain")
    from fastpyvectordb_jax.core.types import CollectionConfig
    from fastpyvectordb_jax.persist.format import load_container

    cfg = lambda: CollectionConfig(name="h", dimensions=8, metric="cosine")  # noqa: E731
    col = HybridCollection(cfg(), base_path=tmp_path / "h",
                           bm25_impl="native")
    rng = np.random.default_rng(0)
    texts = ["neural networks win", "pasta sauce recipe",
             "market crash report", "vision transformers"]
    col.insert_batch(rng.standard_normal((4, 8)).astype(np.float32),
                     [f"d{i}" for i in range(4)],
                     [{"text": t} for t in texts])
    col.save()

    c = load_container(tmp_path / "h" / "bm25.fpvt")
    assert c.read("bm25").get("blob") and "bm25_blob" in c.keys()

    col2 = HybridCollection(cfg(), base_path=tmp_path / "h",
                            bm25_impl="native")
    assert col2._bm25.search("pasta recipe", 2) == \
        col._bm25.search("pasta recipe", 2)

    col3 = HybridCollection(cfg(), base_path=tmp_path / "h",
                            bm25_impl="python")
    a = col._bm25.search("market crash", 2)
    b = col3._bm25.search("market crash", 2)
    assert [x[0] for x in a] == [x[0] for x in b]
