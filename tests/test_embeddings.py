"""Embedder provider tests (offline providers only)."""

import numpy as np
import pytest

from fastpyvectordb_jax.embeddings import (
    CachedEmbedder,
    HashingEmbedder,
    JaxTransformerEmbedder,
    MockEmbedder,
    get_embedder,
)


def test_mock_deterministic_and_normalized():
    e = MockEmbedder(64)
    a, b = e.embed("hello"), e.embed("hello")
    np.testing.assert_array_equal(a, b)
    assert np.linalg.norm(a) == pytest.approx(1.0, abs=1e-5)
    assert not np.allclose(a, e.embed("other"))
    assert e.embed_batch(["x", "y"]).shape == (2, 64)


def test_hashing_embedder_similarity_ordering():
    e = HashingEmbedder(128)
    a = e.embed("neural networks learn representations")
    b = e.embed("deep neural networks")
    c = e.embed("cooking pasta recipes")
    assert a @ b > a @ c


def test_cached_embedder(tmp_path):
    calls = {"n": 0}

    class Counting(MockEmbedder):
        def embed_batch(self, texts, batch_size=32):
            calls["n"] += len(texts)
            return super().embed_batch(texts, batch_size)

    e = CachedEmbedder(Counting(32), cache_dir=str(tmp_path))
    v1 = e.embed("a")
    v2 = e.embed("a")
    np.testing.assert_array_equal(v1, v2)
    assert calls["n"] == 1
    # batch path partitions cached vs uncached
    out = e.embed_batch(["a", "b", "c"])
    assert calls["n"] == 3 and out.shape == (3, 32)
    # fresh instance reads the disk cache
    e2 = CachedEmbedder(Counting(32), cache_dir=str(tmp_path))
    e2.embed("a")
    assert calls["n"] == 3


def test_jax_transformer_embedder():
    e = JaxTransformerEmbedder(dimensions=48, n_layers=1, n_heads=4,
                               max_len=16)
    out = e.embed_batch(["hello world", "hello world", "different text"])
    assert out.shape == (3, 48)
    np.testing.assert_allclose(out[0], out[1], atol=1e-5)  # deterministic
    assert not np.allclose(out[0], out[2])
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-4)
    # shared-token texts are closer than disjoint ones
    a = e.embed("machine learning rocks")
    b = e.embed("machine learning tools")
    c = e.embed("zebra crossing stripes")
    assert a @ b > a @ c


def test_jax_embedder_save_load(tmp_path):
    e = JaxTransformerEmbedder(dimensions=32, n_layers=1, n_heads=4,
                               max_len=8, seed=3)
    e.save(tmp_path / "enc.fpvt")
    e2 = JaxTransformerEmbedder.load(tmp_path / "enc.fpvt")
    np.testing.assert_allclose(e.embed("same text"), e2.embed("same text"),
                               atol=1e-5)


def test_factory(tmp_path):
    assert get_embedder("mock").model_name.startswith("mock")
    assert get_embedder("hashing").dimensions == 384
    with pytest.raises(ValueError):
        get_embedder("nope")
    cached = get_embedder("mock", cache=True, cache_dir=str(tmp_path))
    assert isinstance(cached, CachedEmbedder)


def test_embedding_collection():
    from fastpyvectordb_jax import Collection, CollectionConfig
    from fastpyvectordb_jax.embeddings import EmbeddingCollection
    ec = EmbeddingCollection(
        Collection(CollectionConfig(name="e", dimensions=64)),
        HashingEmbedder(64))
    ec.add_text("solar panels on rooftops", id="solar")
    ec.add_texts(["wind turbines spin", "tidal energy generators"],
                 ids=["wind", "tidal"], metadatas=[{"k": 1}, {"k": 2}])
    assert ec.count() == 3
    hits = ec.search_text("tidal generators", k=1)
    assert hits[0].id == "tidal" and hits[0].metadata["_text"]
    assert ec.get_text("solar") == "solar panels on rooftops"
    assert ec.get_text("nope") is None
    with pytest.raises(ValueError):
        EmbeddingCollection(
            Collection(CollectionConfig(name="x", dimensions=32)),
            HashingEmbedder(64))


def test_query_timer():
    from fastpyvectordb_jax.profiling import QueryTimer
    t = QueryTimer(capacity=8)
    for _ in range(20):
        with t.measure():
            pass
    s = t.summary()
    assert s["count"] == 20 and s["qps"] > 0
    assert 0 <= s["p50_ms"] <= s["p99_ms"]
    t.reset()
    assert t.summary() == {"count": 0}
