"""Quantizer tests: SQ/BQ/PQ round-trips, distances, recall, persistence."""

import numpy as np
import pytest

from fastpyvectordb_jax import Collection, CollectionConfig
from fastpyvectordb_jax.core.types import DistanceMetric
from fastpyvectordb_jax.quant.binary import BinaryQuantizer
from fastpyvectordb_jax.quant.int4 import Int4Quantizer
from fastpyvectordb_jax.quant.kmeans import assign_chunked, kmeans_fit
from fastpyvectordb_jax.quant.product import ProductQuantizer
from fastpyvectordb_jax.quant.scalar import ScalarQuantizer


def recall_at_k(approx_idx, exact_idx, k):
    hits = 0
    for a, e in zip(approx_idx, exact_idx):
        hits += len(set(a[:k].tolist()) & set(e[:k].tolist()))
    return hits / (len(approx_idx) * k)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    n, d = 2000, 32
    # clustered data so quantizers have structure to exploit
    centers = rng.standard_normal((16, d)).astype(np.float32) * 3
    v = centers[rng.integers(0, 16, n)] + rng.standard_normal(
        (n, d)).astype(np.float32)
    q = centers[rng.integers(0, 16, 8)] + rng.standard_normal(
        (8, d)).astype(np.float32)
    exact = np.argsort(
        np.linalg.norm(v[None, :, :] - q[:, None, :], axis=-1), axis=1)
    return v, q, exact


def test_kmeans_accepts_bf16_corpus(rng):
    """bf16 stores pass their buffer straight into the IVF build
    (ann/ivf.py keeps the storage dtype to avoid a full-corpus f32 copy);
    the Lloyd scan carry must stay f32 for any input dtype."""
    import jax
    import jax.numpy as jnp
    data = jnp.asarray(rng.standard_normal((256, 8)).astype(np.float32),
                       dtype=jnp.bfloat16)
    c = kmeans_fit(data, jax.random.PRNGKey(0), k=8, iters=4, chunk=128)
    assert c.dtype == jnp.float32 and c.shape == (8, 8)
    a = np.asarray(assign_chunked(data, c, chunk=128))
    assert a.min() >= 0 and a.max() < 8


def test_kmeans_reduces_distortion(rng):
    import jax
    data = rng.standard_normal((512, 8)).astype(np.float32)
    c = kmeans_fit(jax.numpy.asarray(data), jax.random.PRNGKey(0), k=16,
                   iters=8, chunk=256)
    a = np.asarray(assign_chunked(jax.numpy.asarray(data), c, chunk=256))
    assert a.shape == (512,) and a.min() >= 0 and a.max() < 16
    # distortion must be far below the random-assignment baseline
    d = np.linalg.norm(data - np.asarray(c)[a], axis=1).mean()
    base = np.linalg.norm(data - data.mean(0), axis=1).mean()
    assert d < base * 0.95


class TestScalar:
    def test_roundtrip_error(self, corpus):
        v, _, _ = corpus
        sq = ScalarQuantizer().train(v)
        back = sq.decode(sq.encode(v))
        scale = np.asarray(sq.scale)
        assert np.abs(back - v).max() <= scale.max() / 255 * 0.51 + 1e-5

    @pytest.mark.parametrize("metric", ["l2", "cosine", "ip"])
    def test_distance_recall(self, corpus, metric):
        v, q, _ = corpus
        sq = ScalarQuantizer().train(v)
        codes = sq.encode(v)
        _, idx = sq.search(q, codes, k=10, metric=metric)
        if metric == "l2":
            exact = np.argsort(
                np.linalg.norm(v[None] - q[:, None], axis=-1), axis=1)
        elif metric == "cosine":
            vn = v / np.linalg.norm(v, axis=1, keepdims=True)
            qn = q / np.linalg.norm(q, axis=1, keepdims=True)
            exact = np.argsort(1 - qn @ vn.T, axis=1)
        else:
            exact = np.argsort(-(q @ v.T), axis=1)
        assert recall_at_k(idx, exact, 10) >= 0.9  # ref claims ~95-97% (README.md:506)

    def test_compression_and_save(self, corpus, tmp_path):
        v, _, _ = corpus
        sq = ScalarQuantizer().train(v)
        mem = sq.memory_usage(len(v))
        assert mem["compression_ratio"] > 3.5
        sq.save(tmp_path / "sq.fpvt")
        sq2 = ScalarQuantizer.load(tmp_path / "sq.fpvt")
        np.testing.assert_array_equal(np.asarray(sq2.encode(v[:5])),
                                      np.asarray(sq.encode(v[:5])))


class TestInt4:
    def test_roundtrip_error(self, corpus):
        v, _, _ = corpus
        qz = Int4Quantizer().train(v)
        back = qz.decode(qz.encode(v))
        scale = np.asarray(qz.scale)[: v.shape[1]]
        # 16 levels: error bound is half a step per dimension
        assert np.abs(back - v).max() <= scale.max() / 15 * 0.51 + 1e-5

    def test_packing_halves_layout(self, rng):
        """Byte w holds dim w (low nibble) and dim w+W (high nibble)."""
        v = rng.standard_normal((10, 8)).astype(np.float32)
        qz = Int4Quantizer().train(v)
        packed = np.asarray(qz.encode(v))
        assert packed.shape == (10, 4) and packed.dtype == np.uint8
        # recompute raw 4-bit codes from the training params
        c = np.clip(np.round((v - np.asarray(qz.vmin)[None, :8])
                             / np.asarray(qz.scale)[None, :8] * 15.0),
                    0, 15).astype(np.uint8)
        np.testing.assert_array_equal(packed & 0xF, c[:, :4])
        np.testing.assert_array_equal(packed >> 4, c[:, 4:])

    def test_odd_dims_phantom_pad(self, rng):
        v = rng.standard_normal((50, 33)).astype(np.float32)
        q = rng.standard_normal((4, 33)).astype(np.float32)
        qz = Int4Quantizer().train(v)
        codes = qz.encode(v)
        assert np.asarray(codes).shape == (50, 17)
        back = qz.decode(codes)
        assert back.shape == (50, 33)
        # the phantom dim must not perturb distances: compare vs a
        # zero-padded 34-d corpus scored with an even-dims quantizer
        d33 = np.asarray(qz.distances(q, codes, metric="l2"))
        v34 = np.pad(v, ((0, 0), (0, 1)))
        qz34 = Int4Quantizer().train(v34)
        d34 = np.asarray(qz34.distances(np.pad(q, ((0, 0), (0, 1))),
                                        qz34.encode(v34), metric="l2"))
        np.testing.assert_allclose(d33, d34, rtol=1e-4, atol=1e-3)

    @pytest.mark.parametrize("metric", ["l2", "cosine", "ip"])
    @pytest.mark.parametrize("mode", ["chunked", "int4mm"])
    def test_distance_recall(self, corpus, metric, mode):
        v, q, _ = corpus
        qz = Int4Quantizer().train(v)
        codes = qz.encode(v)
        d = np.asarray(qz.distances(q, codes, metric=metric, mode=mode))
        idx = np.argsort(d, axis=1)
        if metric == "l2":
            exact = np.argsort(
                np.linalg.norm(v[None] - q[:, None], axis=-1), axis=1)
        elif metric == "cosine":
            vn = v / np.linalg.norm(v, axis=1, keepdims=True)
            qn = q / np.linalg.norm(q, axis=1, keepdims=True)
            exact = np.argsort(1.0 - qn @ vn.T, axis=1)
        else:
            exact = np.argsort(-(q @ v.T), axis=1)
        # 16-level coarse ordering: looser than int8, still high overlap
        # at a 4x candidate pool (it serves as a coarse stage only)
        pool_recall = np.mean(
            [len(set(a[:40].tolist()) & set(e[:10].tolist())) / 10
             for a, e in zip(idx, exact)])
        assert pool_recall >= 0.85, pool_recall

    def test_modes_agree(self, corpus):
        v, q, _ = corpus
        qz = Int4Quantizer().train(v)
        codes = qz.encode(v)
        a = np.asarray(qz.distances(q, codes, metric="l2", mode="chunked"))
        b = np.asarray(qz.distances(q, codes, metric="l2", mode="int4mm"))
        # int4mm additionally quantizes the query to int8: small extra noise
        tol = 2e-2 * max(np.abs(a).max(), 1.0)
        np.testing.assert_allclose(a, b, atol=tol)

    def test_compression_and_save(self, corpus, tmp_path):
        v, _, _ = corpus
        qz = Int4Quantizer().train(v)
        # 32-d f32 -> 16 bytes/row: ~8x
        assert qz.memory_usage(100_000)["compression_ratio"] > 7.5
        qz.save(tmp_path / "i4.fpvt")
        qz2 = Int4Quantizer.load(tmp_path / "i4.fpvt")
        assert qz2.dims == qz.dims
        np.testing.assert_array_equal(np.asarray(qz2.encode(v[:5])),
                                      np.asarray(qz.encode(v[:5])))


class TestBinary:
    def test_hamming_exactness(self, rng):
        # hand-check: hamming distance equals bit disagreement count
        v = rng.standard_normal((20, 70)).astype(np.float32)  # non-multiple of 32
        bq = BinaryQuantizer().train(v)
        d = np.asarray(bq.hamming_distances(v[:4], bq.encode(v)))
        bits = (v > np.asarray(bq.thresholds)[None, :])
        want = (bits[:4, None, :] != bits[None, :, :]).sum(-1)
        np.testing.assert_array_equal(d, want)
        assert d[np.arange(4), np.arange(4)].max() == 0

    def test_search_recall_high_dim(self):
        # binary signatures need dimensionality to discriminate; at 128-d the
        # reference claims 80-90% recall (README.md:507)
        rng = np.random.default_rng(3)
        n, d = 2000, 128
        centers = rng.standard_normal((16, d)).astype(np.float32) * 3
        v = centers[rng.integers(0, 16, n)] + rng.standard_normal(
            (n, d)).astype(np.float32)
        q = centers[rng.integers(0, 16, 8)] + rng.standard_normal(
            (8, d)).astype(np.float32)
        exact = np.argsort(
            np.linalg.norm(v[None, :, :] - q[:, None, :], axis=-1), axis=1)
        bq = BinaryQuantizer().train(v)
        # BQ is a pre-filter: measure whether the exact top-10 survives a
        # 10x-overfetch Hamming candidate pass (the reference's hybrid
        # pipeline shape, parallel_search.py:895-947)
        _, cand = bq.search(q, bq.encode(v), k=100)
        prefilter_recall = np.mean([
            len(set(c.tolist()) & set(e[:10].tolist())) / 10
            for c, e in zip(cand, exact)])
        assert prefilter_recall >= 0.6

    def test_compression_and_save(self, corpus, tmp_path):
        v, _, _ = corpus
        bq = BinaryQuantizer().train(v)
        assert bq.memory_usage(len(v))["compression_ratio"] > 25
        bq.save(tmp_path / "bq.fpvt")
        bq2 = BinaryQuantizer.load(tmp_path / "bq.fpvt")
        np.testing.assert_array_equal(np.asarray(bq2.encode(v[:3])),
                                      np.asarray(bq.encode(v[:3])))


class TestProduct:
    def test_encode_decode_distortion(self, corpus):
        v, _, _ = corpus
        pq = ProductQuantizer(m=8).train(v, iters=8)
        back = pq.decode(pq.encode(v))
        # PQ reconstruction must beat the global-mean baseline by a wide margin
        err = np.linalg.norm(back - v, axis=1).mean()
        base = np.linalg.norm(v - v.mean(0), axis=1).mean()
        assert err < base * 0.7

    def test_search_recall(self, corpus):
        v, q, exact = corpus
        pq = ProductQuantizer(m=8).train(v, iters=10)
        _, idx = pq.search(q, pq.encode(v), k=10)
        assert recall_at_k(idx, exact, 10) >= 0.6  # ref claims 90-95% at scale

    def test_compression_and_save(self, corpus, tmp_path):
        v, _, _ = corpus
        pq = ProductQuantizer(m=8).train(v, iters=4)
        # 32-d f32 -> 8 bytes: 16x before codebook overhead
        assert pq.memory_usage(100_000)["compression_ratio"] > 10
        pq.save(tmp_path / "pq.fpvt")
        pq2 = ProductQuantizer.load(tmp_path / "pq.fpvt")
        np.testing.assert_array_equal(np.asarray(pq2.encode(v[:3])),
                                      np.asarray(pq.encode(v[:3])))


class TestQuantizedScan:
    @pytest.mark.parametrize("kind", ["int8", "int4", "binary"])
    def test_two_stage_matches_exact(self, corpus, kind):
        v, q, _ = corpus
        col = Collection(CollectionConfig(name="t", dimensions=32, metric="l2"))
        col.insert_batch(v, [f"v{i}" for i in range(len(v))])
        col.enable_quantized_scan(kind)
        exact = [[h.id for h in hits] for hits in col.search_batch(q, k=10)]
        approx = [[h.id for h in hits]
                  for hits in col.search_quantized(q, k=10, rerank=8)]
        # re-ranked two-stage search should closely match exact top-10
        overlap = np.mean([len(set(a) & set(e)) / 10
                           for a, e in zip(approx, exact)])
        assert overlap >= {"int8": 0.9, "int4": 0.85}.get(kind, 0.6)

    def test_respects_filter(self, corpus):
        from fastpyvectordb_jax import Filter
        v, q, _ = corpus
        col = Collection(CollectionConfig(name="t", dimensions=32, metric="l2"))
        col.insert_batch(v, [f"v{i}" for i in range(len(v))],
                         [{"p": i % 3} for i in range(len(v))])
        col.enable_quantized_scan("int8")
        res = col.search_quantized(q[:2], k=5, filter=Filter.eq("p", 1))
        assert all(h.metadata["p"] == 1 for hits in res for h in hits)


def test_pq_two_stage_scan(corpus):
    v, q, _ = corpus
    col = Collection(CollectionConfig(name="pq", dimensions=32, metric="l2"))
    col.insert_batch(v, [f"v{i}" for i in range(len(v))])
    col.enable_quantized_scan("pq", m=8, iters=6)
    exact = [[h.id for h in hits] for hits in col.search_batch(q, k=10)]
    approx = [[h.id for h in hits]
              for hits in col.search_quantized(q, k=10, rerank=8)]
    overlap = np.mean([len(set(a) & set(e)) / 10
                       for a, e in zip(approx, exact)])
    assert overlap >= 0.6


def test_bfloat16_collection_config(corpus):
    """The bf16 serving config must trace and rank correctly
    on every path, including quantized re-rank in bf16."""
    v, q, _ = corpus
    col = Collection(CollectionConfig(name="bf", dimensions=32, metric="l2",
                                      compute_dtype="bfloat16"))
    col.insert_batch(v, [f"v{i}" for i in range(len(v))])
    hits = col.search(v[3], k=1)
    assert hits[0].id == "v3"
    res = col.search_quantized(q[:2], k=5, rerank=8)
    assert all(len(r) == 5 for r in res)
    col.build_ann(kind="ivf", nlist=16, nprobe=8, iters=4)
    assert col.search(v[7], k=1, exact=False)[0].id == "v7"


def test_candidate_selection_covers_global_top():
    """The coarse candidate set must contain the true global top-k and
    never surface masked rows."""
    import jax.numpy as jnp
    from fastpyvectordb_jax.quant.scan import _coarse_topk
    rng = np.random.default_rng(4)
    s = rng.standard_normal((6, 1000)).astype(np.float32)
    mask = np.ones(1000, dtype=bool)
    mask[500:600] = False
    vals, rows = _coarse_topk(jnp.asarray(s), jnp.asarray(mask), 128)
    rows = np.asarray(rows)
    masked_s = np.where(mask[None, :], s, np.inf)
    want = np.argsort(masked_s, axis=1)[:, :10]
    for b in range(6):
        got = set(rows[b].tolist())
        assert set(want[b].tolist()) <= got
        assert not (got & set(range(500, 600)))  # masked rows never surface


def test_tune_rerank_binary_clustered():
    """1-bit ordering degrades on clustered corpora; tune_rerank must find
    the candidate depth that restores recall (on a 1M clustered corpus
    recall@10 collapses to ~0.5 at rerank=16)."""
    import numpy as np
    from fastpyvectordb_jax import Collection, CollectionConfig
    rng = np.random.default_rng(5)
    n, d = 4000, 64
    centers = rng.standard_normal((8, d)).astype(np.float32) * 2
    v = centers[rng.integers(0, 8, n)] + 0.2 * rng.standard_normal(
        (n, d)).astype(np.float32)
    col = Collection(CollectionConfig(name="t", dimensions=d, metric="l2"))
    col.insert_batch(v, [f"v{i}" for i in range(n)])
    scan = col.enable_quantized_scan("binary")
    q = centers[rng.integers(0, 8, 8)] + 0.2 * rng.standard_normal(
        (8, d)).astype(np.float32)
    factor = scan.tune_rerank(q, target_recall=0.9, k=10)
    assert factor >= 4
    assert getattr(scan, "default_rerank") == factor
    # the tuned default is picked up by the collection-level API
    exact = [[h.id for h in hits] for hits in col.search_batch(q, k=10)]
    tuned = [[h.id for h in hits] for hits in col.search_quantized(q, k=10)]
    rec = np.mean([len(set(a) & set(e)) / 10 for a, e in zip(tuned, exact)])
    assert rec >= 0.85, rec


def test_tuned_rerank_survives_threshold_rebuild():
    import numpy as np
    from fastpyvectordb_jax import Collection, CollectionConfig
    rng = np.random.default_rng(9)
    col = Collection(CollectionConfig(name="tr", dimensions=16))
    col.insert_batch(rng.standard_normal((256, 16)).astype(np.float32),
                     [f"v{i}" for i in range(256)])
    scan = col.enable_quantized_scan("int8")
    scan.default_rerank = 32  # as tune_rerank would install
    # grow far past the rebuild threshold, then search through the API
    col.insert_batch(rng.standard_normal((8000, 16)).astype(np.float32),
                     [f"w{i}" for i in range(8000)])
    assert col._index_rebuild_due(scan.built_count)
    col.search_quantized(rng.standard_normal(16).astype(np.float32), k=5)
    assert col.wait_for_rebuild(timeout=120)
    assert col._quantized is not scan  # background rebuild swapped in
    assert col._quantized.built_count == 256 + 8000
    assert getattr(col._quantized, "default_rerank", None) == 32


def test_pq_scan_cosine_normalizes():
    """PQ ADC ranks by squared L2; for cosine collections the codes must
    be built over the normalized corpus or large-norm rows hijack the
    candidate pool."""
    import numpy as np
    from fastpyvectordb_jax import Collection, CollectionConfig
    rng = np.random.default_rng(0)
    n, d = 1500, 32
    v = rng.standard_normal((n, d)).astype(np.float32)
    v[: n // 2] *= 20.0  # large-norm rows that are NOT cosine-close
    col = Collection(CollectionConfig(name="pqc", dimensions=d,
                                      metric="cosine"))
    col.insert_batch(v, [f"v{i}" for i in range(n)])
    col.enable_quantized_scan("pq", m=8, k=16)
    q = v[1200] / np.linalg.norm(v[1200])
    hits = col.search_quantized(q[None, :], k=5, rerank=8)[0]
    assert hits[0].id == "v1200", [h.id for h in hits]


def test_pq_scan_rejects_dot_metric():
    import numpy as np
    import pytest
    from fastpyvectordb_jax import Collection, CollectionConfig
    col = Collection(CollectionConfig(name="pqd", dimensions=8,
                                      metric="ip"))
    col.insert_batch(np.eye(8, dtype=np.float32), list("abcdefgh"))
    with pytest.raises(ValueError, match="dot"):
        col.enable_quantized_scan("pq", m=4, k=16)


@pytest.mark.parametrize("kind", ["int8", "int4", "binary", "pq"])
def test_capacity_buffer_codes(kind, tmp_path):
    """QuantizedScan.build encodes the store's full CAPACITY buffer (no
    [:n] device copy — a second multi-GB corpus in device memory).  Padding
    rows carry garbage codes and must never rank; rows appended after the
    build land in old padding slots and are served by the exact tail
    merge; count-sized filter masks pad against capacity codes; persist
    snapshots only the built rows."""
    rng = np.random.default_rng(11)
    n, d = 700, 32  # MIN_CAPACITY=1024 > n: padding rows exist
    v = rng.standard_normal((n, d)).astype(np.float32)
    col = Collection(CollectionConfig(name=f"cap-{kind}", dimensions=d,
                                      metric="l2"))
    col.insert_batch(v, [f"a{i}" for i in range(n)],
                     metadatas=[{"g": int(i % 3)} for i in range(n)])
    kw = {"m": 8, "k": 16} if kind == "pq" else {}
    scan = col.enable_quantized_scan(kind, **kw)
    assert scan.built_count == n
    assert scan.codes.shape[0] >= col._store.capacity or \
        scan.codes.shape[0] == n  # binary packs words; int8/pq row-major
    q = v[17:18] + 0.01 * rng.standard_normal((1, d)).astype(np.float32)
    hits = col.search_quantized(q, k=5, rerank=16)[0]
    assert hits[0].id == "a17", [h.id for h in hits]
    assert all(h.id.startswith("a") for h in hits)  # no padding rows
    # count-sized filter mask vs capacity-length codes
    from fastpyvectordb_jax import Filter
    fhits = col.search_quantized(q, k=5, rerank=16,
                                 filter=Filter.eq("g", 2))[0]
    assert fhits and all(h.metadata["g"] == 2 for h in fhits)
    # append after build: new rows occupy former padding slots whose
    # codes are stale — the exact tail merge must serve them
    w = rng.standard_normal((40, d)).astype(np.float32)
    col.insert_batch(w, [f"b{i}" for i in range(40)])
    r2 = col.search_quantized(w[7:8], k=3, rerank=16)[0]
    assert r2[0].id == "b7", [h.id for h in r2]
    # persisted snapshot slices to built_count and round-trips
    col.base_path = tmp_path / kind
    col.save()
    col2 = Collection(col.config, base_path=col.base_path)
    assert col2._quantized is not None
    assert col2._quantized.built_count == n
    r3 = col2.search_quantized(q, k=5, rerank=16)[0]
    assert r3[0].id == "a17", [h.id for h in r3]
    r4 = col2.search_quantized(w[7:8], k=3, rerank=16)[0]
    assert r4[0].id == "b7", [h.id for h in r4]


def test_tune_rerank_oracle_excludes_post_build_tail():
    """tune_rerank's exact oracle must rank only rows the snapshot can
    return: with appended (tail) rows in scope, recall caps below any
    reachable value and the loop pins default_rerank at max_rerank."""
    import numpy as np
    from fastpyvectordb_jax.core.collection import Collection
    from fastpyvectordb_jax.core.types import CollectionConfig

    rng = np.random.default_rng(6)
    v = rng.standard_normal((400, 16)).astype(np.float32)
    col = Collection(CollectionConfig(name="tt", dimensions=16,
                                      metric="l2"))
    col.insert_batch(v[:300], [f"v{i}" for i in range(300)])
    scan = col.enable_quantized_scan("int8", tune=False)
    col.insert_batch(v[300:], [f"w{i}" for i in range(100)])  # 25% tail
    q = v[:16]
    rr = scan.tune_rerank(q, k=10, target_recall=0.95, max_rerank=256)
    # int8 coarse ordering is near-exact on Gaussian data: a correctly
    # scoped oracle converges at the first factor, not max_rerank
    assert rr <= 8, rr


@pytest.mark.parametrize("metric", list(DistanceMetric))
def test_sq_int8_matmul_matches_reference(metric):
    """The int8 scan path (query-side scale folding) must rank like the
    full dequantized computation."""
    import jax.numpy as jnp
    from fastpyvectordb_jax.quant.scalar import _distances
    rng = np.random.default_rng(5)
    v = rng.standard_normal((300, 40)).astype(np.float32)
    q = rng.standard_normal((5, 40)).astype(np.float32)
    sq = ScalarQuantizer().train(v)
    codes = sq.encode(v)
    want = np.asarray(_distances(jnp.asarray(q), codes, sq.vmin, sq.scale,
                                 metric=metric))
    got = np.asarray(sq.distances(q, codes, metric, mode="int8mm"))
    # query quantization adds <1% relative error
    tol = 2e-2 * max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, atol=tol)
    # rank stability: top-1 score per the reference matrix is near-optimal
    top = want[np.arange(len(want)), got.argmin(1)]
    np.testing.assert_allclose(top, want.min(1), atol=tol)


def test_score_matrix_hbm_cap_splits_batches(monkeypatch):
    """A query batch whose coarse (B, N) f32 score matrix would exceed
    the per-dispatch budget splits into pow2 sub-batches with identical
    results (a 5M x B=1024 dispatch would allocate 20 GB at once)."""
    from fastpyvectordb_jax.quant.scan import QuantizedScan
    rng = np.random.default_rng(3)
    col = Collection(CollectionConfig(name="cap", dimensions=16))
    col.insert_batch(rng.standard_normal((500, 16), dtype=np.float32),
                     [f"v{i}" for i in range(500)])
    scan = col.enable_quantized_scan("int4", tune=False)
    q = rng.standard_normal((40, 16), dtype=np.float32)
    d_full, r_full = scan.search(q, 5)
    # budget for <= 8 queries: 8 * 500 * 4 bytes
    monkeypatch.setattr(QuantizedScan, "_score_hbm_budget", 8 * 500 * 4)
    d_split, r_split = scan.search(q, 5)
    np.testing.assert_array_equal(r_full, r_split)
    np.testing.assert_allclose(d_full, d_split, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind,rerank", [("int8", 4), ("int8", 1),
                                         ("binary", 16), ("pq", 4)])
def test_score_block_cap_splits_every_codec(monkeypatch, kind, rerank):
    """Every codec splits a batch whose coarse score block exceeds the
    budget (the GPU materialises the block for each of them), into
    sub-batches of at most the budget, with unchanged answers."""
    from fastpyvectordb_jax.quant.scan import QuantizedScan
    rng = np.random.default_rng(4)
    col = Collection(CollectionConfig(name="cap", dimensions=16))
    col.insert_batch(rng.standard_normal((500, 16), dtype=np.float32),
                     [f"v{i}" for i in range(500)])
    scan = col.enable_quantized_scan(kind, tune=False)
    q = rng.standard_normal((40, 16), dtype=np.float32)
    d_full, r_full = scan.search(q, 5, rerank=rerank)
    n_rows = int(scan.codes.shape[0])
    monkeypatch.setattr(QuantizedScan, "_score_hbm_budget", 8 * n_rows * 4)
    seen = []
    orig = QuantizedScan.search

    def spy(self, queries, *a, **kw):
        seen.append(len(queries))
        return orig(self, queries, *a, **kw)

    monkeypatch.setattr(QuantizedScan, "search", spy)
    d_split, r_split = scan.search(q, 5, rerank=rerank)
    assert seen[0] == 40 and max(seen[1:]) <= 8 and sum(seen[1:]) == 40
    np.testing.assert_array_equal(r_full, r_split)
    np.testing.assert_allclose(d_full, d_split, rtol=1e-5, atol=1e-5)
