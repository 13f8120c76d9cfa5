"""Out-of-core streamed search tests (parity: parallel_search.py mmap
chunked search)."""

import numpy as np
import pytest

from fastpyvectordb_jax.core.outofcore import OutOfCoreSearcher
from fastpyvectordb_jax.core.types import DistanceMetric
from fastpyvectordb_jax.persist.format import (
    StreamingVectorReader,
    StreamingVectorWriter,
)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(21)
    return rng.standard_normal((1000, 16)).astype(np.float32), \
        rng.standard_normal((4, 16)).astype(np.float32)


@pytest.mark.parametrize("metric", list(DistanceMetric))
def test_matches_in_memory_exact(corpus, metric):
    v, q = corpus
    s = OutOfCoreSearcher(v, metric=metric, tile_rows=256)  # ragged last tile
    vals, rows = s.search(q, k=7)
    if metric == DistanceMetric.COSINE:
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        vn = v / np.linalg.norm(v, axis=1, keepdims=True)
        d = 1 - qn @ vn.T
    elif metric == DistanceMetric.L2:
        d = np.linalg.norm(q[:, None] - v[None], axis=-1)
    else:
        d = -(q @ v.T)
    want_rows = np.argsort(d, axis=1, kind="stable")[:, :7]
    for got, want, dd in zip(rows, want_rows, d):
        assert set(got.tolist()) == set(want.tolist()) or np.allclose(
            sorted(dd[got]), sorted(dd[want]), atol=1e-4)


def test_mask(corpus):
    v, q = corpus
    mask = np.zeros(len(v), dtype=bool)
    mask[300:400] = True
    s = OutOfCoreSearcher(v, metric="l2", tile_rows=128)
    _, rows = s.search(q, k=20, mask=mask)
    assert ((rows >= 300) & (rows < 400)).all()


def test_streaming_file_backend(corpus, tmp_path):
    v, q = corpus
    path = tmp_path / "big.fpvs"
    with StreamingVectorWriter(path, dims=16) as w:
        w.append_batch(v)
    with StreamingVectorReader(path) as r:
        s = OutOfCoreSearcher(r._mm, metric="cosine", tile_rows=512)
        vals, rows = s.search(q[:1], k=1)
    qn = q[0] / np.linalg.norm(q[0])
    vn = v / np.linalg.norm(v, axis=1, keepdims=True)
    assert rows[0, 0] == int(np.argmax(vn @ qn))


def test_k_larger_than_corpus():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((10, 8)).astype(np.float32)
    s = OutOfCoreSearcher(v, metric="l2", tile_rows=8)
    vals, rows = s.search(v[:2], k=50)
    assert vals.shape == (2, 10)
    assert rows[0, 0] == 0 and rows[1, 0] == 1


def test_memmap_backed_corpus_matches(tmp_path, corpus):
    """A disk-backed np.memmap corpus (the >RAM deployment shape, used by
    benchmarks/outofcore_20m.py --memmap) must stream identically to the
    in-RAM array."""
    v, q = corpus
    path = tmp_path / "corpus.f32"
    mm = np.memmap(path, np.float32, "w+", shape=v.shape)
    mm[:] = v
    mm.flush()
    ro = np.memmap(path, np.float32, "r", shape=v.shape)
    s_ram = OutOfCoreSearcher(v, metric="l2", tile_rows=256)
    s_mm = OutOfCoreSearcher(ro, metric="l2", tile_rows=256)
    vr, rr = s_ram.search(q, k=5)
    vm, rm = s_mm.search(q, k=5)
    np.testing.assert_allclose(vm, vr, atol=1e-5)
    np.testing.assert_array_equal(rm, rr)


# ---------------------------------------------------------------------------
# QuantizedOutOfCoreSearcher: streamed codes coarse scan + exact re-rank
# (parity tier: reference README.md:571-578 ">10M mmap + BQ + candidates",
# parallel_search.py:895-947 search_hybrid)

from fastpyvectordb_jax.core.outofcore import QuantizedOutOfCoreSearcher


@pytest.fixture(scope="module")
def qcorpus():
    rng = np.random.default_rng(7)
    v = rng.standard_normal((3000, 32)).astype(np.float32)
    q = rng.standard_normal((5, 32)).astype(np.float32)
    # plant exact copies of the queries so top-1 is unambiguous
    plant = np.array([17, 503, 1024, 2047, 2999])
    v[plant] = q
    return v, q, plant


@pytest.mark.parametrize("codec", ["int8", "int4", "binary", "pq"])
def test_quantized_planted_top1(qcorpus, codec):
    v, q, plant = qcorpus
    s = QuantizedOutOfCoreSearcher(v, metric="cosine", codec=codec,
                                   tile_rows=512, rerank=32)
    vals, rows = s.search(q, k=3)
    np.testing.assert_array_equal(rows[:, 0], plant)
    np.testing.assert_allclose(vals[:, 0], 0.0, atol=1e-4)


def test_quantized_pq_beats_binary_recall(qcorpus):
    """At comparable compression (pq m=D/4 = 8 bytes vs binary 4 bytes for
    32-d), the PQ ADC coarse stage should preserve far more of the exact
    top-10 than Hamming at the same rerank depth."""
    v, q, _ = qcorpus
    ex = OutOfCoreSearcher(v, metric="cosine", tile_rows=1024)
    _, erows = ex.search(q, k=10)

    def overlap(codec):
        s = QuantizedOutOfCoreSearcher(v, metric="cosine", codec=codec,
                                       tile_rows=1024, rerank=8)
        _, rows = s.search(q, k=10)
        return np.mean([len(set(a) & set(b)) / 10.0
                        for a, b in zip(rows.tolist(), erows.tolist())])

    r_pq, r_bin = overlap("pq"), overlap("binary")
    # i.i.d. Gaussian at 4 dims/subspace is PQ's worst case (no inter-dim
    # correlation to exploit); real embedding corpora sit far higher
    assert r_pq >= 0.8, r_pq
    assert r_pq >= r_bin, (r_pq, r_bin)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_quantized_int8_metrics_match_exact(qcorpus, metric):
    """int8 coarse + exact re-rank should recover the exact top-1 and
    high top-10 overlap on every metric."""
    v, q, _ = qcorpus
    s = QuantizedOutOfCoreSearcher(v, metric=metric, codec="int8",
                                   tile_rows=1024, rerank=16)
    vals, rows = s.search(q, k=10)
    ex = OutOfCoreSearcher(v, metric=metric, tile_rows=1024)
    evals, erows = ex.search(q, k=10)
    assert (rows[:, 0] == erows[:, 0]).all()
    overlap = np.mean([len(set(a) & set(b)) / 10.0
                       for a, b in zip(rows.tolist(), erows.tolist())])
    assert overlap >= 0.9
    np.testing.assert_allclose(vals[:, 0], evals[:, 0], atol=1e-3)


def test_quantized_mask(qcorpus):
    v, q, _ = qcorpus
    mask = np.zeros(len(v), dtype=bool)
    mask[1000:1500] = True
    s = QuantizedOutOfCoreSearcher(v, metric="l2", codec="int8",
                                   tile_rows=512, rerank=8)
    vals, rows = s.search(q, k=15, mask=mask)
    assert ((rows >= 1000) & (rows < 1500)).all()
    assert np.isfinite(vals).all()


def test_quantized_codes_memmap_reuse(qcorpus, tmp_path):
    """codes_path persists the encoded codes + quantizer stats; a second
    searcher with codes_reuse=True must skip re-encoding and search
    identically."""
    v, q, plant = qcorpus
    cp = str(tmp_path / "codes.npy")
    s1 = QuantizedOutOfCoreSearcher(v, metric="cosine", codec="int8",
                                    tile_rows=512, rerank=32, codes_path=cp)
    v1, r1 = s1.search(q, k=5)

    class Guard:
        """Corpus proxy that forbids contiguous tile reads (the train /
        re-encode access pattern); candidate gathers use fancy indexing."""
        def __init__(self, arr):
            self._arr = arr
            self.shape = arr.shape
        def __getitem__(self, idx):
            if isinstance(idx, slice):
                raise AssertionError("re-encoded despite codes_reuse")
            return self._arr[idx]

    s2 = QuantizedOutOfCoreSearcher(Guard(v), metric="cosine", codec="int8",
                                    tile_rows=512, rerank=32,
                                    codes_path=cp, codes_reuse=True)
    v2, r2 = s2.search(q, k=5)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_allclose(v1, v2, atol=1e-6)

    # int4 codec: same round-trip through its own codes file
    ci4 = str(tmp_path / "codes_i4.npy")
    i1 = QuantizedOutOfCoreSearcher(v, metric="cosine", codec="int4",
                                    tile_rows=512, rerank=32, codes_path=ci4)
    iv1, ir1 = i1.search(q, k=5)
    i2 = QuantizedOutOfCoreSearcher(Guard(v), metric="cosine", codec="int4",
                                    tile_rows=512, rerank=32,
                                    codes_path=ci4, codes_reuse=True)
    iv2, ir2 = i2.search(q, k=5)
    np.testing.assert_array_equal(ir1, ir2)
    np.testing.assert_allclose(iv1, iv2, atol=1e-6)

    # pq codec: same round-trip through its own codes file
    cpq = str(tmp_path / "codes_pq.npy")
    p1 = QuantizedOutOfCoreSearcher(v, metric="cosine", codec="pq",
                                    tile_rows=512, rerank=32, codes_path=cpq)
    pv1, pr1 = p1.search(q, k=5)
    p2 = QuantizedOutOfCoreSearcher(Guard(v), metric="cosine", codec="pq",
                                    tile_rows=512, rerank=32,
                                    codes_path=cpq, codes_reuse=True)
    pv2, pr2 = p2.search(q, k=5)
    np.testing.assert_array_equal(pr1, pr2)
    np.testing.assert_allclose(pv1, pv2, atol=1e-6)


def test_quantized_k_larger_than_corpus():
    rng = np.random.default_rng(3)
    v = rng.standard_normal((12, 8)).astype(np.float32)
    s = QuantizedOutOfCoreSearcher(v, metric="l2", codec="int8",
                                   tile_rows=8, rerank=4, train_rows=12)
    vals, rows = s.search(v[:2], k=40)
    assert vals.shape == (2, 12)
    assert rows[0, 0] == 0 and rows[1, 0] == 1


def test_quantized_tune_rerank_clustered():
    """Tightly clustered corpora collapse coarse code orderings (ROADMAP
    #15's binary story, and pq at low bits/dim); tune_rerank must find a
    depth that restores the target recall against the exact stream."""
    rng = np.random.default_rng(4)
    d = 32
    centers = 2.0 * rng.standard_normal((8, d)).astype(np.float32)
    v = (centers[rng.integers(0, 8, 4000)]
         + 0.2 * rng.standard_normal((4000, d)).astype(np.float32))
    q = (centers[rng.integers(0, 8, 6)]
         + 0.2 * rng.standard_normal((6, d)).astype(np.float32))
    s = QuantizedOutOfCoreSearcher(v, metric="cosine", codec="pq",
                                   tile_rows=1024, rerank=2)
    rr = s.tune_rerank(q, k=10, target_recall=0.95)
    assert rr >= 2 and s.rerank == rr
    ex = OutOfCoreSearcher(v, metric="cosine", tile_rows=1024)
    _, truth = ex.search(q, k=10)
    _, rows = s.search(q, k=10)  # tuned depth is now the default
    rec = np.mean([len(set(a) & set(b)) / 10
                   for a, b in zip(rows.tolist(), truth.tolist())])
    assert rec >= 0.95, rec


@pytest.mark.parametrize("codec", ["int8", "int4", "binary"])
def test_host_encode_matches_device(qcorpus, codec):
    """Build-time host (numpy) encoding must be bit-compatible with the
    device encoders it mirrors (quant/{scalar,int4,binary}.py:_encode) —
    the streamed tiers default to host encode so building never ships the
    full f32 corpus across the host<->device link."""
    v, q, plant = qcorpus
    sh = QuantizedOutOfCoreSearcher(v, metric="cosine", codec=codec,
                                    tile_rows=700, rerank=16,
                                    encode_on="host")
    sd = QuantizedOutOfCoreSearcher(v, metric="cosine", codec=codec,
                                    tile_rows=700, rerank=16,
                                    encode_on="device")
    ch = np.asarray(sh._codes)
    cd = np.asarray(sd._codes)
    assert ch.dtype == cd.dtype and ch.shape == cd.shape
    # identical f32 arithmetic on both sides; allow <=0.01% one-level
    # boundary flips from fusion-order ulp differences
    mism = np.mean(ch != cd)
    assert mism <= 1e-4, mism
    if codec in ("int8", "int4"):
        np.testing.assert_allclose(sh._vsq, sd._vsq, rtol=1e-4)
        np.testing.assert_allclose(sh._rinv, sd._rinv, rtol=1e-4)
    vh, rh = sh.search(q, k=5)
    vd, rd = sd.search(q, k=5)
    np.testing.assert_array_equal(rh[:, 0], plant)
    np.testing.assert_array_equal(rd[:, 0], plant)
