"""IVF-PQ index tests: recall vs exact, metrics, filters, persistence,
incremental tail merge, compression accounting."""

import numpy as np
import pytest

from fastpyvectordb_jax import Collection, CollectionConfig, Filter


def make_col(metric="l2", n=4000, d=32, seed=11):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((32, d)).astype(np.float32) * 2
    v = centers[rng.integers(0, 32, n)] + 0.3 * rng.standard_normal(
        (n, d)).astype(np.float32)
    col = Collection(CollectionConfig(name="ivfpq", dimensions=d,
                                      metric=metric))
    col.insert_batch(v, [f"v{i}" for i in range(n)],
                     [{"g": i % 4} for i in range(n)])
    q = centers[rng.integers(0, 32, 16)] + 0.3 * rng.standard_normal(
        (16, d)).astype(np.float32)
    return col, v, q


@pytest.fixture(scope="module")
def built():
    col, v, q = make_col()
    col.build_ann(kind="ivfpq", nlist=64, nprobe=8, iters=6, m=8, pq_k=64,
                  pq_iters=8, rerank=16)
    return col, v, q


def ids_of(res):
    return [[h.id for h in hits] for hits in res]


def recall_of(col, rows, exact_ids, k=10):
    out = []
    for b, e in zip(rows, exact_ids):
        ids = {col._row_to_id[int(r)] for r in b if r >= 0}
        out.append(len(ids & set(e)) / k)
    return float(np.mean(out))


def test_recall_vs_exact(built):
    col, v, q = built
    exact = ids_of(col.search_batch(q, k=10, exact=True))
    approx = ids_of(col.search_batch(q, k=10, exact=False))
    rec = np.mean([len(set(a) & set(e)) / 10 for a, e in zip(approx, exact)])
    assert rec >= 0.9, f"IVF-PQ recall@10 {rec:.3f} < 0.9"


def test_rerank_raises_recall(built):
    col, v, q = built
    exact = ids_of(col.search_batch(q, k=10, exact=True))
    _, r_no = col._ann.search(q, 10, rerank=0)
    _, r_rr = col._ann.search(q, 10, rerank=16)
    assert recall_of(col, r_rr, exact) >= recall_of(col, r_no, exact)
    assert recall_of(col, r_rr, exact) >= 0.9


def test_higher_nprobe_raises_recall(built):
    col, v, q = built
    exact = ids_of(col.search_batch(q, k=10, exact=True))
    _, lo = col._ann.search(q, 10, nprobe=1, rerank=16)
    _, hi = col._ann.search(q, 10, nprobe=32, rerank=16)
    assert recall_of(col, hi, exact) >= recall_of(col, lo, exact)
    assert recall_of(col, hi, exact) >= 0.9


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_other_metrics(metric):
    col, v, q = make_col(metric=metric, n=2000, d=32, seed=7)
    col.build_ann(kind="ivfpq", nlist=32, nprobe=8, iters=6, m=8, pq_k=64,
                  pq_iters=8)
    exact = ids_of(col.search_batch(q, k=10, exact=True))
    approx = ids_of(col.search_batch(q, k=10, exact=False))
    rec = np.mean([len(set(a) & set(e)) / 10 for a, e in zip(approx, exact)])
    assert rec >= 0.85, f"{metric} recall {rec:.3f}"


def test_filtered(built):
    col, v, q = built
    res = col.search_batch(q[:4], k=8, filter=Filter.eq("g", 2), exact=False)
    assert all(h.metadata["g"] == 2 for hits in res for h in hits)


def test_deletes_respected(rng):
    # own collection: the module fixture must not be mutated (the old
    # delete + re-insert left a tombstone + un-indexed tail behind for
    # every later test, making results order-dependent)
    n, d = 1200, 16
    v = rng.standard_normal((n, d)).astype(np.float32)
    col = Collection(CollectionConfig(name="del", dimensions=d,
                                      metric="l2"))
    col.insert_batch(v, [f"v{i}" for i in range(n)])
    col.build_ann(kind="ivfpq", nlist=16, nprobe=4, iters=3, m=8,
                  pq_k=16, pq_iters=3)
    q0 = v[37] + 0.01
    hits = col.search(q0, k=5, exact=False)
    victim = hits[0].id
    col.delete(victim)
    after = col.search(q0, k=5, exact=False)
    assert victim not in [h.id for h in after]


def test_incremental_tail_merge():
    col, v, q = make_col(n=2000, d=32, seed=3)
    col.build_ann(kind="ivfpq", nlist=32, nprobe=8, iters=6, m=8, pq_k=64,
                  pq_iters=8)
    # planted new vector appended after the build must be findable
    target = q[0] / np.linalg.norm(q[0])
    col.insert(target.astype(np.float32), id="planted")
    assert not col._ann.stale
    hits = col.search(target, k=3, exact=False)
    assert hits[0].id == "planted"


def test_persistence_roundtrip(tmp_path):
    from pathlib import Path
    col, v, q = make_col(n=1500, d=32, seed=5)
    col.base_path = Path(tmp_path) / "ivfpq_col"
    col.build_ann(kind="ivfpq", nlist=32, nprobe=8, iters=6, m=8, pq_k=64,
                  pq_iters=8)
    before_d, before_r = col._ann.search(q, 5)
    col.save()
    col2 = Collection(CollectionConfig(name="ivfpq", dimensions=32),
                      base_path=col.base_path)
    assert type(col2._ann).__name__ == "IVFPQIndex"
    assert col2.config.index == "ivfpq" and not col2._ann.stale
    after_d, after_r = col2._ann.search(q, 5)
    np.testing.assert_array_equal(before_r, after_r)
    np.testing.assert_allclose(before_d, after_d, rtol=1e-5, atol=1e-5)


def test_compression_accounting(built):
    col, v, q = built
    mu = col._ann.memory_usage()
    assert mu["compression_ratio"] > 2.0
    st = col._ann.stats()
    assert st["kind"] == "ivfpq"
    assert st["m"] == 8 and st["pq_k"] == 64


def test_joint_tune():
    col, v, q = make_col(n=3000, d=32, seed=13)
    col.build_ann(kind="ivfpq", nlist=32, nprobe=2, iters=6, m=8, pq_k=64,
                  pq_iters=8, rerank=4)
    npb, rr, rec = col._ann.tune(q, target_recall=0.95, k=10)
    assert rec >= 0.95
    assert col._ann.nprobe == npb and col._ann.rerank == rr
    # the tuned settings are what search now uses by default
    exact = ids_of(col.search_batch(q, k=10, exact=True))
    _, rows = col._ann.search(q, 10)
    assert recall_of(col, rows, exact) >= 0.9


def test_adc_onehot_matches_gather_reference():
    """The 4-bit one-hot matmul formulation must agree with the direct LUT
    gather on identical inputs."""
    import jax.numpy as jnp
    from fastpyvectordb_jax.ann.ivfpq import _adc_sum
    rng = np.random.default_rng(0)
    b, p, cmax, m, kk = 3, 2, 5, 8, 16
    lut = jnp.asarray(rng.standard_normal((b, m, kk)).astype(np.float32))
    codes = jnp.asarray(rng.integers(0, kk, (b, p, cmax, m)).astype(np.uint8))
    onehot = np.asarray(_adc_sum(lut, codes, m, kk, b, p, cmax))
    ref = np.zeros((b, p, cmax))
    ln, cn = np.asarray(lut), np.asarray(codes)
    for bi in range(b):
        for pi in range(p):
            for ci in range(cmax):
                ref[bi, pi, ci] = sum(ln[bi, mi, cn[bi, pi, ci, mi]]
                                      for mi in range(m))
    np.testing.assert_allclose(onehot, ref, rtol=2e-2, atol=2e-2)  # bf16 LUT


def test_default_8bit_build_recall():
    """The round-5 default is classic 8-bit PQ (K=256, m=d/8) — the
    codebook-quality lab measured it ordering ~2x better per bit than
    the 4-bit layout (benchmarks/pq_quality_lab.py)."""
    col, v, q = make_col(n=3000, d=32, seed=21)
    col.build_ann(kind="ivfpq", nlist=32, nprobe=8, iters=6, pq_iters=8)
    st = col._ann.stats()
    assert st["pq_k"] == 256 and st["m"] == 4  # 8-bit default: m = d/8
    exact = ids_of(col.search_batch(q, k=10, exact=True))
    _, rows = col._ann.search(q, 10, rerank=16)
    assert recall_of(col, rows, exact) >= 0.9


def test_legacy_4bit_layout_still_builds():
    col, v, q = make_col(n=3000, d=32, seed=21)
    col.build_ann(kind="ivfpq", nlist=32, nprobe=8, iters=6, pq_iters=8,
                  pq_k=16, m=8)
    st = col._ann.stats()
    assert st["pq_k"] == 16 and st["m"] == 8
    exact = ids_of(col.search_batch(q, k=10, exact=True))
    _, rows = col._ann.search(q, 10, rerank=16)
    assert recall_of(col, rows, exact) >= 0.9


# ---------------------------------------------------------------------------
# grouped (cell-major) dispatch — candidate-set equivalence with the
# per-query kernel when qcap sheds nothing (cells partition the corpus)
# ---------------------------------------------------------------------------

def test_grouped_matches_perquery(built):
    col, v, q = built
    d1, r1 = col._ann.search(q, 10, grouped=False)
    d2, r2 = col._ann.search(q, 10, grouped=True, qcap=64)
    assert col._ann.last_dropped == 0
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_allclose(d1, d2, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
def test_grouped_metrics(metric):
    col, v, q = make_col(metric=metric, n=2000, d=32, seed=7)
    col.build_ann(kind="ivfpq", nlist=32, nprobe=8, iters=4, m=8,
                  pq_k=16, pq_iters=4, rerank=8)
    d1, r1 = col._ann.search(q, 10, grouped=False)
    d2, r2 = col._ann.search(q, 10, grouped=True, qcap=64)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_allclose(d1, d2, rtol=1e-4, atol=1e-4)


def test_grouped_no_rerank_matches(built):
    """Without the exact re-rank the raw ADC rankings must agree up to
    summation-order noise: the per-query kernel sums the LUT in f32
    gather order at pq_k=64 while the grouped path contracts a bf16 LUT
    in a bf16 matmul, so near-ties at the k-cut may flip — scores
    must still match to bf16 tolerance and overlap must stay near-total."""
    col, v, q = built
    d1, r1 = col._ann.search(q, 10, grouped=False, rerank=0)
    d2, r2 = col._ann.search(q, 10, grouped=True, qcap=64, rerank=0)
    overlap = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                       for a, b in zip(r1, r2)])
    assert overlap >= 0.9, f"grouped/per-query overlap {overlap:.3f}"
    np.testing.assert_allclose(np.sort(d1, 1), np.sort(d2, 1),
                               rtol=5e-3, atol=5e-3)


def test_grouped_filtered(built):
    col, v, q = built
    res = col.search_batch(q, k=8, filter=Filter.eq("g", 2), exact=False)
    assert all(h.metadata["g"] == 2 for hits in res for h in hits)
    # force the grouped path with the same row mask
    mask = np.array([m is not None and m.get("g") == 2
                     for m in col._metadata], dtype=bool)
    d1, r1 = col._ann.search(q, 8, mask=mask, grouped=False)
    d2, r2 = col._ann.search(q, 8, mask=mask, grouped=True, qcap=64)
    np.testing.assert_array_equal(r1, r2)


def test_grouped_overflow_rows():
    """A tight cell-capacity factor forces overflow rows; the grouped
    tail must score them identically to the per-query kernel."""
    col, v, q = make_col(n=1500, d=32, seed=3)
    col.build_ann(kind="ivfpq", nlist=16, nprobe=4, iters=3, m=8,
                  pq_k=16, pq_iters=3, max_cell_factor=1.05,
                  spill_choices=2, rerank=8)
    assert int(np.asarray(col._ann.overflow_rows).size) > 0
    d1, r1 = col._ann.search(q, 10, grouped=False)
    d2, r2 = col._ann.search(q, 10, grouped=True, qcap=128)
    np.testing.assert_array_equal(r1, r2)


def test_grouped_saturated_qcap_still_serves(built):
    """qcap=8 deliberately sheds spill probes on hot cells: results must
    stay valid (no -1 rows at the top) and recall must degrade
    gracefully, not collapse."""
    col, v, q = built
    exact = ids_of(col.search_batch(q, k=10, exact=True))
    _, rows = col._ann.search(q, 10, grouped=True, qcap=8)
    assert col._ann.last_dropped > 0
    assert (rows[:, 0] >= 0).all()
    assert recall_of(col, rows, exact) >= 0.5


def test_grouped_auto_dispatch(built):
    """b * nprobe >= nlist flips to the grouped path by default."""
    col, v, q = built
    big_q = np.repeat(q, 8, axis=0)          # 128 queries, nlist=64
    d1, r1 = col._ann.search(big_q, 10)      # grouped=None -> grouped
    d2, r2 = col._ann.search(big_q, 10, grouped=False)
    np.testing.assert_array_equal(r1, r2)
