"""IVF ANN index tests: recall vs exact ground truth, filters, staleness."""

import numpy as np
import pytest

from fastpyvectordb_jax import Collection, CollectionConfig, Filter


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(11)
    n, d = 4000, 24
    centers = rng.standard_normal((32, d)).astype(np.float32) * 2
    v = centers[rng.integers(0, 32, n)] + 0.3 * rng.standard_normal(
        (n, d)).astype(np.float32)
    col = Collection(CollectionConfig(name="ann", dimensions=d, metric="l2"))
    col.insert_batch(v, [f"v{i}" for i in range(n)],
                     [{"g": i % 4} for i in range(n)])
    col.build_ann(nlist=64, nprobe=8, iters=6)
    q = centers[rng.integers(0, 32, 16)] + 0.3 * rng.standard_normal(
        (16, d)).astype(np.float32)
    return col, v, q


def ids_of(res):
    return [[h.id for h in hits] for hits in res]


def test_recall_vs_exact(built):
    col, v, q = built
    exact = ids_of(col.search_batch(q, k=10, exact=True))
    approx = ids_of(col.search_batch(q, k=10, exact=False))
    recall = np.mean([len(set(a) & set(e)) / 10 for a, e in zip(approx, exact)])
    assert recall >= 0.9, f"IVF recall@10 {recall:.3f} < 0.9"


def test_higher_nprobe_raises_recall(built):
    col, v, q = built
    exact = ids_of(col.search_batch(q, k=10, exact=True))
    lo_d, lo_r = col._ann.search(q, 10, nprobe=1)
    hi_d, hi_r = col._ann.search(q, 10, nprobe=32)
    def rec(rows):
        out = []
        for b, e in zip(rows, exact):
            ids = {col._row_to_id[int(r)] for r in b if r >= 0}
            out.append(len(ids & set(e)) / 10)
        return np.mean(out)
    assert rec(hi_r) >= rec(lo_r)
    assert rec(hi_r) >= 0.95


def test_grouped_matches_baseline_kernel(built):
    """The cell-major grouped dispatch (ann/ivf_grouped.py) must select
    exactly the same rows as the per-query-gather baseline when qcap
    drops nothing: cells partition the corpus, so per-slot top-k + merge
    and flat top-k over all probed cells see the same candidate set."""
    col, v, q = built
    rng = np.random.default_rng(3)
    qq = np.repeat(q, 8, axis=0) + 0.01 * rng.standard_normal(
        (len(q) * 8, q.shape[1])).astype(np.float32)
    base_d, base_r = col._ann.search(qq, 10, grouped=False)
    grp_d, grp_r = col._ann.search(qq, 10, grouped=True)
    assert col._ann.last_dropped == 0
    np.testing.assert_allclose(grp_d, base_d, atol=1e-4)
    # rows identical except possible exact-score ties
    mism = grp_r != base_r
    if mism.any():
        np.testing.assert_allclose(grp_d[mism], base_d[mism], atol=1e-4)


def test_grouped_respects_filter_mask(built):
    """A large filtered batch auto-routes to the grouped dispatch (b *
    nprobe >= nlist); the fused validity mask must still hold."""
    col, v, q = built
    res_g = col.search_batch(np.repeat(q, 8, axis=0), k=8,
                             filter=Filter.eq("g", 1), exact=False)
    assert all(h.metadata["g"] == 1 for hits in res_g for h in hits)
    assert all(len(hits) > 0 for hits in res_g)


def test_filtered_ann(built):
    col, v, q = built
    res = col.search_batch(q[:4], k=8, filter=Filter.eq("g", 2), exact=False)
    assert all(h.metadata["g"] == 2 for hits in res for h in hits)


def test_filtered_slot_masks_memoized_per_filter(built):
    """A REPEATED filter must not re-pay the slot gather: ok_slot_masks
    memoizes the filtered (okc, oko) per host-mask identity, which is
    stable because Collection._filter_mask caches the mask per
    (fingerprint, version)."""
    col, v, q = built
    f = Filter.eq("g", 3)
    res1 = col.search_batch(q[:4], k=8, filter=f, exact=False)
    fmemo = getattr(col._ann, "_okf_memo", None)
    assert fmemo is not None and len(fmemo) >= 1
    okc_before = next(iter(fmemo.values()))[3]
    # same filter again (fresh but fingerprint-equal object): memo hit —
    # the stored filtered mask object must be THE SAME device array
    res2 = col.search_batch(q[:4], k=8, filter=Filter.eq("g", 3),
                            exact=False)
    assert next(iter(fmemo.values()))[3] is okc_before
    assert ids_of(res1) == ids_of(res2)
    assert all(h.metadata["g"] == 3 for hits in res2 for h in hits)


def test_filtered_slot_mask_memo_invalidates_on_mutation():
    """A store mutation replaces the validity buffer; the filtered memo's
    identity guard must miss and recompute (a stale hit would keep serving
    a deleted row through the filtered ANN path)."""
    rng = np.random.default_rng(5)
    n, d = 600, 16
    v = rng.standard_normal((n, d)).astype(np.float32)
    col = Collection(CollectionConfig(name="fmemo", dimensions=d,
                                      metric="l2"))
    col.insert_batch(v, [f"r{i}" for i in range(n)],
                     [{"g": i % 2} for i in range(n)])
    col.build_ann(nlist=16, nprobe=16, iters=3)
    f = Filter.eq("g", 0)
    res = col.search_batch(v[:2], k=3, filter=f, exact=False)
    assert res[0][0].id == "r0"
    col.delete("r0")
    res = col.search_batch(v[:2], k=3, filter=f, exact=False)
    assert all(h.id != "r0" for hits in res for h in hits)
    assert all(h.metadata["g"] == 0 for hits in res for h in hits)


def test_tune_nprobe(built):
    col, v, q = built
    np_tuned = col._ann.tune_nprobe(q, target_recall=0.95, k=10)
    assert 1 <= np_tuned <= 64
    exact = ids_of(col.search_batch(q, k=10, exact=True))
    approx = ids_of(col.search_batch(q, k=10, exact=False))
    recall = np.mean([len(set(a) & set(e)) / 10 for a, e in zip(approx, exact)])
    assert recall >= 0.9


def test_insert_served_incrementally_without_rebuild(built, rng):
    """Inserting after build must NOT mark the index stale (hnswlib parity:
    live add_items); the new row is served by the exact tail merge."""
    col, v, q = built
    built_count = col._ann._built_count
    col.insert(rng.standard_normal(24).astype(np.float32) * 0.01, id="new1")
    assert not col._ann.stale
    assert col._ann._built_count == built_count  # no rebuild happened
    hits = col.search(col.get("new1", include_vector=True)["vector"], k=1,
                      exact=False)
    assert hits[0].id == "new1"
    assert col._ann._built_count == built_count  # still no rebuild


def test_ann_persistence_roundtrip(tmp_path, rng):
    from fastpyvectordb_jax.core.collection import Collection
    from fastpyvectordb_jax.core.types import CollectionConfig
    v = rng.standard_normal((500, 16)).astype(np.float32)
    col = Collection(CollectionConfig(name="p", dimensions=16, metric="l2"),
                     base_path=tmp_path / "p")
    col.insert_batch(v, [f"v{i}" for i in range(500)])
    col.build_ann(nlist=16, nprobe=8, iters=4)
    col.save()

    col2 = Collection(CollectionConfig(name="p", dimensions=16),
                      base_path=tmp_path / "p")
    assert col2._ann is not None and not col2._ann.stale
    assert col2.config.index == "ivf"
    hits = col2.search(v[42], k=1, exact=False)
    assert hits[0].id == "v42"


def test_graph_ann_persistence_roundtrip(tmp_path, rng):
    from fastpyvectordb_jax.core.collection import Collection
    from fastpyvectordb_jax.core.types import CollectionConfig
    v = rng.standard_normal((400, 16)).astype(np.float32)
    col = Collection(CollectionConfig(name="g", dimensions=16, metric="l2"),
                     base_path=tmp_path / "g")
    col.insert_batch(v, [f"v{i}" for i in range(400)])
    col.build_ann(kind="graph", r=8, chunk=256)
    col.save()

    col2 = Collection(CollectionConfig(name="g", dimensions=16),
                      base_path=tmp_path / "g")
    assert col2._ann is not None and col2.config.index == "graph"
    assert np.array_equal(np.asarray(col2._ann.neighbors),
                          np.asarray(col._ann.neighbors))
    hits = col2.search(v[7], k=1, exact=False)
    assert hits[0].id == "v7"


def test_batch_size_does_not_change_results(built):
    """Identical queries must return identical rows regardless of the
    internal sub-batch size (round-1 ROADMAP #14); the sub-batch is also
    memory-capped so huge batches chunk instead of OOMing the gather."""
    col, v, q = built
    rng = np.random.default_rng(3)
    centers = v[rng.integers(0, v.shape[0], 8)]
    qq = np.concatenate([q, centers + 0.1 * rng.standard_normal(
        (8, v.shape[1])).astype(np.float32)])  # 24 queries
    _, r_small = col._ann.search(qq, 5, max_query_batch=8)
    _, r_big = col._ann.search(qq, 5, max_query_batch=256)
    assert np.array_equal(r_small, r_big)


def test_ivf_int8_cells_recall_and_persistence(tmp_path, rng):
    from fastpyvectordb_jax.core.collection import Collection
    from fastpyvectordb_jax.core.types import CollectionConfig
    import numpy as np
    n, d = 3000, 24
    centers = rng.standard_normal((24, d)).astype(np.float32) * 2
    v = centers[rng.integers(0, 24, n)] + 0.3 * rng.standard_normal(
        (n, d)).astype(np.float32)
    col = Collection(CollectionConfig(name="q8", dimensions=d, metric="l2"),
                     base_path=tmp_path / "q8")
    col.insert_batch(v, [f"v{i}" for i in range(n)])
    col.build_ann(nlist=48, nprobe=12, iters=6, cell_dtype="int8")
    assert col._ann.cells.dtype == np.int8
    q = centers[rng.integers(0, 24, 12)] + 0.3 * rng.standard_normal(
        (12, d)).astype(np.float32)
    exact = [set(r.tolist()) for r in
             col._store.search(q, 10, col.config.metric)[1]]
    _, rows = col._ann.search(q, 10)
    rec = np.mean([len(set(r.tolist()) & e) / 10
                   for r, e in zip(rows, exact)])
    assert rec >= 0.9, f"int8-cell IVF recall {rec:.3f}"
    # persistence round-trips through re-encoding
    col.save()
    col2 = Collection(CollectionConfig(name="q8", dimensions=d),
                      base_path=tmp_path / "q8")
    assert col2._ann.cells.dtype == np.int8
    _, rows2 = col2._ann.search(q, 10)
    np.testing.assert_array_equal(rows, rows2)


def test_encode_cells_matches_corpus_stats():
    """_encode_cells (blockwise gather+encode, ann/ivf.py) must produce
    exactly the codes and dequantized norms the old full-corpus
    encode + corpus_stats path did — bit-identical, since both run the
    same _encode / dequant arithmetic."""
    import jax.numpy as jnp
    from fastpyvectordb_jax.ann.ivf import _encode_cells
    from fastpyvectordb_jax.quant.scalar import (ScalarQuantizer, _encode,
                                                 _train)
    rng = np.random.default_rng(3)
    n, d, nlist, cap = 1000, 32, 8, 256
    v = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    vmin, scale = _train(v)
    table = rng.integers(-1, n, (nlist, cap)).astype(np.int32)
    safe = jnp.maximum(jnp.asarray(table), 0)
    cells, norms = _encode_cells(v, safe, vmin, scale, blk=3)  # pad path
    qz = ScalarQuantizer(dims=d)
    qz.vmin, qz.scale = vmin, scale
    codes = _encode(v, vmin, scale)
    row_norms, _ = qz.corpus_stats(codes)
    exp_cells = jnp.take(codes, safe.reshape(-1), axis=0
                         ).reshape(nlist, cap, d)
    exp_norms = jnp.take(row_norms, safe.reshape(-1), axis=0
                         ).reshape(nlist, cap)
    np.testing.assert_array_equal(np.asarray(cells), np.asarray(exp_cells))
    np.testing.assert_allclose(np.asarray(norms), np.asarray(exp_norms),
                               rtol=1e-6)


def test_grouped_big_overflow_prereduce(built):
    """When the overflow block is large (> 4k columns) the grouped kernel
    pre-reduces it to k per query before the merge; planted overflow rows
    must still surface exactly."""
    import jax.numpy as jnp
    from fastpyvectordb_jax.ann.ivf_grouped import grouped_ivf_search_kernel
    from fastpyvectordb_jax.core.types import DistanceMetric
    col, v, q = built
    idx = col._ann
    store = col._store
    k = 5
    # synthetic big overflow: first 100 corpus rows as overflow entries,
    # padded far past 4*k so the pre-reduce branch compiles in
    orows = np.full(256, -1, np.int32)
    orows[:100] = np.arange(100)
    ovecs = jnp.take(store.vectors, jnp.asarray(
        np.maximum(orows, 0)), axis=0)
    cnorms = idx._cell_norms_cached()
    okc = (idx.row_table >= 0) & jnp.take(
        store.valid, jnp.maximum(idx.row_table, 0), axis=0)
    oko = (jnp.asarray(orows) >= 0) & jnp.take(
        store.valid, jnp.asarray(np.maximum(orows, 0)), axis=0)
    d_, r_, dropped = grouped_ivf_search_kernel(
        jnp.asarray(v[:8]), idx.centroids, idx.cells, idx.row_table,
        ovecs, jnp.asarray(orows), okc, oko,
        idx.quantizer.vmin if idx.quantizer else jnp.zeros(v.shape[1]),
        idx.quantizer.scale if idx.quantizer else jnp.ones(v.shape[1]),
        cnorms, metric=DistanceMetric.L2, k=k, nprobe=8, qcap=32)
    rows = np.asarray(r_)
    # query i IS corpus row i (also planted in overflow): must be its own
    # top hit whichever path found it
    assert (rows[:, 0] == np.arange(8)).all(), rows[:, 0]


def test_ivf_rerank_knob_grouped_and_perquery(tmp_path, rng):
    """int8-cell IVF ships rerank=4 by default (exact re-rank of the
    quantized top-c recovers ordering the int8 scores scramble); the knob
    threads through both dispatches, set_search_params, and persistence."""
    from fastpyvectordb_jax.core.collection import Collection
    from fastpyvectordb_jax.core.types import CollectionConfig
    n, d = 3000, 24
    centers = rng.standard_normal((24, d)).astype(np.float32) * 2
    v = centers[rng.integers(0, 24, n)] + 0.3 * rng.standard_normal(
        (n, d)).astype(np.float32)
    col = Collection(CollectionConfig(name="rr", dimensions=d, metric="l2"),
                     base_path=tmp_path / "rr")
    col.insert_batch(v, [f"v{i}" for i in range(n)])
    col.build_ann(nlist=48, nprobe=12, iters=6, cell_dtype="int8")
    assert col._ann.rerank == 4
    q = centers[rng.integers(0, 24, 16)] + 0.3 * rng.standard_normal(
        (16, d)).astype(np.float32)
    exact = [set(r.tolist()) for r in
             col._store.search(q, 10, col.config.metric)[1]]

    def recall(rows):
        return np.mean([len(set(r.tolist()) & e) / 10
                        for r, e in zip(rows, exact)])

    for grouped in (False, True):
        _, rows_rr = col._ann.search(q, 10, grouped=grouped)
        _, rows_raw = col._ann.search(q, 10, grouped=grouped, rerank=0)
        assert recall(rows_rr) >= recall(rows_raw) - 1e-9, grouped
    # runtime knob + persistence
    col.set_search_params(rerank=2)
    assert col._ann.rerank == 2
    col.save()
    col2 = Collection(CollectionConfig(name="rr", dimensions=d),
                      base_path=tmp_path / "rr")
    assert col2._ann.rerank == 2


def test_ok_memo_tracks_overflow_replacement(built):
    """ok_slot_masks memoizes on overflow_rows identity too: replacing the
    overflow block (bench tooling / sharded re-layout does this) must not
    serve a stale ok_overflow of the wrong shape."""
    import jax.numpy as jnp
    col, v, q = built
    idx = col._ann
    idx._ok_cached()  # populate the memo
    orows = jnp.asarray(np.arange(8, dtype=np.int32))
    idx.overflow_rows = orows
    idx.overflow_vecs = jnp.take(col._store.vectors, orows, axis=0)
    okc, oko = idx._ok_cached()
    assert oko.shape == (8,) and bool(oko.all())
    _, rows = idx.search(v[:8], 1)
    assert (rows[:, 0] == np.arange(8)).all()
