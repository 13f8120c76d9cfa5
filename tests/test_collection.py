"""Core Collection + VectorDB behavior tests (reference parity:
vectordb_optimized.py CRUD/search/persistence semantics)."""

import numpy as np
import pytest

from fastpyvectordb_jax import (
    Collection,
    CollectionConfig,
    DistanceMetric,
    Filter,
    VectorDB,
)


def make_collection(metric="cosine", dims=16, **kw):
    return Collection(CollectionConfig(name="t", dimensions=dims,
                                       metric=metric, **kw))


def test_insert_and_count(rng):
    col = make_collection()
    ids = col.insert_batch(rng.standard_normal((10, 16)).astype(np.float32))
    assert col.count() == 10 and len(ids) == 10
    col.insert(rng.standard_normal(16).astype(np.float32), id="x")
    assert col.count() == 11
    assert col.get("x") is not None


def test_duplicate_id_rejected(rng):
    col = make_collection()
    col.insert(rng.standard_normal(16), id="a")
    with pytest.raises(ValueError):
        col.insert(rng.standard_normal(16), id="a")


def test_dimension_mismatch_rejected(rng):
    col = make_collection(dims=8)
    with pytest.raises(ValueError):
        col.insert(rng.standard_normal(16))


def test_search_returns_self_nearest(rng):
    col = make_collection(metric="cosine")
    v = rng.standard_normal((50, 16)).astype(np.float32)
    ids = [f"v{i}" for i in range(50)]
    col.insert_batch(v, ids)
    hits = col.search(v[7], k=1)
    assert hits[0].id == "v7"
    assert hits[0].score == pytest.approx(0.0, abs=1e-3)


@pytest.mark.parametrize("metric", ["cosine", "l2", "ip"])
def test_search_matches_numpy_ranking(rng, metric):
    col = make_collection(metric=metric)
    v = rng.standard_normal((40, 16)).astype(np.float32)
    col.insert_batch(v, [f"v{i}" for i in range(40)])
    q = rng.standard_normal(16).astype(np.float32)
    hits = col.search(q, k=5)
    if metric == "cosine":
        qn, vn = q / np.linalg.norm(q), v / np.linalg.norm(v, axis=1, keepdims=True)
        want = np.argsort(1 - vn @ qn)[:5]
    elif metric == "l2":
        want = np.argsort(np.linalg.norm(v - q, axis=1))[:5]
    else:
        want = np.argsort(-(v @ q))[:5]
    assert [h.id for h in hits] == [f"v{i}" for i in want]


def test_filtered_search(rng):
    col = make_collection()
    v = rng.standard_normal((30, 16)).astype(np.float32)
    metas = [{"cat": "a" if i % 2 == 0 else "b", "n": i} for i in range(30)]
    col.insert_batch(v, [f"v{i}" for i in range(30)], metas)
    hits = col.search(v[0], k=30, filter=Filter.eq("cat", "b"))
    assert hits and all(h.metadata["cat"] == "b" for h in hits)
    assert len(hits) == 15
    hits = col.search(v[0], k=30,
                      filter=Filter.and_([Filter.eq("cat", "a"),
                                          Filter.lt("n", 10)]))
    assert {h.id for h in hits} == {f"v{i}" for i in range(0, 10, 2)}


def test_filter_no_match_returns_empty(rng):
    col = make_collection()
    col.insert_batch(rng.standard_normal((5, 16)), [f"v{i}" for i in range(5)],
                     [{"x": 1}] * 5)
    assert col.search(rng.standard_normal(16), k=3,
                      filter=Filter.eq("x", 99)) == []


def test_delete_and_tombstone(rng):
    col = make_collection()
    v = rng.standard_normal((10, 16)).astype(np.float32)
    col.insert_batch(v, [f"v{i}" for i in range(10)])
    assert col.delete("v3")
    assert not col.delete("v3")
    assert col.count() == 9
    assert col.get("v3") is None
    hits = col.search(v[3], k=10)
    assert "v3" not in [h.id for h in hits]


def test_compact_reclaims_and_preserves(rng):
    col = make_collection()
    v = rng.standard_normal((20, 16)).astype(np.float32)
    col.insert_batch(v, [f"v{i}" for i in range(20)])
    col.delete_batch([f"v{i}" for i in range(0, 20, 2)])
    reclaimed = col.compact()
    assert reclaimed == 10 and col.count() == 10
    hits = col.search(v[7], k=1)
    assert hits[0].id == "v7"
    got = col.get("v9", include_vector=True)
    np.testing.assert_allclose(got["vector"], v[9], rtol=1e-6)


def test_upsert(rng):
    col = make_collection()
    a, b = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    col.upsert(a, "x", {"ver": 1})
    col.upsert(b, "x", {"ver": 2})
    assert col.count() == 1
    got = col.get("x", include_vector=True)
    assert got["metadata"]["ver"] == 2
    np.testing.assert_allclose(got["vector"], b, rtol=1e-6)


def test_get_batch_with_vectors(rng):
    col = make_collection()
    v = rng.standard_normal((5, 16)).astype(np.float32)
    col.insert_batch(v, [f"v{i}" for i in range(5)], [{"i": i} for i in range(5)])
    out = col.get_batch(["v1", "nope", "v4"], include_vectors=True)
    assert out[1] is None
    np.testing.assert_allclose(out[0]["vector"], v[1], rtol=1e-6)
    np.testing.assert_allclose(out[2]["vector"], v[4], rtol=1e-6)


def test_search_batch(rng):
    col = make_collection(metric="l2")
    v = rng.standard_normal((64, 16)).astype(np.float32)
    col.insert_batch(v, [f"v{i}" for i in range(64)])
    res = col.search_batch(v[[3, 9, 41]], k=1)
    assert [r[0].id for r in res] == ["v3", "v9", "v41"]


def test_growth_beyond_initial_capacity(rng):
    col = make_collection()
    v = rng.standard_normal((1500, 16)).astype(np.float32)
    col.insert_batch(v[:600], [f"a{i}" for i in range(600)])
    col.insert_batch(v[600:], [f"b{i}" for i in range(900)])
    assert col.count() == 1500
    assert col.search(v[1200], k=1)[0].id == "b600"


def test_persistence_roundtrip(rng, tmp_db_path):
    db = VectorDB(str(tmp_db_path))
    col = db.create_collection("docs", 16, metric="l2")
    v = rng.standard_normal((25, 16)).astype(np.float32)
    col.insert_batch(v, [f"v{i}" for i in range(25)],
                     [{"i": i, "tag": "t"} for i in range(25)])
    col.delete("v5")
    db.save()

    db2 = VectorDB(str(tmp_db_path))
    assert db2.list_collections() == ["docs"]
    col2 = db2["docs"]
    assert col2.count() == 24
    assert col2.config.metric == DistanceMetric.L2
    assert col2.get("v5") is None
    assert col2.search(v[8], k=1)[0].id == "v8"
    assert col2.get("v8")["metadata"]["i"] == 8


def test_vectordb_collection_management(tmp_db_path):
    db = VectorDB(str(tmp_db_path))
    db.create_collection("a", 8)
    db.create_collection("b", 8)
    with pytest.raises(ValueError):
        db.create_collection("a", 8)
    assert db.list_collections() == ["a", "b"]
    assert db.delete_collection("a")
    assert not db.delete_collection("a")
    assert "a" not in db
    with pytest.raises(KeyError):
        db.get_collection("a")


def test_update_metadata(rng):
    col = make_collection()
    col.insert(rng.standard_normal(16), "x", {"a": 1, "b": 2})
    col.update_metadata("x", {"b": 3, "c": 4})
    assert col.get("x")["metadata"] == {"a": 1, "b": 3, "c": 4}
    col.update_metadata("x", {"only": 1}, merge=False)
    assert col.get("x")["metadata"] == {"only": 1}


def test_include_vectors_alignment_under_filter(rng):
    # vectors returned with hits must be each hit's own vector even when
    # candidate slots are interleaved with masked-out entries
    col = make_collection(metric="l2")
    v = rng.standard_normal((40, 16)).astype(np.float32)
    col.insert_batch(v, [f"v{i}" for i in range(40)],
                     [{"odd": i % 2} for i in range(40)])
    hits = col.search(v[0], k=8, filter=Filter.eq("odd", 1),
                      include_vectors=True)
    assert hits
    for h in hits:
        idx = int(h.id[1:])
        np.testing.assert_allclose(h.vector, v[idx], rtol=1e-5)


def test_topk_approx_config(rng):
    # approx config must trace and return plausible hits on CPU too
    col = make_collection(metric="l2", topk="approx")
    v = rng.standard_normal((200, 16)).astype(np.float32)
    col.insert_batch(v, [f"v{i}" for i in range(200)])
    hits = col.search(v[17], k=5)
    assert hits[0].id == "v17"


def test_search_quantized_empty_collection():
    from fastpyvectordb_jax import Collection, CollectionConfig
    col = Collection(CollectionConfig(name="eq", dimensions=8, metric="l2"))
    out = col.search_quantized(np.zeros((2, 8), np.float32), k=3)
    assert out == [[], []]


def test_search_quantized_no_rerank_tail_merge_units():
    """With rerank<=1 the coarse scan returns squared-L2 (int8) scores;
    merging them against the exact sqrt'd tail must not misorder."""
    from fastpyvectordb_jax import Collection, CollectionConfig
    rng = np.random.default_rng(3)
    col = Collection(CollectionConfig(name="um", dimensions=16,
                                      metric="l2"))
    base = rng.standard_normal((256, 16)).astype(np.float32) + 4.0
    col.insert_batch(base, [f"v{i}" for i in range(256)])
    col.enable_quantized_scan("int8")
    # tail rows appended AFTER the snapshot: one is the exact query
    q = rng.standard_normal(16).astype(np.float32)
    col.insert_batch(np.stack([q, q + 0.01]), ["exact", "near"])
    hits = col.search_quantized(q[None, :], k=3)[0]
    assert hits[0].id == "exact", [h.id for h in hits]
    assert hits[1].id == "near"
    # scores are in exact units (monotone nondecreasing, finite)
    scores = [h.score for h in hits]
    assert scores == sorted(scores) and all(np.isfinite(scores))


def test_ann_drift_rebuild_keeps_build_params():
    """The drift-triggered rebuild must reuse the caller's build kwargs
    (spill_choices etc.), not silently fall back to defaults."""
    from fastpyvectordb_jax import Collection, CollectionConfig
    rng = np.random.default_rng(5)
    col = Collection(CollectionConfig(name="bp", dimensions=8, metric="l2"))
    col.insert_batch(rng.standard_normal((600, 8)).astype(np.float32),
                     [f"v{i}" for i in range(600)])
    col.build_ann(kind="ivf", nlist=8, nprobe=2, iters=2, spill_choices=4,
                  max_cell_factor=2.0)
    assert col._ann._build_kwargs["spill_choices"] == 4
    # grow past the rebuild threshold and search -> in-place rebuild
    col.insert_batch(rng.standard_normal((400, 8)).astype(np.float32),
                     [f"w{i}" for i in range(400)])
    col._ann.stale = True
    col.search(rng.standard_normal(8).astype(np.float32), k=3, exact=False)
    assert col._ann._build_kwargs["spill_choices"] == 4


def test_prewarm_compiles_enabled_paths():
    """prewarm() dispatches every pow2 batch size for each enabled mode
    (the deployment-startup compile-cache priming hook, ROADMAP #11)."""
    from fastpyvectordb_jax import Collection, CollectionConfig
    rng = np.random.default_rng(9)
    col = Collection(CollectionConfig(name="pw", dimensions=8, metric="l2"))
    assert col.prewarm() == {}  # empty collection: nothing to compile
    col.insert_batch(rng.standard_normal((300, 8)).astype(np.float32),
                     [f"v{i}" for i in range(300)])
    t = col.prewarm(max_batch=4)
    assert set(t) == {"exact_b1", "exact_b2", "exact_b4"}
    assert all(v >= 0 for v in t.values())
    # enabling quantized + ANN paths widens the prewarm set
    col.enable_quantized_scan("int8", tune=False)
    col.build_ann(kind="ivf", nlist=4, nprobe=2, iters=2)
    t = col.prewarm(max_batch=2)
    assert set(t) == {"exact_b1", "exact_b2", "quantized_b1",
                      "quantized_b2", "ann_b1", "ann_b2"}
    # modes filter restricts it
    t = col.prewarm(max_batch=1, modes=("exact",))
    assert set(t) == {"exact_b1"}


def test_prewarm_covers_non_pow2_max_batch():
    """store.search pads every batch to the next pow2, so prewarm must
    compile the COVERING bucket of a non-pow2 max_batch (3 -> 4), not
    stop below it."""
    from fastpyvectordb_jax import Collection, CollectionConfig
    rng = np.random.default_rng(1)
    col = Collection(CollectionConfig(name="pw2", dimensions=8, metric="l2"))
    col.insert_batch(rng.standard_normal((100, 8)).astype(np.float32),
                     [f"v{i}" for i in range(100)])
    t = col.prewarm(max_batch=3)
    assert set(t) == {"exact_b1", "exact_b2", "exact_b4"}


def test_optimize_installs_cheapest_eligible_mode(tmp_path):
    """optimize() picks the mode with the lowest measured time per query
    among those clearing the recall target, installs it as the search()
    default, and the choice survives save/load."""
    from fastpyvectordb_jax import Collection, CollectionConfig
    rng = np.random.default_rng(7)
    n, d = 5000, 32
    v = rng.standard_normal((n, d)).astype(np.float32)
    col = Collection(CollectionConfig(name="opt", dimensions=d,
                                      metric="l2"),
                     base_path=tmp_path / "opt")
    col.insert_batch(v, [f"v{i}" for i in range(n)])
    report = col.optimize(target_recall=0.9, k=5)
    assert report["exact"]["eligible"]
    assert report["quantized"]["recall"] >= 0.9
    # every mode carries the fields the report contract promises
    for mode in ("exact", "quantized"):
        assert report[mode]["us_per_query"] > 0
        assert report[mode]["bytes_per_query"] > 0
        assert report[mode]["flops_per_query"] > 0
    # the installed mode is the fastest measured among the eligible
    eligible = {m: v for m, v in report.items()
                if isinstance(v, dict) and v.get("eligible")}
    assert report["installed"] == min(
        eligible, key=lambda m: eligible[m]["us_per_query"])
    # the installed default actually routes search() correctly
    hits = col.search(v[11], k=3)
    assert hits[0].id == "v11"
    # explicit exact still overrides
    hits = col.search(v[11], k=3, exact=True)
    assert hits[0].id == "v11"
    col.save()
    col2 = Collection(CollectionConfig(name="opt", dimensions=d,
                                       metric="l2"),
                      base_path=tmp_path / "opt")
    assert col2._serving_mode == report["installed"]
    assert col2.search(v[11], k=3)[0].id == "v11"


def test_optimize_tiny_corpus_stays_exact():
    from fastpyvectordb_jax import Collection, CollectionConfig
    rng = np.random.default_rng(8)
    col = Collection(CollectionConfig(name="opt2", dimensions=8,
                                      metric="cosine"))
    col.insert_batch(rng.standard_normal((50, 8)).astype(np.float32),
                     [f"v{i}" for i in range(50)])
    report = col.optimize()
    # 50 rows: no quantizer build (below the 4096 floor), exact wins
    assert report["installed"] == "exact"
    assert col.search(rng.standard_normal(8).astype(np.float32),
                      k=3) is not None


def test_optimize_ranks_ivfpq_by_cost_not_bytes(tmp_path):
    """With an IVF-PQ index built, optimize() reports the bytes per query
    (where IVF-PQ looks cheapest — codes are ~M/D of the store row and
    only the probed fraction streams) and the flops per query (where the
    ADC one-hot's M*K MACs/row count), but ranks by the measured time.
    Whatever wins, the installed choice must be the measured argmin and
    survive save/load."""
    from fastpyvectordb_jax import Collection, CollectionConfig
    rng = np.random.default_rng(9)
    n, d = 6000, 64
    v = rng.standard_normal((n, d)).astype(np.float32)
    col = Collection(CollectionConfig(name="optpq", dimensions=d,
                                      metric="l2"),
                     base_path=tmp_path / "optpq")
    col.insert_batch(v, [f"v{i}" for i in range(n)])
    col.enable_quantized_scan("int8")
    col.build_ann("ivfpq", nlist=64, m=16, tune_target=0.9)
    report = col.optimize(target_recall=0.9, k=5, build=False)
    assert "ann" in report and "quantized" in report
    # bytes view: the exact scan streams the f32 corpus once per
    # serving batch (optimize's default serving_batch=256)
    assert report["exact"]["bytes_per_query"] == pytest.approx(
        n * d * 4 / 256)
    # ...and its one-hot ADC does more flops per row than its bytes say
    assert (report["ann"]["flops_per_query"]
            / report["ann"]["bytes_per_query"]
            > report["exact"]["flops_per_query"]
            / report["exact"]["bytes_per_query"])
    # ...but the ranking is the measured time, not either estimate
    eligible = {m: v for m, v in report.items()
                if isinstance(v, dict) and v.get("eligible")}
    assert report["installed"] == min(
        eligible, key=lambda m: eligible[m]["us_per_query"])
    hits = col.search(v[42], k=3)
    assert hits[0].id == "v42"
    col.save()
    col2 = Collection(CollectionConfig(name="optpq", dimensions=d,
                                       metric="l2"),
                      base_path=tmp_path / "optpq")
    assert col2._serving_mode == report["installed"]
    assert col2.search(v[42], k=3)[0].id == "v42"


@pytest.mark.parametrize("mode", ["exact", "int8", "pq", "ivf", "ivfpq",
                                  "graph"])
def test_costmodel_counts_work_from_shapes(mode):
    """The cost model counts bytes and flops per query from shapes alone:
    check each mode against its formula at 1M x 768, B=1024."""
    from fastpyvectordb_jax.core import costmodel as cm
    n, d, b = 1_000_000, 768, 1024
    if mode == "exact":
        mc = cm.exact_cost(n, d, 2, b)
        want_bytes, want_flops = n * d * 2 / b, 2.0 * n * d
    elif mode == "int8":
        mc = cm.quantized_cost(n, d, "int8", d, 2, 40, b)
        want_bytes = n * d / b + 40 * d * 2
        want_flops = 2.0 * n * d + 2.0 * 40 * d
    elif mode == "pq":
        mc = cm.quantized_cost(n, d, "pq", 96, 2, 40, b, pq_k=256)
        want_bytes = n * 96 / b + 40 * d * 2
        want_flops = 2.0 * n * 96 * 256 + 2.0 * 40 * d
    elif mode == "ivf":
        mc = cm.ivf_cost(n, d, d, 2048, 8, 0, 2, 40, b)
        rows = 8 / 2048 * n * 1.25
        want_bytes = n * 1.25 * d / b + 40 * d * 2   # every cell touched
        want_flops = 2.0 * rows * d + 2.0 * 2048 * d + 2.0 * 40 * d
    elif mode == "ivfpq":
        mc = cm.ivf_cost(n, d, 192, 2048, 16, 0, 2, 1280, b, pq_k=16)
        rows = 16 / 2048 * n * 1.25
        want_bytes = n * 1.25 * 192 / b + 1280 * d * 2
        want_flops = (2.0 * rows * 192 * 16 + 2.0 * 2048 * d
                      + 2.0 * 1280 * d)
    else:
        mc = cm.graph_cost(d, 2, 128, 16, 4, 32)
        rows = 16 * 128 * 4 * 32
        want_bytes, want_flops = rows * d * 2, 2.0 * rows * d
    assert mc.bytes == pytest.approx(want_bytes)
    assert mc.flops == pytest.approx(want_flops)


def test_search_arrays_stream_matches_sync(rng):
    """The pipelined stream yields exactly search_arrays' triples, in
    input order, across uneven batch sizes (round-4 verdict #5)."""
    col = make_collection(dims=24)
    col.insert_batch(rng.standard_normal((300, 24), dtype=np.float32),
                     [f"v{i}" for i in range(300)])
    batches = [rng.standard_normal((b, 24), dtype=np.float32)
               for b in (1, 7, 32, 3)]
    got = list(col.search_arrays_stream(iter(batches), k=5, depth=2))
    assert len(got) == len(batches)
    for q, (ids, scores, rows) in zip(batches, got):
        eids, escores, erows = col.search_arrays(q, k=5)
        assert (ids == eids).all()
        np.testing.assert_allclose(scores, escores, rtol=1e-5)
        assert (rows == erows).all()


def test_search_arrays_stream_empty_and_filtered(rng):
    col = make_collection(dims=8)
    # empty store: placeholder triples of the right shape
    (ids, scores, rows), = col.search_arrays_stream(
        iter([np.zeros((2, 8), np.float32)]), k=4)
    assert ids.shape == (2, 4) and (rows == -1).all()
    col.insert_batch(rng.standard_normal((50, 8), dtype=np.float32),
                     [f"v{i}" for i in range(50)],
                     [{"grp": i % 2} for i in range(50)])
    q = rng.standard_normal((3, 8), dtype=np.float32)
    flt = Filter().eq("grp", 1)
    (sids, _, srows), = col.search_arrays_stream(iter([q]), k=6, filter=flt)
    eids, _, erows = col.search_arrays(q, k=6, filter=flt)
    assert (srows == erows).all() and (sids == eids).all()


def test_search_arrays_stream_int8_wire_high_overlap(rng):
    """int8 query-wire codes perturb ordering only marginally: overlap@10
    vs the default wire stays >= 0.9 on a random corpus."""
    col = make_collection(dims=32)
    col.insert_batch(rng.standard_normal((2000, 32), dtype=np.float32),
                     [f"v{i}" for i in range(2000)])
    q = rng.standard_normal((16, 32), dtype=np.float32)
    (_, _, r8), = col.search_arrays_stream(iter([q]), k=10,
                                           wire_dtype="int8")
    _, _, rref = col.search_arrays(q, k=10)
    overlap = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                       for a, b in zip(r8, rref)])
    assert overlap >= 0.9


def test_search_arrays_stream_ann_fallback(rng):
    """With an installed non-exact serving mode the stream degrades to
    synchronous per-batch calls but still yields one triple per batch."""
    col = make_collection(dims=16)
    col.insert_batch(rng.standard_normal((600, 16), dtype=np.float32),
                     [f"v{i}" for i in range(600)])
    col.build_ann("ivf", nlist=8, tune=False)
    batches = [rng.standard_normal((4, 16), dtype=np.float32)
               for _ in range(3)]
    got = list(col.search_arrays_stream(iter(batches), k=5))
    assert len(got) == 3
    for q, (ids, scores, rows) in zip(batches, got):
        eids, _, erows = col.search_arrays(q, k=5)
        assert (rows == erows).all()
