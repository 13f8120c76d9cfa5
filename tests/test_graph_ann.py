"""Graph ANN (neighbor-array beam search) tests: recall vs exact,
visited-set semantics, filters, staleness."""

import numpy as np
import pytest

from fastpyvectordb_jax import Collection, CollectionConfig, Filter
from fastpyvectordb_jax.ann.graph_ann import GraphANN


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(17)
    n, d = 3000, 24
    centers = rng.standard_normal((24, d)).astype(np.float32) * 2
    v = centers[rng.integers(0, 24, n)] + 0.4 * rng.standard_normal(
        (n, d)).astype(np.float32)
    col = Collection(CollectionConfig(name="g", dimensions=d, metric="l2"))
    col.insert_batch(v, [f"v{i}" for i in range(n)],
                     [{"m": i % 3} for i in range(n)])
    col.build_ann(kind="graph", r=16, chunk=1024, beam=64, iters=12)
    q = centers[rng.integers(0, 24, 16)] + 0.4 * rng.standard_normal(
        (16, d)).astype(np.float32)
    return col, v, q


def ids_of(res):
    return [[h.id for h in hits] for hits in res]


def test_graph_shape_and_no_self_loops(built):
    col, v, q = built
    ann = col._ann
    tbl = np.asarray(ann.neighbors)
    assert tbl.shape == (3000, 16)
    self_rows = (tbl == np.arange(3000)[:, None]).sum()
    assert self_rows == 0
    assert (tbl >= 0).all() and (tbl < 3000).all()


def test_recall_vs_exact(built):
    col, v, q = built
    exact = ids_of(col.search_batch(q, k=10, exact=True))
    approx = ids_of(col.search_batch(q, k=10, exact=False))
    recall = np.mean([len(set(a) & set(e)) / 10 for a, e in zip(approx, exact)])
    assert recall >= 0.9, f"graph ANN recall@10 {recall:.3f} < 0.9"


def test_results_are_deduplicated(built):
    col, v, q = built
    d, rows = col._ann.search(q, 10)
    for r in rows:
        real = r[r >= 0]
        assert len(set(real.tolist())) == len(real)


def test_wider_beam_not_worse(built):
    col, v, q = built
    _, exact_rows = col._store.search(q, 10, col.config.metric)
    def rec(rows):
        return np.mean([len(set(a.tolist()) & set(e.tolist())) / 10
                        for a, e in zip(rows, exact_rows)])
    _, narrow = col._ann.search(q, 10, beam=16, iters=4)
    _, wide = col._ann.search(q, 10, beam=128, iters=16)
    assert rec(wide) >= rec(narrow)
    assert rec(wide) >= 0.9


def test_filtered_graph_search(built):
    col, v, q = built
    res = col.search_batch(q[:4], k=5, filter=Filter.eq("m", 1), exact=False)
    assert all(h.metadata["m"] == 1 for hits in res for h in hits)
    assert any(hits for hits in res)


def test_tune(built):
    col, v, q = built
    out = col._ann.tune(q, target_recall=0.9, k=10)
    assert out["recall"] >= 0.9


def test_insert_served_via_tail_merge(built, rng):
    col, v, q = built
    col.insert(np.full(24, 7.5, dtype=np.float32), id="far")
    assert not col._ann.stale  # incremental: no rebuild on insert
    hits = col.search(np.full(24, 7.5, dtype=np.float32), k=1, exact=False)
    assert hits[0].id == "far"


def test_graph_ann_k_larger_than_beam(built):
    """Unfiltered k > beam must widen the beam, not silently truncate."""
    col, v, q = built
    import numpy as np
    old = col._ann.beam
    try:
        col.set_search_params(beam=16)
        hits = col.search(q[0], k=40, exact=False)
        assert len(hits) == 40, len(hits)
    finally:
        col.set_search_params(beam=old)


def test_deleted_rows_vanish_and_memo_refreshes(rng):
    """Tombstoned rows must not be returned (deleted neighbor targets are
    pre-masked to -1 in a memoized navigation table; a delete replaces
    store.valid, which must invalidate that memo)."""
    from fastpyvectordb_jax.core.collection import Collection
    from fastpyvectordb_jax.core.types import CollectionConfig
    n, d = 600, 16
    v = rng.standard_normal((n, d)).astype(np.float32)
    col = Collection(CollectionConfig(name="gdel", dimensions=d, metric="l2"))
    col.insert_batch(v, [f"v{i}" for i in range(n)])
    col.build_ann(kind="graph", r=8, chunk=256)
    _, rows = col._ann.search(v[:8], 1)
    assert (rows[:, 0] == np.arange(8)).all()
    col.delete_batch([f"v{i}" for i in range(8)])
    _, rows = col._ann.search(v[:16], 5)
    assert not (set(rows.ravel().tolist()) & set(range(8))), rows[:, 0]
    # the survivors must still be reachable through the masked table
    assert (rows[8:, 0] == np.arange(8, 16)).all()


def test_n_init_and_device_out_overrides(built):
    """Per-call n_init (entry-point count) and device_out (skip the host
    fetch) must not change result semantics (ROADMAP #22 sweep surface)."""
    col, v, q = built
    ann = col._ann
    vals, rows = ann.search(q[:4], 5, n_init=4)
    assert isinstance(rows, np.ndarray) and rows.shape == (4, 5)
    dvals, drows = ann.search(q[:4], 5, n_init=4, device_out=True)
    assert not isinstance(drows, np.ndarray)  # stays on device
    assert np.array_equal(np.asarray(drows), rows)
    assert np.allclose(np.asarray(dvals), vals)
    # a generous n_init can only help recall vs a starved one
    _, wide = ann.search(q[:4], 5, n_init=ann.medoids.shape[0])
    assert wide.shape == (4, 5)


def test_zero_iter_override_is_respected():
    """iters=0 must mean ZERO expansion rounds (entry points only), not a
    silent fallback to the built default — sweeps measuring the
    no-expansion corner would otherwise attribute default-config numbers
    to the wrong configuration."""
    import numpy as np
    from fastpyvectordb_jax import Collection, CollectionConfig
    rng = np.random.default_rng(0)
    col = Collection(CollectionConfig(name="g0", dimensions=16, metric="l2"))
    col.insert_batch(rng.standard_normal((800, 16)).astype(np.float32),
                     [f"v{i}" for i in range(800)])
    col.build_ann(kind="graph", r=8, n_entries=64, iters=6)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    _, r_def = col._ann.search(q, 5)
    _, r0 = col._ann.search(q, 5, iters=0)
    assert r0.shape == (4, 5)
    assert not np.array_equal(r0, r_def)  # 0 rounds != 6 rounds
