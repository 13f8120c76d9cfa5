"""Sharded IVF + sharded int8 two-stage search on the 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from fastpyvectordb_jax import Collection, CollectionConfig
from fastpyvectordb_jax.dist.mesh import make_mesh
from fastpyvectordb_jax.dist.sharded_ann import ShardedInt8, ShardedIVF

D = 16


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8
    return make_mesh()


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(5)
    n = 4096
    centers = rng.standard_normal((24, D)).astype(np.float32) * 2
    v = centers[rng.integers(0, 24, n)] + 0.25 * rng.standard_normal(
        (n, D)).astype(np.float32)
    col = Collection(CollectionConfig(name="sh", dimensions=D, metric="l2"))
    col.insert_batch(v, [f"v{i}" for i in range(n)])
    q = centers[rng.integers(0, 24, 8)] + 0.25 * rng.standard_normal(
        (8, D)).astype(np.float32)
    exact = [set(r.tolist()) for r in _exact_rows(col, q, 10)]
    return col, v, q, exact


def _exact_rows(col, q, k):
    _, rows = col._store.search(q, k, col.config.metric)
    return rows


def test_sharded_ivf_recall(built, mesh):
    col, v, q, exact = built
    col.build_ann(kind="ivf", nlist=64, nprobe=12, iters=5)
    sh = ShardedIVF.from_index(mesh, col._ann)
    d, rows = sh.search(q, 10)
    assert rows.shape == (8, 10)
    recall = np.mean([len(set(r.tolist()) & e) / 10
                      for r, e in zip(rows, exact)])
    assert recall >= 0.9, f"sharded IVF recall {recall:.3f}"
    # distances must be sorted ascending per query
    assert all(np.all(np.diff(row) >= -1e-5) for row in d)


def test_sharded_ivf_respects_tombstones(built, mesh):
    col, v, q, exact = built
    if col._ann is None:
        col.build_ann(kind="ivf", nlist=64, nprobe=12, iters=5)
    # tombstone the exact nearest of q[0]
    _, r = col._store.search(q[:1], 1, col.config.metric)
    dead = int(r[0, 0])
    valid = np.asarray(col._store.valid).copy()
    valid[dead] = False
    sh = ShardedIVF.from_index(mesh, col._ann, validmask=valid)
    _, rows = sh.search(q[:1], 10)
    assert dead not in rows[0].tolist()


def test_sharded_ivf_overflow_rows_reachable(mesh):
    """Rows that spilled to the overflow block must stay findable."""
    rng = np.random.default_rng(9)
    n = 1024
    v = rng.standard_normal((n, D)).astype(np.float32)
    col = Collection(CollectionConfig(name="ov", dimensions=D, metric="l2"))
    col.insert_batch(v, [f"v{i}" for i in range(n)])
    # tiny cells force overflow
    col.build_ann(kind="ivf", nlist=32, nprobe=8, iters=4,
                  max_cell_factor=0.6, spill_choices=2)
    overflow = np.asarray(col._ann.overflow_rows)
    overflow = overflow[overflow >= 0]
    if overflow.size == 0:
        pytest.skip("no overflow produced")
    sh = ShardedIVF.from_index(mesh, col._ann)
    probe = v[overflow[:4]]
    _, rows = sh.search(probe, 5)
    for qi, want in enumerate(overflow[:4]):
        assert want in rows[qi].tolist()


def test_sharded_int8_matches_single_chip(built, mesh):
    col, v, q, exact = built
    scan = col.enable_quantized_scan("int8")
    sh = ShardedInt8.from_scan(mesh, scan)
    d, rows = sh.search(q, 10, rerank=4)
    assert rows.shape == (8, 10)
    recall = np.mean([len(set(r.tolist()) & e) / 10
                      for r, e in zip(rows, exact)])
    assert recall >= 0.95, f"sharded int8 recall {recall:.3f}"
    # agreement with the single-chip quantized path
    d1, r1 = scan.search(q, 10, rerank=4)
    agree = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                     for a, b in zip(rows, r1)])
    assert agree >= 0.9


def test_sharded_int4_matches_single_chip(built, mesh):
    """kind="int4" rides the same sharded scan with half the per-shard
    coarse bytes; a deeper candidate pool covers the coarser ordering."""
    col, v, q, exact = built
    scan = col.enable_quantized_scan("int4")
    assert scan.kind == "int4"
    sh = ShardedInt8.from_scan(mesh, scan)
    assert sh.codec == "int4"
    d, rows = sh.search(q, 10, rerank=8)
    assert rows.shape == (8, 10)
    recall = np.mean([len(set(r.tolist()) & e) / 10
                      for r, e in zip(rows, exact)])
    assert recall >= 0.9, f"sharded int4 recall {recall:.3f}"
    d1, r1 = scan.search(q, 10, rerank=8)
    agree = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                     for a, b in zip(rows, r1)])
    assert agree >= 0.9
    col.enable_quantized_scan("int8")  # restore for downstream tests


def test_sharded_int8_respects_tombstones(built, mesh):
    col, v, q, exact = built
    if col._quantized is None:
        col.enable_quantized_scan("int8")
    _, r = col._store.search(q[:1], 1, col.config.metric)
    dead = int(r[0, 0])
    col.delete(f"v{dead}")
    sh = ShardedInt8.from_scan(mesh, col._quantized)
    _, rows = sh.search(q[:1], 10)
    assert dead not in rows[0].tolist()


def test_sharded_ivfpq_recall(built, mesh):
    from fastpyvectordb_jax.dist.sharded_ann import ShardedIVFPQ
    col, v, q, exact = built
    col.build_ann(kind="ivfpq", nlist=64, nprobe=12, iters=5, m=8, pq_k=64,
                  pq_iters=8, rerank=16)
    sh = ShardedIVFPQ.from_index(mesh, col._ann)
    d, rows = sh.search(q, 10)
    assert rows.shape == (8, 10)
    recall = np.mean([len(set(r.tolist()) & e) / 10
                      for r, e in zip(rows, exact)])
    assert recall >= 0.85, f"sharded IVF-PQ recall {recall:.3f}"
    assert all(np.all(np.diff(row) >= -1e-5) for row in d)
    # the sharded search must agree with the single-chip index on top-1
    d1, r1 = col._ann.search(q, 10, rerank=16)
    agree = np.mean(rows[:, 0] == r1[:, 0])
    assert agree >= 0.75, f"top-1 agreement {agree}"


def test_sharded_ivfpq_tombstones(built, mesh):
    from fastpyvectordb_jax.dist.sharded_ann import ShardedIVFPQ
    col, v, q, exact = built
    if col._ann is None or type(col._ann).__name__ != "IVFPQIndex":
        col.build_ann(kind="ivfpq", nlist=64, nprobe=12, iters=5, m=8,
                      pq_k=64, pq_iters=8, rerank=16)
    _, r = col._store.search(q[:1], 1, col.config.metric)
    dead = int(r[0, 0])
    vm = np.asarray(col._store.valid[:col._store.count]).copy()
    vm[dead] = False
    sh = ShardedIVFPQ.from_index(mesh, col._ann, validmask=vm)
    _, rows = sh.search(q[:1], 10)
    assert dead not in rows[0].tolist()


def test_sharded_ivfpq_grouped_matches_perquery(built, mesh):
    """The in-shard grouped (cell-major) ADC dispatch must produce the
    same exact-re-ranked results as the per-query one-hot path: cells
    partition the corpus, so cell-major scoring + regroup is a
    reordering of the per-query candidate scan, and phase 2 re-scores
    both candidate sets exactly."""
    from fastpyvectordb_jax.dist.sharded_ann import ShardedIVFPQ
    col, v, q, exact = built
    if col._ann is None or type(col._ann).__name__ != "IVFPQIndex":
        col.build_ann(kind="ivfpq", nlist=64, nprobe=12, iters=5, m=8,
                      pq_k=64, pq_iters=8, rerank=16)
    sh = ShardedIVFPQ.from_index(mesh, col._ann)

    rng = np.random.default_rng(11)
    qb = np.asarray(v[rng.integers(0, v.shape[0], 64)]
                    + 0.1 * rng.standard_normal((64, D)), dtype=np.float32)
    assert qb.shape[0] * sh.nprobe_local >= sh.centroids.shape[0] // 8
    d_g, r_g = sh.search(qb, 10)                # grouped (b*npl >= nlist_l)
    sh._fns.clear()
    sh._allow_grouped = False
    d_p, r_p = sh.search(qb, 10)                # per-query one-hot path
    # phase 2 scores are exact in both branches; only near-ties may swap
    np.testing.assert_allclose(d_g, d_p, atol=2e-3)
    mism = r_g != r_p
    if mism.any():
        np.testing.assert_allclose(d_g[mism], d_p[mism], atol=2e-3)


def test_sharded_ivf_int8_cells(built, mesh):
    col, v, q, exact = built
    col.build_ann(kind="ivf", nlist=64, nprobe=12, iters=5,
                  cell_dtype="int8")
    assert col._ann.cells.dtype == np.int8
    sh = ShardedIVF.from_index(mesh, col._ann)
    assert sh.rerank == col._ann.rerank == 4  # exact re-rank rides along
    d, rows = sh.search(q, 10)
    assert rows.shape == (8, 10)
    recall = np.mean([len(set(r.tolist()) & e) / 10
                      for r, e in zip(rows, exact)])
    assert recall >= 0.85, f"sharded int8-cell IVF recall {recall:.3f}"
    assert all(np.all(np.diff(row) >= -1e-4) for row in d)
    # the re-ranked sharded path must match the single-chip index's rows
    # (both select the quantized top-c then exact-score the same rows)
    _, rows_1c = col._ann.search(q, 10)
    agree = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                     for a, b in zip(rows, rows_1c)])
    assert agree >= 0.85, agree


def _overflow_collection(seed=11, n=1024, shift=6.0):
    """Corpus offset far from the origin, so a query near an overflow row
    is far from the data mean — the regime where routing alone would never
    reach the overflow rows."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, D)).astype(np.float32)
    v[: n // 2] += shift  # bimodal: the mean sits between the modes
    v[n // 2:] -= shift
    col = Collection(CollectionConfig(name="ovf", dimensions=D, metric="l2"))
    col.insert_batch(v, [f"v{i}" for i in range(n)])
    return col, v


def test_sharded_ivf_overflow_far_from_mean(mesh):
    """Overflow rows must be found even when the query routes far away
    from the data mean (every shard scans its overflow rows exactly)."""
    col, v = _overflow_collection()
    col.build_ann(kind="ivf", nlist=32, nprobe=4, iters=4,
                  max_cell_factor=0.6, spill_choices=2)
    overflow = np.asarray(col._ann.overflow_rows)
    overflow = overflow[overflow >= 0]
    if overflow.size == 0:
        pytest.skip("no overflow produced")
    sh = ShardedIVF.from_index(mesh, col._ann)
    probe = v[overflow[:8]]
    _, rows = sh.search(probe, 5)
    for qi, want in enumerate(overflow[:8]):
        assert want in rows[qi].tolist(), (qi, want, rows[qi])
    # normal routing still works beside the overflow scan
    regular = np.setdiff1d(np.arange(v.shape[0]), overflow)[:8]
    _, rows = sh.search(v[regular], 5)
    hit = sum(int(w in r.tolist()) for w, r in zip(regular, rows))
    assert hit >= 6, hit


def test_sharded_ivfpq_overflow_far_from_mean(mesh):
    from fastpyvectordb_jax.dist.sharded_ann import ShardedIVFPQ
    col, v = _overflow_collection(seed=13)
    col.build_ann(kind="ivfpq", nlist=32, nprobe=4, iters=4, m=8, pq_k=16,
                  pq_iters=3, max_cell_factor=0.6, spill_choices=2)
    overflow = np.asarray(col._ann.overflow_rows)
    overflow = overflow[overflow >= 0]
    if overflow.size == 0:
        pytest.skip("no overflow produced")
    sh = ShardedIVFPQ.from_index(mesh, col._ann)
    probe = v[overflow[:8]]
    _, rows = sh.search(probe, 5, rerank=8)
    for qi, want in enumerate(overflow[:8]):
        assert want in rows[qi].tolist(), (qi, want, rows[qi])


def test_sharded_ivf_grouped_matches_perquery(mesh):
    """The in-shard grouped (cell-major) dispatch must select the same
    rows as the per-query gather at identical inputs — including the
    overflow block, which both branches scan exactly."""
    import jax.numpy as jnp
    from fastpyvectordb_jax.core.collection import Collection
    from fastpyvectordb_jax.core.types import CollectionConfig
    from fastpyvectordb_jax.dist.sharded_ann import (
        ShardedIVF, build_sharded_ivf_search)

    rng = np.random.default_rng(5)
    col, v = _overflow_collection(seed=5)
    d = v.shape[1]
    col.build_ann(nlist=32, nprobe=8, iters=4)
    # the 128-row cell-capacity floor makes real overflow unreachable at
    # test scale — plant synthetic overflow entries (rows also present in
    # cells: both dispatches see the identical candidate multiset, so
    # parity still holds) to exercise the overflow scan in the grouped
    # branch
    orows = np.arange(16, dtype=np.int32)
    col._ann.overflow_rows = jnp.asarray(orows)
    col._ann.overflow_vecs = jnp.take(
        col._store.vectors, jnp.asarray(orows), axis=0)
    sh = ShardedIVF.from_index(mesh, col._ann)
    assert sh._allow_grouped

    q = np.asarray(v[rng.integers(0, v.shape[0], 64)]
                   + 0.1 * rng.standard_normal((64, d)), dtype=np.float32)
    d_g, r_g = sh.search(q, 10)          # b*npl >= nlist_l -> grouped
    # force the per-query path at the same shapes
    sh._fns.clear()
    sh._allow_grouped = False
    d_p, r_p = sh.search(q, 10)
    # identical candidate sets; scores differ only by accumulation order
    # (grouped epilogue vs per-query norm expansion), ~1e-3 in bf16
    np.testing.assert_allclose(d_g, d_p, atol=2e-3)
    mism = r_g != r_p
    if mism.any():  # rows may differ only on near-tied scores
        np.testing.assert_allclose(d_g[mism], d_p[mism], atol=2e-3)


@pytest.mark.parametrize("cell_dtype", [None, "int8"])
def test_sharded_ivf_overflow_wider_than_cells(mesh, cell_dtype):
    """An overflow block wider than a cell keeps the cells at the index's
    own width (padding every cell to the overflow width multiplies the
    cell tensor), and every overflow row is still found."""
    import jax.numpy as jnp
    rng = np.random.default_rng(9)
    n = 4096
    v = rng.standard_normal((n, D)).astype(np.float32)
    col = Collection(CollectionConfig(name="wide", dimensions=D,
                                      metric="cosine"))
    col.insert_batch(v, [f"v{i}" for i in range(n)])
    col.build_ann(nlist=64, nprobe=4, iters=3, cell_dtype=cell_dtype)
    # plant every row as overflow: n / 8 shards = 512 rows per shard,
    # four times the 128-row cell width
    orows = np.arange(n, dtype=np.int32)
    col._ann.overflow_rows = jnp.asarray(orows)
    col._ann.overflow_vecs = jnp.asarray(v)
    sh = ShardedIVF.from_index(mesh, col._ann)
    assert sh.cells.shape[1] == col._ann.cells.shape[1] == 128
    assert sh.overflow_vecs.shape[0] == n
    assert sh.overflow_vecs.dtype == col._ann.cells.dtype
    probe = rng.choice(n, 32, replace=False)
    for grouped in (True, False):
        sh._fns.clear()
        sh._allow_grouped = grouped
        _, rows = sh.search(v[probe], 5)
        assert (rows[:, 0] == probe).all(), grouped


def test_sharded_int8_masks_post_build_tail(mesh):
    """Rows appended after the snapshot build carry garbage codes;
    ShardedInt8.from_scan must mask them out of the coarse scan
    (QuantizedScan.search's arange < built_count guard)."""
    import numpy as np
    from fastpyvectordb_jax.core.collection import Collection
    from fastpyvectordb_jax.core.types import CollectionConfig

    rng = np.random.default_rng(11)
    v = rng.standard_normal((256, 16)).astype(np.float32)
    col = Collection(CollectionConfig(name="tail8", dimensions=16,
                                      metric="l2"))
    col.insert_batch(v, [f"v{i}" for i in range(256)])
    scan = col.enable_quantized_scan("int8", tune=False)
    built = scan.built_count
    col.insert_batch(rng.standard_normal((64, 16)).astype(np.float32),
                     [f"w{i}" for i in range(64)])
    sh = ShardedInt8.from_scan(mesh, scan)
    _, rows = sh.search(v[:8], k=10)
    assert (rows < built).all(), "tail rows served from garbage codes"


@pytest.mark.parametrize("ndev,per", [(1, 1), (4, 13), (8, 128), (2, 129)])
def test_overflow_shards_pad_to_aligned_length(ndev, per):
    """Each shard's overflow slice is padded, in place, to a multiple of
    128 rows of dead slots; its live rows keep their shard and order."""
    from fastpyvectordb_jax.dist.sharded_ann import _pad_overflow_shards
    n = ndev * per
    vecs = np.arange(n * 3, dtype=np.int8).reshape(n, 3)
    norms = np.arange(n, dtype=np.float32) + 1
    rows = np.arange(n, dtype=np.int32)
    pv, pn, pr = _pad_overflow_shards(vecs, norms, rows, ndev)
    per_p = pr.shape[0] // ndev
    assert pr.shape[0] % ndev == 0 and per_p % 128 == 0 and per_p >= per
    assert pv.shape == (ndev * per_p, 3) and pn.shape == pr.shape
    for i in range(ndev):
        blk = slice(i * per_p, (i + 1) * per_p)
        np.testing.assert_array_equal(pr[blk][:per], rows[i * per:(i + 1) * per])
        np.testing.assert_array_equal(pv[blk][:per], vecs[i * per:(i + 1) * per])
        assert (pr[blk][per:] == -1).all() and (pn[blk][per:] == 0).all()
    with pytest.raises(ValueError, match="multiple"):
        _pad_overflow_shards(vecs, norms, rows, n + 1)


@pytest.mark.parametrize("cell_dtype", [None, "int8"])
def test_sharded_ivf_odd_overflow_per_shard(mesh, cell_dtype):
    """An overflow block that splits into an odd row count per shard
    (8 x 67 rows) is padded per shard, and every overflow row is found."""
    import jax.numpy as jnp
    rng = np.random.default_rng(13)
    n = 2048
    v = rng.standard_normal((n, D)).astype(np.float32)
    col = Collection(CollectionConfig(name="odd", dimensions=D,
                                      metric="cosine"))
    col.insert_batch(v, [f"v{i}" for i in range(n)])
    col.build_ann(nlist=32, nprobe=4, iters=3, cell_dtype=cell_dtype)
    orows = rng.choice(n, 8 * 67, replace=False).astype(np.int32)
    col._ann.overflow_rows = jnp.asarray(orows)
    col._ann.overflow_vecs = jnp.asarray(v[orows])
    sh = ShardedIVF.from_index(mesh, col._ann)
    assert sh.overflow_rows.shape[0] == 8 * 128
    assert int((np.asarray(sh.overflow_rows) >= 0).sum()) == orows.size
    probe = orows[:32]
    for grouped in (True, False):
        sh._fns.clear()
        sh._allow_grouped = grouped
        _, rows = sh.search(v[probe], 5)
        assert (rows[:, 0] == probe).all(), grouped
