"""Sharded multi-device search tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fastpyvectordb_jax.core.types import DistanceMetric
from fastpyvectordb_jax.dist.mesh import make_mesh, DATA_AXIS, QUERY_AXIS
from fastpyvectordb_jax.dist.sharded import (
    ShardedSearcher,
    build_sharded_kmeans_step,
    build_sharded_search,
)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return make_mesh()


def exact_rows(q, v, metric, k):
    if metric == DistanceMetric.COSINE:
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        vn = v / np.linalg.norm(v, axis=1, keepdims=True)
        s = 1 - qn @ vn.T
    elif metric == DistanceMetric.L2:
        s = np.linalg.norm(q[:, None] - v[None], axis=-1)
    else:
        s = -(q @ v.T)
    return np.argsort(s, axis=1, kind="stable")[:, :k]


@pytest.mark.parametrize("metric", list(DistanceMetric))
def test_sharded_matches_exact(mesh, rng, metric):
    n, d, b, k = 1024, 16, 4, 10
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    searcher = ShardedSearcher(mesh, jnp.asarray(v),
                               jnp.ones((n,), dtype=bool), metric=metric)
    vals, rows = searcher.search(jnp.asarray(q), k)
    want = exact_rows(q, v, metric, k)
    got = np.asarray(rows)
    # score-equivalence per row (genuinely robust to ties: a different
    # index with an equal score is a correct answer)
    for bi in range(b):
        same_sets = set(got[bi].tolist()) == set(want[bi].tolist())
        same_scores = np.allclose(
            np.sort(np.asarray(vals)[bi]),
            np.sort([_score(q[bi], v[w], metric) for w in want[bi]]),
            atol=1e-4)
        assert same_sets or same_scores, bi


def _score(q, v, metric):
    if metric == DistanceMetric.COSINE:
        return 1 - q @ v / (np.linalg.norm(q) * np.linalg.norm(v))
    if metric == DistanceMetric.L2:
        return np.linalg.norm(q - v)
    return -q @ v


def test_sharded_respects_validity(mesh, rng):
    n, d = 512, 8
    v = rng.standard_normal((n, d)).astype(np.float32)
    valid = np.zeros((n,), dtype=bool)
    valid[100:200] = True
    searcher = ShardedSearcher(mesh, jnp.asarray(v), jnp.asarray(valid),
                               metric="l2")
    _, rows = searcher.search(jnp.asarray(v[:2]), 16)
    assert all(100 <= r < 200 for r in np.asarray(rows).ravel())


def test_query_data_2d_mesh(rng):
    mesh = make_mesh(query_parallel=2)
    assert mesh.shape == {QUERY_AXIS: 2, DATA_AXIS: 4}
    n, d, b, k = 256, 8, 4, 5
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    fn = build_sharded_search(mesh, metric=DistanceMetric.L2, k=k)
    vals, rows = fn(jnp.asarray(q), jnp.asarray(v), jnp.ones((n,), bool))
    want = exact_rows(q, v, DistanceMetric.L2, k)
    assert np.array_equal(np.sort(np.asarray(rows), 1), np.sort(want, 1))


def test_sharded_kmeans_step_matches_single_device(mesh, rng):
    n, d, k = 512, 8, 4
    data = rng.standard_normal((n, d)).astype(np.float32)
    w = np.ones((n,), dtype=np.float32)
    c0 = data[:k].copy()
    step = build_sharded_kmeans_step(mesh, k=k)
    c1, counts = step(jnp.asarray(data), jnp.asarray(w), jnp.asarray(c0))
    # single-device reference
    dist = ((c0**2).sum(1)[None] - 2 * data @ c0.T)
    a = dist.argmin(1)
    want = np.stack([data[a == i].mean(0) if (a == i).any() else c0[i]
                     for i in range(k)])
    np.testing.assert_allclose(np.asarray(c1), want, rtol=1e-4, atol=1e-5)
    assert int(np.asarray(counts).sum()) == n


def test_collection_as_sharded_searcher(rng):
    from fastpyvectordb_jax import Collection, CollectionConfig
    import jax.numpy as jnp
    col = Collection(CollectionConfig(name="s", dimensions=8, metric="l2"))
    v = rng.standard_normal((300, 8)).astype(np.float32)
    col.insert_batch(v, [f"v{i}" for i in range(300)])
    col.delete("v5")
    s = col.as_sharded_searcher()
    vals, rows = s.search(jnp.asarray(v[:4]), 3)
    rows = np.asarray(rows)
    assert rows[0, 0] == 0 and rows[1, 0] == 1
    # tombstoned row must not appear
    _, r5 = s.search(jnp.asarray(v[5:6]), 1)
    assert int(np.asarray(r5)[0, 0]) != 5


def test_global_mesh_and_local_shard(rng):
    from fastpyvectordb_jax.dist.multihost import global_mesh, shard_local_corpus
    mesh = global_mesh()
    assert mesh.shape[DATA_AXIS] == 8
    local = rng.standard_normal((64, 4)).astype(np.float32)
    arr = shard_local_corpus(mesh, local)
    assert arr.shape == (64, 4)
    np.testing.assert_allclose(np.asarray(arr), local, rtol=1e-6)
    mesh2 = global_mesh(query_parallel=2)
    assert mesh2.shape == {QUERY_AXIS: 2, DATA_AXIS: 4}
