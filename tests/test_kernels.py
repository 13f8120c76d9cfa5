"""Kernel-level tests: distances + masked top-k vs NumPy ground truth."""

import numpy as np
import pytest

import jax.numpy as jnp

from fastpyvectordb_jax.core.types import DistanceMetric
from fastpyvectordb_jax.kernels import distances as K
from fastpyvectordb_jax.kernels import topk as T


def ref_scores(q, v, metric):
    if metric == DistanceMetric.COSINE:
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        vn = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-30)
        return 1.0 - qn @ vn.T
    if metric == DistanceMetric.L2:
        return np.sum((q[:, None, :] - v[None, :, :]) ** 2, axis=-1)
    return -(q @ v.T)


@pytest.mark.parametrize("metric", list(DistanceMetric))
def test_scores_match_numpy(rng, metric):
    q = rng.standard_normal((4, 32)).astype(np.float32)
    v = rng.standard_normal((64, 32)).astype(np.float32)
    stats = K.corpus_stats(jnp.asarray(v))
    got = np.asarray(K.scores(jnp.asarray(q), jnp.asarray(v), metric,
                              corpus_sq=stats["sq"], corpus_rinv=stats["rinv"]))
    want = ref_scores(q, v, metric)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", list(DistanceMetric))
def test_search_kernel_topk(rng, metric):
    q = rng.standard_normal((3, 16)).astype(np.float32)
    v = rng.standard_normal((128, 16)).astype(np.float32)
    stats = K.corpus_stats(jnp.asarray(v))
    mask = jnp.ones((128,), dtype=bool)
    vals, rows = K.search_kernel(jnp.asarray(q), jnp.asarray(v),
                                 stats["sq"], stats["rinv"], mask,
                                 metric=metric, k=5)
    want = ref_scores(q, v, metric)
    if metric == DistanceMetric.L2:
        want = np.sqrt(want)
    expect_rows = np.argsort(want, axis=1)[:, :5]
    # top-k rows must match (allow tie permutation by comparing score sets)
    np.testing.assert_allclose(
        np.sort(np.asarray(vals), axis=1),
        np.sort(np.take_along_axis(want, expect_rows, axis=1), axis=1),
        rtol=1e-3, atol=1e-3)
    assert set(map(tuple, np.asarray(rows))) == set(map(tuple, expect_rows)) or \
        np.allclose(np.take_along_axis(want, np.asarray(rows), 1),
                    np.take_along_axis(want, expect_rows, 1), atol=1e-3)


def test_masked_search_excludes_rows(rng):
    q = rng.standard_normal((1, 8)).astype(np.float32)
    v = rng.standard_normal((32, 8)).astype(np.float32)
    stats = K.corpus_stats(jnp.asarray(v))
    mask = np.zeros((32,), dtype=bool)
    mask[10:20] = True
    vals, rows = K.search_kernel(jnp.asarray(q), jnp.asarray(v),
                                 stats["sq"], stats["rinv"], jnp.asarray(mask),
                                 metric=DistanceMetric.COSINE, k=32)
    ok = np.asarray(T.valid_hits(vals))[0]
    got_rows = set(np.asarray(rows)[0][ok].tolist())
    assert got_rows == set(range(10, 20))


def test_all_masked_returns_no_valid_hits(rng):
    q = rng.standard_normal((2, 8)).astype(np.float32)
    v = rng.standard_normal((16, 8)).astype(np.float32)
    stats = K.corpus_stats(jnp.asarray(v))
    mask = jnp.zeros((16,), dtype=bool)
    vals, _ = K.search_kernel(jnp.asarray(q), jnp.asarray(v), stats["sq"],
                              stats["rinv"], mask,
                              metric=DistanceMetric.L2, k=4)
    assert not np.asarray(T.valid_hits(vals)).any()


def test_merge_top_k(rng):
    # two partial top-4 lists whose merge must equal global top-4
    scores = rng.standard_normal((2, 2, 4)).astype(np.float32)  # (P, B, k)
    idx = np.arange(16, dtype=np.int32).reshape(2, 2, 4)
    vals, gidx = T.merge_top_k(jnp.asarray(scores), jnp.asarray(idx), 4)
    for b in range(2):
        allv = scores[:, b, :].reshape(-1)
        alli = idx[:, b, :].reshape(-1)
        order = np.argsort(allv)[:4]
        np.testing.assert_allclose(np.asarray(vals)[b], allv[order], rtol=1e-6)
        assert set(np.asarray(gidx)[b].tolist()) == set(alli[order].tolist())
