"""Checks that only the card can make.  Run them there with
``pytest -m gpu tests/test_gpu.py`` (chip_smoke.py runs them in its own
process); in every other run they skip.  Whether a GPU is present is
decided in the ``gpu`` fixture, never while the module is imported."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastpyvectordb_jax.core.types import DistanceMetric

pytestmark = pytest.mark.gpu


@pytest.fixture()
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `pytest -m gpu` on the card")


def _f64_cosine(q, v):
    q = q.astype(np.float64)
    v = v.astype(np.float64)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return 1.0 - q @ v.T


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_float32_scan_matches_float64(gpu, metric):
    """A float32 collection computes in full float32 on the card: its
    distances agree with float64 to float32 rounding (a TF32 product
    would be ~1e-3 off) and its top-10 is the float64 top-10."""
    from fastpyvectordb_jax import Collection, CollectionConfig
    rng = np.random.default_rng(0)
    n, d, b = 65_536, 768, 64
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    col = Collection(CollectionConfig(name="f32", dimensions=d,
                                      metric=metric))
    col.insert_batch(v, [str(i) for i in range(n)])
    ids, dists, rows = col.search_arrays(q, 10, exact=True)
    if metric == "cosine":
        ref = _f64_cosine(q, v)
    else:
        ref = np.sqrt(np.maximum(
            (q.astype(np.float64) ** 2).sum(1)[:, None]
            + (v.astype(np.float64) ** 2).sum(1)[None, :]
            - 2.0 * q.astype(np.float64) @ v.astype(np.float64).T, 0.0))
    got = np.take_along_axis(ref, rows, axis=1)
    scale = 1.0 if metric == "cosine" else float(np.abs(got).max())
    np.testing.assert_allclose(dists, got, atol=1e-4 * scale, rtol=0)
    want = np.argsort(ref, axis=1)[:, :10]
    assert np.mean([len(set(a) & set(w)) / 10
                    for a, w in zip(rows.tolist(), want.tolist())]) >= 0.999


def test_int8_dot_lowers_to_integer_gemm(gpu):
    """The int8 scan's s8 x s8 -> s32 product stays an integer GEMM on the
    card (the route to the int8 tensor cores), not a float conversion."""
    from chip_smoke import int_gemm_lines
    from fastpyvectordb_jax.quant.scalar import _distances_int8_matmul
    n, d, b = 65_536, 768, 256
    codes = jnp.zeros((n, d), jnp.int8)
    q = jnp.ones((b, d), jnp.float32)
    stats = (jnp.ones((n,), jnp.float32), jnp.ones((n,), jnp.float32))
    fn = functools.partial(_distances_int8_matmul,
                           metric=DistanceMetric.COSINE)
    text = jax.jit(fn).lower(q, codes, jnp.zeros((d,)), jnp.ones((d,)),
                             *stats).compile().as_text()
    assert int_gemm_lines(text), "no s8 x s8 -> s32 GEMM in the program"


def test_ivf_routing_is_float32_exact(gpu):
    """IVF routing scores agree with float64 to float32 rounding, so a
    TF32 product cannot reorder near-tied centroids."""
    from fastpyvectordb_jax.ann.ivf_grouped import route_scores
    rng = np.random.default_rng(1)
    q = rng.standard_normal((128, 768)).astype(np.float32)
    c = rng.standard_normal((2048, 768)).astype(np.float32)
    got = np.asarray(route_scores(jnp.asarray(q), jnp.asarray(c),
                                  DistanceMetric.COSINE))
    np.testing.assert_allclose(got, _f64_cosine(q, c) - 1.0, atol=1e-5,
                               rtol=0)


def test_sharded_ivf_odd_int8_overflow_block(gpu):
    """A shard's int8 overflow block of an odd length (13,591 rows: 4M
    rows' overflow split four ways) scores right on the card.  Unpadded,
    the int8 -> bf16 GEMM returned NaN and ~-3e34 for these rows."""
    from fastpyvectordb_jax.dist.mesh import make_mesh
    from fastpyvectordb_jax.dist.sharded_ann import ShardedIVF
    rng = np.random.default_rng(2)
    o, d, b = 13_591, 768, 1024
    codes = rng.integers(-128, 128, (o, d), dtype=np.int8)
    vmin, scale = -np.ones((d,), np.float32), 2 * np.ones((d,), np.float32)
    deq = (codes.astype(np.float32) + 128.0) / 255.0 * scale + vmin
    sh = ShardedIVF(
        make_mesh(1), np.ones((2, d), np.float32),
        np.zeros((2, 128, d), np.int8), np.full((2, 128), -1, np.int32),
        np.ones((2,), bool), np.ones((o,), bool), vmin=vmin, scale=scale,
        cell_norms=np.zeros((2, 128), np.float32),
        overflow=(codes, (deq * deq).sum(1), np.arange(o, dtype=np.int32)),
        metric="cosine", nprobe=1)
    probe = rng.choice(o, b, replace=False)
    dists, rows = sh.search(deq[probe], 5)
    assert np.isfinite(dists).all()
    assert (rows[:, 0] == probe).all()
    np.testing.assert_allclose(dists[:, 0], 0.0, atol=2e-2)
