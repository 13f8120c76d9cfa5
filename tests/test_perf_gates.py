"""Performance gates (parity: reference test_comprehensive.py:702-767).

Gates mirror the reference's absolute thresholds at the same scale
(5k x 128-d): insert > 1k vec/s, warm avg search latency < 50 ms,
p99 < 100 ms, QPS > 100, batch QPS > 500, graph property lookup < 1 ms.
Run on the CPU backend in CI; the gates hold there, so they guard against
host-side regressions rather than measure the device.
"""

import time

import numpy as np
import pytest

from fastpyvectordb_jax import Collection, CollectionConfig

N, D = 5_000, 128


@pytest.fixture(scope="module")
def loaded():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((N, D)).astype(np.float32)
    col = Collection(CollectionConfig(name="perf", dimensions=D))
    t0 = time.perf_counter()
    col.insert_batch(v, [f"v{i}" for i in range(N)])
    insert_s = time.perf_counter() - t0
    q = rng.standard_normal((64, D)).astype(np.float32)
    col.search(q[0], k=10)          # warm the compile cache
    col.search_batch(q, k=10)
    return col, q, insert_s


def test_insert_rate(loaded):
    _, _, insert_s = loaded
    assert N / insert_s > 1_000, f"insert {N / insert_s:.0f} vec/s < 1k"


def test_search_latency(loaded):
    col, q, _ = loaded
    lats = []
    for i in range(32):
        t0 = time.perf_counter()
        col.search(q[i % len(q)], k=10)
        lats.append(time.perf_counter() - t0)
    lats = np.asarray(lats)
    assert lats.mean() < 0.050, f"avg {lats.mean()*1e3:.1f} ms >= 50 ms"
    assert np.percentile(lats, 99) < 0.100


def test_search_qps(loaded):
    col, q, _ = loaded
    t0 = time.perf_counter()
    n = 64
    for i in range(n):
        col.search(q[i % len(q)], k=10)
    qps = n / (time.perf_counter() - t0)
    assert qps > 100, f"QPS {qps:.0f} <= 100"


def test_batch_qps(loaded):
    col, q, _ = loaded
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        col.search_batch(q, k=10)
    qps = iters * len(q) / (time.perf_counter() - t0)
    assert qps > 500, f"batch QPS {qps:.0f} <= 500"


def test_property_index_lookup_under_1ms():
    from fastpyvectordb_jax.graphdb import GraphDB
    g = GraphDB()
    for i in range(2_000):
        g.create_node(["N"], {"bucket": i % 50, "i": i}, id=f"n{i}")
    t0 = time.perf_counter()
    out = g.find_nodes(label="N", properties={"bucket": 7})
    dt = time.perf_counter() - t0
    assert len(out) == 40
    assert dt < 0.001, f"property lookup took {dt*1e3:.2f} ms"
