"""Standalone comprehensive test runner (reference parity:
test_comprehensive.py — its own pass/fail recorder + timings over the major
subsystems, runnable without pytest).

Usage: python test_comprehensive.py [--skip-perf]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
import traceback
from pathlib import Path

import jax

# default to the CPU backend (fast startup); pass --gpu to run on the card.
# (Calling jax.devices() first would initialize the default backend and
# lock the platform choice.)
if "--gpu" not in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import numpy as np


class TestResults:
    """Pass/fail recorder with timings (reference:
    test_comprehensive.py:69-104)."""

    def __init__(self):
        self.results = []

    def record(self, suite: str, name: str, ok: bool, seconds: float,
               error: str = ""):
        self.results.append((suite, name, ok, seconds, error))
        mark = "PASS" if ok else "FAIL"
        print(f"  [{mark}] {name} ({seconds*1e3:.1f} ms)"
              + (f"  -- {error}" if error else ""))

    def run(self, suite: str, name: str, fn):
        t0 = time.perf_counter()
        try:
            fn()
            self.record(suite, name, True, time.perf_counter() - t0)
        except Exception as e:
            self.record(suite, name, False, time.perf_counter() - t0,
                        f"{type(e).__name__}: {e}")
            traceback.print_exc()

    def summary(self) -> bool:
        n = len(self.results)
        passed = sum(1 for r in self.results if r[2])
        total_s = sum(r[3] for r in self.results)
        print(f"\n{'='*60}\n{passed}/{n} passed in {total_s:.1f}s")
        for suite, name, ok, _, err in self.results:
            if not ok:
                print(f"  FAILED: {suite}/{name}: {err}")
        return passed == n


def suite_vectordb(t: TestResults, tmp: Path):
    import fastpyvectordb_jax as fvdb
    rng = np.random.default_rng(0)
    v = rng.standard_normal((200, 32)).astype(np.float32)

    def metrics():
        for metric in ("cosine", "l2", "ip"):
            col = fvdb.Collection(fvdb.CollectionConfig(
                name=metric, dimensions=32, metric=metric))
            col.insert_batch(v, [f"v{i}" for i in range(200)])
            assert col.search(v[5], k=1)[0].id == "v5"
    t.run("vectordb", "all three metrics", metrics)

    def crud():
        col = fvdb.Collection(fvdb.CollectionConfig(name="c", dimensions=32))
        col.insert_batch(v[:50], [f"v{i}" for i in range(50)],
                         [{"i": i} for i in range(50)])
        col.upsert(v[0], "v0", {"i": 99})
        assert col.get("v0")["metadata"]["i"] == 99
        col.delete("v1")
        assert col.count() == 49
        # two tombstones: v1's row and v0's pre-upsert row
        assert col.compact() == 2
    t.run("vectordb", "crud + compaction", crud)

    def filters():
        col = fvdb.Collection(fvdb.CollectionConfig(name="f", dimensions=32))
        col.insert_batch(v, [f"v{i}" for i in range(200)],
                         [{"g": i % 5} for i in range(200)])
        hits = col.search(v[0], k=200, filter=fvdb.Filter.eq("g", 2))
        assert len(hits) == 40 and all(h.metadata["g"] == 2 for h in hits)
    t.run("vectordb", "fused filter masks", filters)

    def persistence():
        db = fvdb.VectorDB(str(tmp / "v"))
        col = db.create_collection("p", 32, metric="l2")
        col.insert_batch(v[:20], [f"v{i}" for i in range(20)])
        db.save()
        db2 = fvdb.VectorDB(str(tmp / "v"))
        assert db2["p"].search(v[3], k=1)[0].id == "v3"
    t.run("vectordb", "persistence round-trip", persistence)

    def brute():
        col = fvdb.Collection(fvdb.CollectionConfig(name="b", dimensions=32,
                                                    metric="l2"))
        col.insert_batch(v, [f"v{i}" for i in range(200)])
        hits = col.brute_force_search(v[9], k=3)
        want = np.argsort(np.linalg.norm(v - v[9], axis=1))[:3]
        assert [h.id for h in hits] == [f"v{i}" for i in want]
    t.run("vectordb", "brute force exactness", brute)


def suite_graph(t: TestResults, tmp: Path):
    from fastpyvectordb_jax.graphdb import GraphDB

    def crud_indexes():
        g = GraphDB()
        a = g.create_node(["A"], {"x": 1}, id="a")
        b = g.create_node(["A", "B"], {"x": 2}, id="b")
        g.create_edge("a", "b", "R")
        g.update_node("a", {"x": 5})
        assert [n.id for n in g.find_nodes(properties={"x": 5})] == ["a"]
        g.delete_node("b")
        assert g.stats()["edges"] == 0
    t.run("graph", "crud + index maintenance", crud_indexes)

    def cypher():
        g = GraphDB()
        for i in range(10):
            g.create_node(["N"], {"v": i}, id=f"n{i}")
        rows = g.query("MATCH (n:N) WHERE n.v >= 7 RETURN n.v")
        assert sorted(r["n.v"] for r in rows) == [7, 8, 9]
    t.run("graph", "mini-cypher", cypher)

    def persistence():
        g = GraphDB(str(tmp / "g"))
        g.create_node(["X"], {"k": 1}, id="x")
        g.save()
        g2 = GraphDB(str(tmp / "g"))
        assert g2.get_node("x").properties == {"k": 1}
    t.run("graph", "persistence", persistence)


def suite_hybrid_graph(t: TestResults, tmp: Path):
    from fastpyvectordb_jax.graphdb.hybrid import HybridGraphVectorDB

    def seeds_and_expansion():
        db = HybridGraphVectorDB(dimensions=8)
        e1 = np.eye(8, dtype=np.float32)
        db.add_node_with_embedding(["D"], {}, e1[0], id="a")
        db.add_node_with_embedding(["D"], {}, e1[1], id="b")
        db.graph.create_node(["D"], {}, id="c")
        db.graph.create_edge("a", "c", "L")
        res = db.semantic_graph_search(e1[0], k=5, expand_hops=1)
        ids = [r.node.id for r in res]
        assert ids[0] == "a" and "c" in ids
    t.run("hybrid_graph", "seeds vs expansion", seeds_and_expansion)


def suite_persistence(t: TestResults, tmp: Path):
    from fastpyvectordb_jax.persist.format import (
        StreamingVectorReader, StreamingVectorWriter, compress_vectors,
        decompress_vectors, load_container, save_container)
    rng = np.random.default_rng(1)

    def container():
        arr = rng.standard_normal((10, 4)).astype(np.float32)
        save_container(tmp / "c.fpvt", {"a": arr, "j": {"x": 1}})
        c = load_container(tmp / "c.fpvt")
        assert np.array_equal(np.asarray(c.read("a")), arr)
        assert c.read("j") == {"x": 1}
    t.run("persist", "container integrity", container)

    def streaming():
        with StreamingVectorWriter(tmp / "s.fpvs", 4) as w:
            w.append_batch(rng.standard_normal((7, 4)).astype(np.float32))
        with StreamingVectorReader(tmp / "s.fpvs") as r:
            assert len(r) == 7
    t.run("persist", "streaming writer/reader", streaming)

    def compression():
        v = rng.standard_normal((100, 16)).astype(np.float32)
        payload, params = compress_vectors(v, "int8")
        assert v.nbytes / payload.nbytes > 2.0  # ref gate: >2x
        back = decompress_vectors(payload, params)
        assert np.abs(back - v).max() < 0.1 * np.abs(v).max()
    t.run("persist", "compression ratio > 2x", compression)


def suite_bm25(t: TestResults, tmp: Path):
    from fastpyvectordb_jax.hybrid import BM25Index

    def alpha_sweep():
        from fastpyvectordb_jax import CollectionConfig
        from fastpyvectordb_jax.embeddings import HashingEmbedder
        from fastpyvectordb_jax.hybrid import HybridCollection
        emb = HashingEmbedder(32)
        col = HybridCollection(CollectionConfig(name="h", dimensions=32),
                               text_fields=["t"])
        texts = ["alpha beta", "beta gamma", "gamma delta"]
        col.insert_batch(np.stack([emb.embed(x) for x in texts]),
                         ["a", "b", "c"], [{"t": x} for x in texts])
        for alpha in (0.0, 0.5, 1.0):
            res = col.hybrid_search(emb.embed("beta"), "beta", k=3,
                                    alpha=alpha)
            assert res and all(0 <= r.score <= 1.0001 for r in res)
    t.run("bm25", "alpha sweep", alpha_sweep)

    def index_ops():
        idx = BM25Index()
        idx.add_document("a", "the quick brown fox")
        idx.add_document("b", "lazy dogs sleep")
        assert idx.search("fox", 2)[0][0] == "a"
        idx.remove_document("a")
        assert idx.search("fox", 2) == []
    t.run("bm25", "index ops", index_ops)


def suite_perf(t: TestResults, tmp: Path):
    import fastpyvectordb_jax as fvdb
    rng = np.random.default_rng(2)
    n, d = 5_000, 128
    v = rng.standard_normal((n, d)).astype(np.float32)
    col = fvdb.Collection(fvdb.CollectionConfig(name="perf", dimensions=d))
    q = rng.standard_normal((64, d)).astype(np.float32)

    def insert_rate():
        t0 = time.perf_counter()
        col.insert_batch(v, [f"v{i}" for i in range(n)])
        rate = n / (time.perf_counter() - t0)
        assert rate > 1_000, f"{rate:.0f} vec/s"
    t.run("perf", "insert > 1k vec/s", insert_rate)

    col.search(q[0], k=10)  # warm
    col.search_batch(q, k=10)

    def latency():
        lats = []
        for i in range(32):
            t0 = time.perf_counter()
            col.search(q[i % 64], k=10)
            lats.append(time.perf_counter() - t0)
        assert np.mean(lats) < 0.05 and np.percentile(lats, 99) < 0.1
    t.run("perf", "avg < 50ms, p99 < 100ms", latency)

    def qps():
        t0 = time.perf_counter()
        for i in range(64):
            col.search(q[i % 64], k=10)
        assert 64 / (time.perf_counter() - t0) > 100
    t.run("perf", "QPS > 100", qps)

    def batch_qps():
        t0 = time.perf_counter()
        for _ in range(10):
            col.search_batch(q, k=10)
        assert 640 / (time.perf_counter() - t0) > 500
    t.run("perf", "batch QPS > 500", batch_qps)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--skip-perf", action="store_true")
    p.add_argument("--gpu", action="store_true",
                   help="run on the GPU backend instead of CPU")
    args = p.parse_args()

    t = TestResults()
    suites = [("VectorDB core", suite_vectordb),
              ("GraphDB", suite_graph),
              ("Hybrid graph+vector", suite_hybrid_graph),
              ("Binary persistence", suite_persistence),
              ("BM25 / hybrid", suite_bm25)]
    if not args.skip_perf:
        suites.append(("Performance gates", suite_perf))
    with tempfile.TemporaryDirectory() as tmpdir:
        for title, fn in suites:
            print(f"\n--- {title} ---")
            fn(t, Path(tmpdir))
    sys.exit(0 if t.summary() else 1)


if __name__ == "__main__":
    main()
