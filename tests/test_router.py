"""Shard-router tests: two engine shards behind one front; merged search
must equal a single engine over the union corpus."""

import asyncio
import socket
import threading

import numpy as np
import pytest

aiohttp = pytest.importorskip("aiohttp")
httpx = pytest.importorskip("httpx")

from fastpyvectordb_jax.server.app import create_app
from fastpyvectordb_jax.server.router import _shard_of, create_router_app


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class AppThread:
    def __init__(self, app_factory):
        self.port = free_port()
        self.loop = asyncio.new_event_loop()
        self.started = threading.Event()
        self._factory = app_factory
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        assert self.started.wait(20), "server failed to start"

    def _run(self):
        asyncio.set_event_loop(self.loop)
        from aiohttp import web
        app = self._factory()
        runner = web.AppRunner(app)
        self.loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", self.port)
        self.loop.run_until_complete(site.start())
        self.started.set()
        self.loop.run_forever()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.port}"


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("router")
    shards = [AppThread(lambda i=i: create_app(
        db_path=str(tmp / f"s{i}"), full=False)) for i in range(2)]
    router = AppThread(
        lambda: create_router_app([s.url for s in shards]))
    yield router, shards


def test_health_aggregates(cluster):
    router, shards = cluster
    r = httpx.get(router.url + "/health", timeout=30).json()
    assert r["status"] == "ok" and r["n_shards"] == 2
    assert all(p["ok"] for p in r["shards"])


def test_sharded_crud_and_merged_search(cluster):
    router, shards = cluster
    rng = np.random.default_rng(0)
    n, d, k = 120, 16, 10
    v = rng.standard_normal((n, d)).astype(np.float32)
    ids = [f"v{i}" for i in range(n)]

    with httpx.Client(base_url=router.url, timeout=60) as c:
        c.post("/collections", json={"name": "m", "dimensions": d,
                                     "metric": "l2"}).raise_for_status()
        r = c.post("/collections/m/vectors/batch",
                   json={"vectors": v.tolist(), "ids": ids,
                         "metadatas": [{"i": i} for i in range(n)]})
        r.raise_for_status()
        assert r.json()["ids"] == ids

        # rows actually split across shards
        info = c.get("/collections/m").json()
        assert info["count"] == n and info["n_shards"] == 2
        per = [httpx.get(s.url + "/collections/m", timeout=30).json()["count"]
               for s in shards]
        assert sorted(per) != [0, n] and sum(per) == n

        # point reads route to the owning shard
        got = c.get("/collections/m/vectors/v7").json()
        assert got["id"] == "v7" and got["metadata"]["i"] == 7

        # merged search == brute-force over the union
        q = v[3] + 0.01
        hits = c.post("/collections/m/search",
                      json={"vector": q.tolist(), "k": k}).json()["results"]
        d2 = np.linalg.norm(v - q[None, :], axis=1)
        expect = [ids[i] for i in np.argsort(d2)[:k]]
        assert [h["id"] for h in hits] == expect
        scores = [h["score"] for h in hits]
        assert scores == sorted(scores)

        # batch merge, one row per query
        out = c.post("/collections/m/search/batch",
                     json={"vectors": [v[5].tolist(), v[50].tolist()],
                           "k": 3}).json()["results"]
        assert out[0][0]["id"] == "v5" and out[1][0]["id"] == "v50"

        # delete routes home and disappears from merged results
        assert c.delete("/collections/m/vectors/v5").status_code == 200
        out = c.post("/collections/m/search",
                     json={"vector": v[5].tolist(), "k": 3}).json()["results"]
        assert "v5" not in [h["id"] for h in out]

        # id listing aggregates across shards
        listed = c.get("/collections/m/ids", params={"limit": 1000}).json()
        assert listed["total"] == n - 1


def test_concurrent_singles_coalesce_correctly(cluster):
    """Fire many simultaneous single-query searches: the router coalesces
    them into shard batch calls and must demultiplex each caller's own
    top-1 back to it (no row swaps, no stranded futures)."""
    import concurrent.futures

    router, _ = cluster
    rng = np.random.default_rng(7)
    n, d = 64, 16
    v = rng.standard_normal((n, d)).astype(np.float32)
    ids = [f"c{i}" for i in range(n)]
    with httpx.Client(base_url=router.url, timeout=60) as c:
        c.post("/collections", json={"name": "cc", "dimensions": d,
                                     "metric": "l2"}).raise_for_status()
        c.post("/collections/cc/vectors/batch",
               json={"vectors": v.tolist(), "ids": ids,
                     "metadatas": [{"i": i} for i in range(n)]}
               ).raise_for_status()

        def one(i):
            r = httpx.post(router.url + "/collections/cc/search",
                           json={"vector": v[i].tolist(), "k": 3},
                           timeout=60)
            r.raise_for_status()
            return i, r.json()

        with concurrent.futures.ThreadPoolExecutor(32) as ex:
            outs = list(ex.map(one, range(n)))
        for i, out in outs:
            hits = out["results"]
            assert hits[0]["id"] == f"c{i}", (i, hits[:2])
            assert hits[0]["metadata"]["i"] == i
            assert out["shards_ok"] == 2
        # different k values land in different buckets but still resolve
        def one_k(i, k):
            r = httpx.post(router.url + "/collections/cc/search",
                           json={"vector": v[i].tolist(), "k": k},
                           timeout=60)
            r.raise_for_status()
            return len(r.json()["results"])
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            ks = list(ex.map(lambda t: one_k(*t),
                             [(i, 1 + i % 5) for i in range(16)]))
        assert ks == [1 + i % 5 for i in range(16)]


def test_shard_assignment_is_stable():
    assert _shard_of("abc", 4) == _shard_of("abc", 4)
    spread = {_shard_of(f"id{i}", 4) for i in range(64)}
    assert spread == {0, 1, 2, 3}


def test_search_propagates_missing_collection(cluster):
    router, _ = cluster
    r = httpx.post(router.url + "/collections/nope/search",
                   json={"vector": [0.0] * 16, "k": 3}, timeout=30)
    assert r.status_code == 404


def test_shard_outage_degrades_not_500(tmp_path):
    """One dead shard must degrade coverage, not fail the front."""
    shard = AppThread(lambda: create_app(db_path=str(tmp_path / "solo"),
                                         full=False))
    dead_port = free_port()  # nothing listening
    router = AppThread(lambda: create_router_app(
        [shard.url, f"http://127.0.0.1:{dead_port}"]))
    with httpx.Client(base_url=router.url, timeout=60) as c:
        h = c.get("/health").json()
        assert h["status"] == "degraded"
        assert sum(1 for p in h["shards"] if p["ok"]) == 1
        # collection DDL reports the failure honestly
        r = c.post("/collections", json={"name": "d", "dimensions": 8,
                                         "metric": "l2"})
        assert r.status_code >= 400 and "partial" in r.json()
        # search still serves from the live shard
        import numpy as np
        v = np.eye(8, dtype=np.float32)
        httpx.post(shard.url + "/collections/d/vectors/batch",
                   json={"vectors": v.tolist(),
                         "ids": [f"v{i}" for i in range(8)]},
                   timeout=30).raise_for_status()
        out = c.post("/collections/d/search",
                     json={"vector": v[2].tolist(), "k": 3}).json()
        assert out["shards_ok"] == 1
        assert out["results"][0]["id"] == "v2"


def test_shard_outage_single_target_ops_503(tmp_path):
    """Handlers without fan-out (get/list/ids/delete-collection) must map
    a dead shard to 503/degraded JSON, never a raw 500."""
    shard = AppThread(lambda: create_app(db_path=str(tmp_path / "solo2"),
                                         full=False))
    dead_port = free_port()
    router = AppThread(lambda: create_router_app(
        [shard.url, f"http://127.0.0.1:{dead_port}"]))
    with httpx.Client(base_url=router.url, timeout=60) as c:
        c.post("/collections", json={"name": "o", "dimensions": 4,
                                     "metric": "l2"})
        import numpy as np
        httpx.post(shard.url + "/collections/o/vectors/batch",
                   json={"vectors": np.eye(4, dtype=np.float32).tolist(),
                         "ids": [f"v{i}" for i in range(4)]},
                   timeout=30).raise_for_status()
        # aggregate view serves from the live shard, flags coverage
        info = c.get("/collections/o")
        assert info.status_code == 200 and info.json()["shards_ok"] == 1
        # listing collections falls through to a reachable shard
        assert c.get("/collections").status_code == 200
        # ids pagination works with one shard down
        ids = c.get("/collections/o/ids", params={"limit": 2})
        assert ids.status_code == 200 and ids.json()["shards_ok"] == 1
        # single-vector ops on ids homed on the DEAD shard return 503
        homed_dead = next(f"k{i}" for i in range(100)
                          if _shard_of(f"k{i}", 2) == 1)
        r = c.get(f"/collections/o/vectors/{homed_dead}")
        assert r.status_code == 503
        r = c.delete(f"/collections/o/vectors/{homed_dead}")
        assert r.status_code == 503
        # delete_collection reports the partial outcome, does not raise
        r = c.delete("/collections/o")
        assert r.status_code >= 400 and "partial" in r.json()


def test_insert_batch_metadata_length_check(tmp_path):
    shard = AppThread(lambda: create_app(db_path=str(tmp_path / "m"),
                                         full=False))
    router = AppThread(lambda: create_router_app([shard.url]))
    with httpx.Client(base_url=router.url, timeout=60) as c:
        c.post("/collections", json={"name": "mm", "dimensions": 4,
                                     "metric": "l2"})
        r = c.post("/collections/mm/vectors/batch",
                   json={"vectors": [[1, 0, 0, 0], [0, 1, 0, 0]],
                         "ids": ["a", "b"], "metadatas": [{"x": 1}]})
        assert r.status_code == 400


def test_list_collections_counts_exact(cluster):
    """Aggregated counts must equal the sum of shard counts — the merge
    used to double-count the first shard (setdefault copied info and then
    added its count on top)."""
    router, shards = cluster
    rng = np.random.default_rng(3)
    httpx.post(router.url + "/collections",
               json={"name": "cnt", "dimensions": 8}, timeout=30)
    vecs = rng.standard_normal((50, 8)).astype(np.float32)
    httpx.post(router.url + "/collections/cnt/vectors/batch",
               json={"vectors": vecs.tolist(),
                     "ids": [f"c{i}" for i in range(50)]}, timeout=60)
    listing = httpx.get(router.url + "/collections", timeout=30).json()
    items = listing.get("collections", listing)
    got = {i["name"]: i.get("count") for i in items}
    # ground truth: sum the per-shard counts directly
    want = 0
    for s in shards:
        r = httpx.get(s.url + "/collections/cnt", timeout=30)
        if r.status_code == 200:
            want += r.json().get("count", 0)
    assert want == 50
    assert got["cnt"] == want, (got["cnt"], want)
    single = httpx.get(router.url + "/collections/cnt", timeout=30).json()
    assert single.get("count") == want


def test_router_optimize_fans_out(cluster):
    router, shards = cluster
    rng = np.random.default_rng(4)
    httpx.post(router.url + "/collections",
               json={"name": "ropt", "dimensions": 8}, timeout=30)
    vecs = rng.standard_normal((160, 8)).tolist()
    httpx.post(router.url + "/collections/ropt/vectors/batch",
               json={"vectors": vecs,
                     "ids": [f"r{i}" for i in range(160)]}, timeout=120)
    r = httpx.post(router.url + "/collections/ropt/optimize",
                   json={"target_recall": 0.9}, timeout=300)
    assert r.status_code == 200, r.text
    per = r.json()["per_shard"]
    assert len(per) == 2
    # tiny per-shard corpora resolve to exact on both shards
    assert all(p["installed"] == "exact" for p in per)
    # merged search still correct through the installed defaults
    r = httpx.post(router.url + "/collections/ropt/search",
                   json={"vector": vecs[5], "k": 3}, timeout=120)
    assert r.json()["results"][0]["id"] == "r5"
