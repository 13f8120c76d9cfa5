"""End-to-end REST/WS server tests: real aiohttp server on a port, driven
through the httpx VectorDBClient (parity: reference server_full.py API)."""

import asyncio
import json
import socket
import threading
import time

import numpy as np
import pytest

aiohttp = pytest.importorskip("aiohttp")

from fastpyvectordb_jax.http_client import VectorDBClient
from fastpyvectordb_jax.server.app import create_app


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ServerThread:
    def __init__(self, tmp_path):
        self.port = free_port()
        self.tmp_path = tmp_path
        self.loop = asyncio.new_event_loop()
        self.started = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        assert self.started.wait(15), "server failed to start"

    def _run(self):
        asyncio.set_event_loop(self.loop)
        from aiohttp import web
        app = create_app(db_path=str(self.tmp_path / "srv"),
                         embedding_provider="hashing",
                         graph_path=str(self.tmp_path / "srv_graph"))
        runner = web.AppRunner(app)
        self.loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", self.port)
        self.loop.run_until_complete(site.start())
        self.started.set()
        self.loop.run_forever()

    def stop(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(5)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    srv = ServerThread(tmp_path_factory.mktemp("server"))
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def client(server):
    with VectorDBClient(f"http://127.0.0.1:{server.port}") as c:
        yield c


def test_health(client):
    h = client.health()
    assert h["status"] == "ok" and "uptime_s" in h


def test_collection_lifecycle(client):
    client.create_collection("vecs", 8, metric="l2")
    info = client.get_collection("vecs")
    assert info["dimensions"] == 8 and info["metric"] == "l2"
    assert any(c["name"] == "vecs" for c in client.list_collections())
    assert client.get_collection("missing") is None


def test_vector_crud_and_search(client):
    rng = np.random.default_rng(0)
    v = rng.standard_normal((20, 8)).astype(np.float32)
    ids = client.insert_batch("vecs", v, [f"v{i}" for i in range(20)],
                              [{"g": i % 2} for i in range(20)])
    assert len(ids) == 20
    one = client.insert("vecs", v[0] * 0.5, "extra", {"g": 9})
    assert one == "extra"
    got = client.get("vecs", "v3", include_vector=True)
    np.testing.assert_allclose(got["vector"], v[3], rtol=1e-5)
    assert client.get("vecs", "ghost") is None

    res = client.search("vecs", vector=v[7], k=3)
    assert res["results"][0]["id"] == "v7" and res["took_ms"] >= 0
    res = client.search("vecs", vector=v[7], k=20, where={"g": 1})
    assert all(r["metadata"]["g"] == 1 for r in res["results"])

    res = client.search_batch("vecs", vectors=v[[1, 2]], k=1)
    assert [r[0]["id"] for r in res["results"]] == ["v1", "v2"]

    client.upsert("vecs", v[5] * 2, "v5", {"g": 5})
    assert client.get("vecs", "v5")["metadata"]["g"] == 5
    assert client.delete("vecs", "v5")
    assert not client.delete("vecs", "v5")
    assert "v0" in client.list_ids("vecs", limit=100)


def test_filter_tree_search(client):
    from fastpyvectordb_jax import Filter
    f = Filter.or_([Filter.eq("g", 0), Filter.eq("g", 9)])
    res = client.search("vecs", vector=np.zeros(8), k=30,
                        filter_tree=f.to_dict())
    gs = {r["metadata"]["g"] for r in res["results"]}
    assert gs <= {0, 9} and 9 in gs


def test_text_endpoints(client):
    client.create_collection("texts", 384)
    rid = client.insert_text("texts", "the hungry cat", metadata={"lang": "en"})
    client.insert_text("texts", "stock market news")
    res = client.search("texts", text="hungry cats eat", k=1)
    assert res["results"][0]["id"] == rid
    emb = client.embed("hello world")
    assert emb.shape == (384,)
    assert client.embed_batch(["a", "b"]).shape == (2, 384)


def test_validation_errors(client):
    import httpx
    with pytest.raises(httpx.HTTPStatusError) as ei:
        client.create_collection("bad", -5)
    assert ei.value.response.status_code == 422
    with pytest.raises(httpx.HTTPStatusError) as ei:
        client.create_collection("vecs", 8)  # duplicate
    assert ei.value.response.status_code == 409
    r = httpx.post(f"{client.base_url}/collections/vecs/search",
                   json={"k": 3})  # neither vector nor text
    assert r.status_code == 400
    r = httpx.post(f"{client.base_url}/collections/nope/search",
                   json={"vector": [0] * 8})
    assert r.status_code == 404
    # query dimension mismatch must be a 400, not an unhandled 500
    r = httpx.post(f"{client.base_url}/collections/vecs/search",
                   json={"vector": [0.0] * 5, "k": 3})
    assert r.status_code == 400
    r = httpx.post(f"{client.base_url}/collections/vecs/search/batch",
                   json={"vectors": [[0.0] * 5], "k": 3})
    assert r.status_code == 400


def test_graph_endpoints(client):
    client.create_node(["Person"], {"name": "Ada"}, id="ada")
    client.create_node(["Person"], {"name": "Bob"}, id="bobn")
    client.create_edge("ada", "bobn", "KNOWS")
    assert client.get_node("ada")["properties"]["name"] == "Ada"
    assert client.get_node("ghost") is None
    assert {n["id"] for n in client.find_nodes(label="Person")} == \
        {"ada", "bobn"}
    assert [n["id"] for n in client.neighbors("ada", "out")] == ["bobn"]
    rows = client.graph_query("MATCH (n:Person) RETURN n.name")
    assert sorted(r["n.name"] for r in rows) == ["Ada", "Bob"]
    assert client.shortest_path("ada", "bobn") == ["ada", "bobn"]
    assert client.traverse("ada", 1) == [["ada", "bobn"]]
    client.update_node("ada", properties={"age": 36})
    assert client.get_node("ada")["properties"]["age"] == 36
    assert client.delete_node("bobn")


def test_admin_save_and_persistence(client, server):
    assert client.save()
    assert (server.tmp_path / "srv" / "vecs").exists()


def test_websocket_change_feed(client, server):
    if client.get_collection("wsfeed") is None:
        client.create_collection("wsfeed", 8)
    received = []

    async def listen_and_mutate():
        import aiohttp
        async with aiohttp.ClientSession() as session:
            async with session.ws_connect(
                    f"http://127.0.0.1:{server.port}/ws/wsfeed") as ws:
                # trigger an insert from a worker thread while listening
                def do_insert():
                    time.sleep(0.2)
                    client.insert("wsfeed", np.zeros(8), "ws_probe")
                t = threading.Thread(target=do_insert)
                t.start()
                # connect replays history (e.g. collection_created) first;
                # read until the live insert arrives
                for _ in range(10):
                    msg = await asyncio.wait_for(ws.receive(), timeout=10)
                    received.append(json.loads(msg.data))
                    if received[-1]["type"] == "insert":
                        break
                t.join()

    asyncio.run(listen_and_mutate())
    assert received and received[-1]["type"] == "insert"
    assert received[-1]["data"]["id"] == "ws_probe"
    assert received[-1]["collection"] == "wsfeed"


def test_hyperedge_endpoints(client):
    import httpx
    client.create_node(["H"], id="h1")
    client.create_node(["H"], id="h2")
    r = httpx.post(f"{client.base_url}/graph/hyperedges",
                   json={"nodes": ["h1", "h2"], "type": "TEAM", "id": "team1"})
    assert r.status_code == 201
    r = httpx.get(f"{client.base_url}/graph/hyperedges/team1")
    assert r.json()["nodes"] == ["h1", "h2"]
    r = httpx.get(f"{client.base_url}/graph/nodes/h1/hyperedges")
    assert len(r.json()["hyperedges"]) == 1
    assert httpx.delete(
        f"{client.base_url}/graph/hyperedges/team1").status_code == 200
    assert httpx.get(
        f"{client.base_url}/graph/hyperedges/team1").status_code == 404


def test_batcher_coalesces_concurrent_queries():
    """Concurrent single-query requests in one window must merge into one
    device dispatch per (collection, k, filter) bucket."""
    import asyncio
    from fastpyvectordb_jax import Collection, CollectionConfig
    from fastpyvectordb_jax.server.batcher import QueryBatcher

    col = Collection(CollectionConfig(name="b", dimensions=8, metric="l2"))
    rng = np.random.default_rng(0)
    v = rng.standard_normal((50, 8)).astype(np.float32)
    col.insert_batch(v, [f"v{i}" for i in range(50)])

    calls = []
    orig = col.search_batch

    def counting(queries, *a, **kw):
        calls.append(np.asarray(queries).shape[0])
        return orig(queries, *a, **kw)

    col.search_batch = counting

    async def run():
        b = QueryBatcher(window_ms=20, max_batch=64)
        results = await asyncio.gather(
            *[b.search(col, v[i], k=1) for i in range(8)])
        return results

    results = asyncio.run(run())
    assert [hits[0].id for hits in results] == [f"v{i}" for i in range(8)]
    assert calls == [8], f"expected one coalesced batch, got {calls}"


def test_batcher_continuous_coalescing_under_inflight():
    """While a dispatch is computing, arrivals must ACCUMULATE and flush as
    one wave on completion — not flush one-by-one after the fixed window
    (a fixed-window design degrades to batch-of-1 dispatches under
    concurrent load)."""
    import asyncio
    import time as _t
    from fastpyvectordb_jax import Collection, CollectionConfig
    from fastpyvectordb_jax.server.batcher import QueryBatcher

    col = Collection(CollectionConfig(name="cb", dimensions=8, metric="l2"))
    rng = np.random.default_rng(2)
    v = rng.standard_normal((64, 8)).astype(np.float32)
    col.insert_batch(v, [f"v{i}" for i in range(64)])

    calls = []
    orig = col.search_batch

    def slow(queries, *a, **kw):
        calls.append(np.asarray(queries).shape[0])
        _t.sleep(0.05)  # a slow device dispatch
        return orig(queries, *a, **kw)

    col.search_batch = slow

    async def run():
        b = QueryBatcher(window_ms=1, max_batch=64)

        async def one(i, delay):
            await asyncio.sleep(delay)
            return await b.search(col, v[i], k=1)

        # staggered arrivals spread over ~64 ms: far wider than the 1 ms
        # window, but they all land while earlier dispatches compute
        return await asyncio.gather(
            *[one(i, 0.002 * i) for i in range(32)])

    results = asyncio.run(run())
    assert [h[0].id for h in results] == [f"v{i}" for i in range(32)]
    # continuous batching: the 32 staggered requests must ride FEW waves
    # (first ~1-2 alone, then big accumulated waves); one-per-request
    # would be 32 calls
    assert sum(calls) == 32
    assert len(calls) <= 8, f"expected few coalesced waves, got {calls}"


def test_batcher_bad_query_fails_bucket_not_hangs():
    """A malformed query coalesced into a bucket must reject the whole
    flush with an exception on every future — never leave them pending
    (the np.stack used to run outside the try block)."""
    import asyncio
    from fastpyvectordb_jax import Collection, CollectionConfig
    from fastpyvectordb_jax.server.batcher import QueryBatcher

    col = Collection(CollectionConfig(name="bb", dimensions=8, metric="l2"))
    rng = np.random.default_rng(1)
    col.insert_batch(rng.standard_normal((10, 8)).astype(np.float32),
                     [f"v{i}" for i in range(10)])

    async def run():
        b = QueryBatcher(window_ms=10, max_batch=64)
        good = rng.standard_normal(8).astype(np.float32)
        bad = rng.standard_normal(5).astype(np.float32)  # wrong dims
        outs = await asyncio.wait_for(asyncio.gather(
            b.search(col, good, k=1), b.search(col, bad, k=1),
            return_exceptions=True), timeout=10)
        return outs

    outs = asyncio.run(run())
    # no hang (wait_for passed) and at least the bad request errored
    assert any(isinstance(o, Exception) for o in outs), outs


def test_batcher_admission_control_rejects_backlog():
    """Beyond max_queue pending requests per bucket, new arrivals must be
    rejected IMMEDIATELY with QueueFull — an open-loop overload degrades
    to fast 503s, not multi-second queueing (round-3: p99 8 s at c256)."""
    import asyncio
    import time as _t
    from fastpyvectordb_jax import Collection, CollectionConfig
    from fastpyvectordb_jax.server.batcher import QueryBatcher, QueueFull

    col = Collection(CollectionConfig(name="ac", dimensions=8, metric="l2"))
    rng = np.random.default_rng(3)
    v = rng.standard_normal((16, 8)).astype(np.float32)
    col.insert_batch(v, [f"v{i}" for i in range(16)])

    orig = col.search_batch

    def slow(queries, *a, **kw):
        _t.sleep(0.1)  # pin the first wave in flight
        return orig(queries, *a, **kw)

    col.search_batch = slow

    async def run():
        b = QueryBatcher(window_ms=1, max_batch=2, max_queue=4)
        # wave 1 (2 requests) dispatches; 4 more fill the backlog; the
        # rest must be rejected at enqueue time
        outs = await asyncio.gather(
            *[b.search(col, v[i % 16], k=1) for i in range(12)],
            return_exceptions=True)
        return outs

    outs = asyncio.run(run())
    served = [o for o in outs if not isinstance(o, Exception)]
    rejected = [o for o in outs if isinstance(o, QueueFull)]
    assert rejected, "expected QueueFull rejections at backlog limit"
    assert served, "admission control must not reject everything"
    assert len(served) + len(rejected) == 12, outs


def test_batcher_coalesces_quantized_singles():
    """Quantized singles must ride the batcher like exact ones (round 3
    dispatched each in its own executor call) — and in their OWN bucket,
    never np.stack'ed with exact queries."""
    import asyncio
    from fastpyvectordb_jax import Collection, CollectionConfig
    from fastpyvectordb_jax.server.batcher import QueryBatcher

    col = Collection(CollectionConfig(name="qb", dimensions=8, metric="l2"))
    rng = np.random.default_rng(4)
    v = rng.standard_normal((64, 8)).astype(np.float32)
    col.insert_batch(v, [f"v{i}" for i in range(64)])
    col.enable_quantized_scan(kind="int8")

    qcalls, ecalls = [], []
    orig_q = col.search_quantized_arrays
    orig_e = col.search_arrays

    def counting_q(queries, *a, **kw):
        qcalls.append(np.asarray(queries).shape[0])
        return orig_q(queries, *a, **kw)

    def counting_e(queries, *a, **kw):
        ecalls.append(np.asarray(queries).shape[0])
        return orig_e(queries, *a, **kw)

    col.search_quantized_arrays = counting_q
    col.search_arrays = counting_e

    async def run():
        b = QueryBatcher(window_ms=20, max_batch=64)
        return await asyncio.gather(
            *[b.search_raw(col, v[i], k=1, quantized=True)
              for i in range(6)],
            *[b.search_raw(col, v[i], k=1) for i in range(6, 12)])

    results = asyncio.run(run())
    ids = [r[0][0] for r in results]
    assert ids == [f"v{i}" for i in range(12)]
    assert qcalls == [6], f"expected one quantized wave, got {qcalls}"
    assert ecalls == [6], f"expected one exact wave, got {ecalls}"


def test_server_search_wrong_dims_400(server):
    import httpx
    base = f"http://127.0.0.1:{server.port}"
    httpx.post(f"{base}/collections",
               json={"name": "wd", "dimensions": 8, "metric": "l2"},
               timeout=30)
    r = httpx.post(f"{base}/collections/wd/search",
                   json={"vector": [1.0, 2.0], "k": 3}, timeout=30)
    assert r.status_code == 400


def test_index_build_endpoints(client):
    import httpx
    rng = np.random.default_rng(1)
    client.create_collection("idx", 16, metric="l2")
    v = rng.standard_normal((300, 16)).astype(np.float32)
    client.insert_batch("idx", v, [f"v{i}" for i in range(300)])
    # IVF build over REST + ANN-mode search
    r = httpx.post(f"{client.base_url}/collections/idx/index",
                   json={"kind": "ivf", "params": {"nlist": 8, "nprobe": 4,
                                                   "iters": 3}}, timeout=120)
    assert r.status_code == 201 and r.json()["info"]["nlist"] == 8
    res = client.search("idx", vector=v[5], k=1)
    assert res["results"][0]["id"] == "v5"
    # quantized build + quantized-mode search
    r = httpx.post(f"{client.base_url}/collections/idx/index",
                   json={"kind": "int8"}, timeout=120)
    assert r.status_code == 201 and r.json()["info"]["compression_ratio"] > 3
    r = httpx.post(f"{client.base_url}/collections/idx/search",
                   json={"vector": v[7].tolist(), "k": 1,
                         "mode": "quantized"}, timeout=120)
    assert r.status_code == 200 and r.json()["results"][0]["id"] == "v7"
    # unknown kind
    r = httpx.post(f"{client.base_url}/collections/idx/index",
                   json={"kind": "hnswlib"})
    assert r.status_code == 400


def test_websocket_subscribe_message(client, server):
    """Subscription updates over the socket: replayed history filtered by
    the new event-type subscription."""
    if client.get_collection("wssub") is None:
        client.create_collection("wssub", 8)
    results = {}

    async def run():
        import aiohttp
        async with aiohttp.ClientSession() as session:
            async with session.ws_connect(
                    f"http://127.0.0.1:{server.port}/ws/wssub") as ws:
                await ws.send_str(json.dumps({
                    "action": "subscribe", "collection": "wssub",
                    "event_types": ["delete"]}))
                # ack arrives after any replayed history
                for _ in range(10):
                    msg = await asyncio.wait_for(ws.receive(), timeout=10)
                    data = json.loads(msg.data)
                    if data.get("subscribed"):
                        results["ack"] = True
                        break
                def mutate():
                    time.sleep(0.2)
                    client.insert("wssub", np.zeros(8), "subprobe")
                    client.delete("wssub", "subprobe")
                t = threading.Thread(target=mutate)
                t.start()
                msg = await asyncio.wait_for(ws.receive(), timeout=10)
                results["event"] = json.loads(msg.data)
                t.join()

    asyncio.run(run())
    assert results.get("ack") is True
    # the insert was filtered out; only the delete is delivered
    assert results["event"]["type"] == "delete"
    assert results["event"]["data"]["id"] == "subprobe"


def test_websocket_bad_event_type_keeps_connection(client, server):
    """An invalid event type in a subscribe message must produce an error
    reply, not tear down the websocket."""
    results = {}

    async def run():
        import aiohttp
        async with aiohttp.ClientSession() as session:
            async with session.ws_connect(
                    f"http://127.0.0.1:{server.port}/ws") as ws:
                await ws.send_str(json.dumps({
                    "action": "subscribe", "event_types": ["not-a-type"]}))
                # skip any replayed history events before the error reply
                for _ in range(30):
                    msg = await asyncio.wait_for(ws.receive(), timeout=10)
                    data = json.loads(msg.data)
                    if "error" in data:
                        results["reply"] = data
                        break
                # connection still alive: a valid subscribe now succeeds
                await ws.send_str(json.dumps({
                    "action": "subscribe", "event_types": ["insert"]}))
                for _ in range(10):
                    msg = await asyncio.wait_for(ws.receive(), timeout=10)
                    data = json.loads(msg.data)
                    if data.get("subscribed"):
                        results["ack"] = True
                        break

    asyncio.run(run())
    assert "error" in results["reply"]
    assert results.get("ack") is True


def test_metrics_endpoint(server):
    import httpx
    base = f"http://127.0.0.1:{server.port}"
    httpx.get(f"{base}/health", timeout=30)
    r = httpx.get(f"{base}/metrics", timeout=30)
    assert r.status_code == 200
    body = r.text
    assert "fpvt_requests_total" in body
    assert 'route="/health"' in body
    assert "fpvt_request_seconds_bucket" in body
    assert "fpvt_collections" in body


def test_metrics_unmatched_paths_collapse(server):
    import httpx
    base = f"http://127.0.0.1:{server.port}"
    for i in range(5):
        httpx.get(f"{base}/no/such/route/{i}", timeout=30)
    body = httpx.get(f"{base}/metrics", timeout=30).text
    assert 'route="<unmatched>"' in body
    assert "/no/such/route" not in body  # raw paths never become labels


def test_client_ids_with_special_chars_roundtrip(client):
    """Ids containing '/' or '#' must survive the HTTP path (percent-
    encoded), not 404 or hit a truncated id."""
    client.create_collection("sp", dimensions=4, metric="l2")
    client.insert("sp", [1, 0, 0, 0], id="doc/1")
    client.insert("sp", [0, 1, 0, 0], id="a#1")
    client.insert("sp", [0, 0, 1, 0], id="a")
    assert client.get("sp", "doc/1") is not None
    assert client.get("sp", "a#1") is not None
    assert client.delete("sp", "a#1") is True
    # 'a' must NOT have been deleted by a fragment-truncated path
    assert client.get("sp", "a") is not None


def test_prewarm_flag_compiles_at_startup(tmp_path, capsys):
    """create_app(prewarm=N) compiles the serving shapes during app
    startup, before the first request (ROADMAP #11)."""
    from aiohttp import web
    from fastpyvectordb_jax import VectorDB
    path = tmp_path / "pw_srv"
    db = VectorDB(str(path))
    col = db.create_collection("warm", dimensions=8, metric="l2")
    rng = np.random.default_rng(2)
    col.insert_batch(rng.standard_normal((64, 8)).astype(np.float32),
                     [f"v{i}" for i in range(64)])
    db.save()

    app = create_app(db_path=str(path), full=False, prewarm=2)
    loop = asyncio.new_event_loop()
    try:
        runner = web.AppRunner(app)
        loop.run_until_complete(runner.setup())  # fires on_startup
        loop.run_until_complete(runner.cleanup())
    finally:
        loop.close()
    assert "prewarmed warm" in capsys.readouterr().out


def test_create_collection_validation_is_400_not_409(server, client):
    import httpx
    r = httpx.post(f"http://127.0.0.1:{server.port}/collections",
                   json={"name": "badmetric", "dimensions": 8,
                         "metric": "euclidean-typo"}, timeout=30)
    assert r.status_code == 400, r.text  # 409 means "already exists"


def test_search_batch_honors_mode(server, client):
    import httpx
    """JSON /search/batch must honor exact/mode like the single-search
    endpoint — a client demanding exact must not silently get ANN."""
    base = f"http://127.0.0.1:{server.port}"
    httpx.post(f"{base}/collections",
               json={"name": "bm", "dimensions": 8}, timeout=30)
    vecs = np.random.default_rng(0).standard_normal((50, 8)).tolist()
    httpx.post(f"{base}/collections/bm/vectors/batch",
               json={"vectors": vecs,
                     "ids": [f"b{i}" for i in range(50)]}, timeout=60)
    r = httpx.post(f"{base}/collections/bm/search/batch",
                   json={"vectors": vecs[:2], "k": 3, "mode": "exact"},
                   timeout=60)
    assert r.status_code == 200
    assert r.json()["results"][0][0]["id"] == "b0"
    # a typo'd mode must 422, not silently route
    r = httpx.post(f"{base}/collections/bm/search/batch",
                   json={"vectors": vecs[:1], "k": 3, "mode": "exat"},
                   timeout=30)
    assert r.status_code == 422


def test_text_search_embedder_dims_mismatch_is_400(server, client):
    import httpx
    """A wrong-dims embedding must 400 THIS request, not poison the
    coalesced batcher bucket shared with concurrent vector queries."""
    base = f"http://127.0.0.1:{server.port}"
    # hashing embedder defaults to its own dims; make a collection whose
    # dims can't match it
    httpx.post(f"{base}/collections",
               json={"name": "txtdim", "dimensions": 3}, timeout=30)
    r = httpx.post(f"{base}/collections/txtdim/search",
                   json={"text": "hello", "k": 2}, timeout=60)
    assert r.status_code == 400
    assert "dims" in r.text or "-d" in r.text


def test_optimize_endpoint_installs_mode(server, client):
    import httpx
    base = f"http://127.0.0.1:{server.port}"
    httpx.post(f"{base}/collections",
               json={"name": "optsrv", "dimensions": 8}, timeout=30)
    vecs = np.random.default_rng(2).standard_normal((200, 8)).tolist()
    httpx.post(f"{base}/collections/optsrv/vectors/batch",
               json={"vectors": vecs,
                     "ids": [f"o{i}" for i in range(200)]}, timeout=120)
    r = httpx.post(f"{base}/collections/optsrv/optimize",
                   json={"target_recall": 0.9, "k": 5}, timeout=300)
    assert r.status_code == 200, r.text
    rep = r.json()
    # 200 rows sit under the quantizer-build floor: exact must win
    assert rep["installed"] == "exact"
    assert rep["exact"]["eligible"] is True
    # searches still work through the installed default
    r = httpx.post(f"{base}/collections/optsrv/search",
                   json={"vector": vecs[3], "k": 3}, timeout=120)
    assert r.status_code == 200
    assert r.json()["results"][0]["id"] == "o3"
