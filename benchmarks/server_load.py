"""Serving-layer load benchmark.

Boots the aiohttp server in-process over a corpus on the active backend
(the GPU, or the CPU with --cpu), then drives /search with N concurrent
httpx clients sending distinct query vectors.  Reports server-level QPS /
p50 / p99 for:

  * sequential single-query calls (the dispatch-bound floor)
  * concurrent singles through the QueryBatcher (coalesced into batched
    device dispatches transparently)
  * client-side search/batch calls (the explicit batch ceiling)

Reference number to beat: 8,498 QPS hnswlib serving (notes_benchmark.txt:31).
"""

import argparse
import asyncio
import json
import socket
import threading
import time

import numpy as np


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ServerThread:
    def __init__(self, tmp=None):
        import tempfile
        tmp = tmp or tempfile.mkdtemp(prefix="srv_load_")
        from aiohttp import web
        from fastpyvectordb_jax.server.app import create_app
        self.port = free_port()
        self.loop = asyncio.new_event_loop()
        self.started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            app = create_app(db_path=tmp, embedding_provider="hashing",
                             graph_path=tmp + "_graph")
            self.app = app
            runner = web.AppRunner(app)
            self.loop.run_until_complete(runner.setup())
            site = web.TCPSite(runner, "127.0.0.1", self.port)
            self.loop.run_until_complete(site.start())
            self.started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert self.started.wait(30)


async def drive_concurrent(base, queries, concurrency, k, binary=False,
                           mode=None):
    """N workers, each sending its slice of distinct queries serially."""
    import httpx
    import msgpack
    lat = []
    took = []  # server-side per-request time (includes batcher wait)
    done = [0]
    hdr = {"Content-Type": "application/msgpack"}
    extra = {"mode": mode} if mode else {}

    rejected = [0]  # 503s from batcher admission control: counted, not timed

    async def worker(wq):
        async with httpx.AsyncClient(base_url=base, timeout=600) as c:
            for q in wq:
                t0 = time.perf_counter()
                if binary:
                    r = await c.post(
                        "/collections/load/search", headers=hdr,
                        content=msgpack.packb(
                            {"vector": q.tobytes(), "k": k, **extra},
                            use_bin_type=True))
                    if r.status_code == 503:
                        rejected[0] += 1
                        continue
                    r.raise_for_status()
                    took.append(msgpack.unpackb(r.content).get("took_ms", 0))
                else:
                    r = await c.post("/collections/load/search",
                                     json={"vector": q.tolist(), "k": k,
                                           **extra})
                    if r.status_code == 503:
                        rejected[0] += 1
                        continue
                    r.raise_for_status()
                    took.append(r.json().get("took_ms", 0))
                lat.append(time.perf_counter() - t0)
                done[0] += 1

    per = len(queries) // concurrency
    slices = [queries[i * per:(i + 1) * per] for i in range(concurrency)]
    t0 = time.perf_counter()
    await asyncio.gather(*[worker(s) for s in slices])
    wall = time.perf_counter() - t0
    arr = np.asarray(sorted(lat))
    tk = np.asarray(sorted(took))
    out = {"qps": round(done[0] / wall, 1),
           "p50_ms": round(float(arr[len(arr) // 2]) * 1e3, 2),
           "p99_ms": round(float(arr[int(len(arr) * 0.99)]) * 1e3, 2),
           "srv_p50_ms": round(float(tk[len(tk) // 2]), 2),
           "n": done[0]}
    if rejected[0]:
        out["rejected_503"] = rejected[0]
    return out


async def drive_batched(base, queries, batch, k, binary=False,
                        pipeline=2, mode=None):
    """Client-side batch calls; ``pipeline`` in-flight requests keep the
    server busy while the client serializes the next batch."""
    import httpx
    import msgpack
    hdr = {"Content-Type": "application/msgpack"}
    t0 = time.perf_counter()
    total = [0]
    qarr = np.stack(queries)
    starts = list(range(0, len(queries), batch))

    took = []  # server-side handler time: isolates server cost from
    # client serialization when a mode's end-to-end QPS disagrees with
    # its kernel ordering

    async def send(c, s):
        chunk = qarr[s: s + batch]
        if binary:
            body = {"vectors": np.ascontiguousarray(chunk).tobytes(),
                    "k": k}
            if mode:
                body["mode"] = mode
            r = await c.post(
                "/collections/load/search/batch", headers=hdr,
                content=msgpack.packb(body, use_bin_type=True))
            r.raise_for_status()
            took.append(msgpack.unpackb(r.content).get("took_ms", 0))
        else:
            body = {"vectors": chunk.tolist(), "k": k}
            if mode:
                body["mode"] = mode
            r = await c.post("/collections/load/search/batch", json=body)
            r.raise_for_status()
            took.append(r.json().get("took_ms", 0))
        total[0] += len(chunk)

    async with httpx.AsyncClient(base_url=base, timeout=600) as c:
        for g in range(0, len(starts), pipeline):
            await asyncio.gather(*[send(c, s)
                                   for s in starts[g: g + pipeline]])
    wall = time.perf_counter() - t0
    tk = sorted(took)
    return {"qps": round(total[0] / wall, 1), "n": total[0],
            "srv_p50_ms": round(float(tk[len(tk) // 2]), 2)}


async def recall_probe(base, queries, gt_ids, k, binary=False, mode=None):
    """Serving-path recall@k vs in-process f32 exact ground truth: QPS
    and latency alone would pass a serving regression that silently
    degrades result quality (stale tuned rerank after a rebuild, wrong
    mode routed)."""
    import httpx
    import msgpack
    qarr = np.stack(queries)
    async with httpx.AsyncClient(base_url=base, timeout=600) as c:
        if binary:
            body = {"vectors": np.ascontiguousarray(qarr).tobytes(), "k": k}
            if mode:
                body["mode"] = mode
            r = await c.post("/collections/load/search/batch",
                             headers={"Content-Type": "application/msgpack"},
                             content=msgpack.packb(body, use_bin_type=True))
            r.raise_for_status()
            got = msgpack.unpackb(r.content)["ids"]
        else:
            body = {"vectors": qarr.tolist(), "k": k}
            if mode:
                body["mode"] = mode
            r = await c.post("/collections/load/search/batch", json=body)
            r.raise_for_status()
            got = [[h["id"] for h in hits] for hits in r.json()["results"]]
    hits = [len(set(g) & set(e)) / max(len(e), 1)
            for g, e in zip(got, gt_ids)]
    return round(float(np.mean(hits)), 4)


def exact_ground_truth(col, queries, k):
    """f32 exact top-k ids (full-precision scan over the store) for the
    recall column — independent of the collection's serving dtype."""
    q = np.stack(queries)
    _, rows = col._store.search(q, k, col.config.metric,
                                compute_dtype="float32")
    rows = np.asarray(rows)
    r2i = col._row_to_id
    return [[r2i[r] for r in row if 0 <= r < len(r2i) and r2i[r]]
            for row in rows]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--dims", type=int, default=768)
    ap.add_argument("--queries", type=int, default=2048)
    ap.add_argument("--k", type=int, default=10)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from fastpyvectordb_jax import compile_cache
    compile_cache.enable()

    import httpx
    srv = ServerThread()
    base = f"http://127.0.0.1:{srv.port}"
    rng = np.random.default_rng(0)

    print(json.dumps({"exp": "setup", "rows": args.rows, "dims": args.dims,
                      "platform": jax.devices()[0].platform}), flush=True)
    # bf16 serving config: halves HBM streaming and query-upload bytes
    # (the deployment default per DEPLOYMENT.md; recall impact <1%)
    httpx.post(f"{base}/collections",
               json={"name": "load", "dimensions": args.dims,
                     "metric": "cosine", "compute_dtype": "bfloat16",
                     "storage_dtype": "bfloat16", "topk": "auto"},
               timeout=60).raise_for_status()
    # measure API-path ingest on a slice (JSON-bound), then bulk-fill the
    # rest in-process — this benchmark targets SEARCH serving, and 1M rows
    # of 768-d JSON would dominate the run without informing it
    api_rows = min(20_000, args.rows)
    vecs = rng.standard_normal((api_rows, args.dims)).astype(np.float32)
    t0 = time.perf_counter()
    # chunked: 20k x 768-d rows are ~300 MB of JSON, over the server's
    # 256 MB request cap (app.py client_max_size)
    with httpx.Client(base_url=base, timeout=600) as c:
        for s in range(0, api_rows, 5000):
            e = min(s + 5000, api_rows)
            r = c.post("/collections/load/vectors/batch",
                       json={"vectors": vecs[s:e].tolist(),
                             "ids": [f"v{i}" for i in range(s, e)]})
            r.raise_for_status()
    print(json.dumps({"exp": "api_ingest",
                      "rows": api_rows,
                      "rows_per_s": round(api_rows
                                          / (time.perf_counter() - t0), 1)}),
          flush=True)
    # binary-body ingest of the same volume (server/wire.py raw-f32 path)
    import msgpack
    bvecs = rng.standard_normal((api_rows, args.dims)).astype(np.float32)
    t0 = time.perf_counter()
    with httpx.Client(base_url=base, timeout=600) as c:
        for s in range(0, api_rows, 5000):
            e = min(s + 5000, api_rows)
            r = c.post("/collections/load/vectors/batch",
                       headers={"Content-Type": "application/msgpack"},
                       content=msgpack.packb(
                           {"vectors": np.ascontiguousarray(
                                bvecs[s:e]).tobytes(),
                            "ids": [f"b{i}" for i in range(s, e)]},
                           use_bin_type=True))
            r.raise_for_status()
    print(json.dumps({"exp": "binary_ingest",
                      "rows": api_rows,
                      "rows_per_s": round(api_rows
                                          / (time.perf_counter() - t0), 1)}),
          flush=True)
    col = srv.app["state"]["db"].get_collection("load")
    t0 = time.perf_counter()
    inserted = 2 * api_rows  # JSON slice + binary slice above
    fill_start = inserted
    while inserted < args.rows:
        n = min(250_000, args.rows - inserted)
        block = rng.standard_normal((n, args.dims)).astype(np.float32)
        col.insert_batch(block, [f"v{inserted + i}" for i in range(n)])
        inserted += n
        print(f"\r  filled {inserted:,}/{args.rows:,} "
              f"({(inserted - fill_start)/(time.perf_counter()-t0):,.0f}/s)",
              end="", flush=True)
    print()

    queries = [rng.standard_normal(args.dims).astype(np.float32)
               for _ in range(args.queries)]
    gt64 = exact_ground_truth(col, queries[:64], args.k)

    # warmup (compile): queries pad to pow2 buckets (store.py:164), so
    # pre-compile every bucket IN-PROCESS first — a first compile inside
    # a request would trip HTTP client timeouts
    for b in (1, 8, 16, 32, 64, 128, 256, 512, 1024):
        t0 = time.perf_counter()
        col.search_batch(
            rng.standard_normal((b, args.dims)).astype(np.float32), args.k)
        print(json.dumps({"exp": f"prewarm_b{b}",
                          "s": round(time.perf_counter() - t0, 1)}),
              flush=True)
    for conc in (1, 4, 16, 64):
        asyncio.run(drive_concurrent(base, queries[: 2 * conc], conc, args.k))

    out = {"exp": "sequential_singles",
           **asyncio.run(drive_concurrent(base, queries[:256], 1, args.k))}
    out["recall_at_k"] = asyncio.run(
        recall_probe(base, queries[:64], gt64, args.k))
    print(json.dumps(out), flush=True)
    seq_qps = out["qps"]

    for conc in (16, 64, 128):
        asyncio.run(drive_concurrent(base, queries[: 4 * conc], conc,
                                     args.k))  # bucket warmup
        out = {"exp": f"concurrent_singles_c{conc}",
               **asyncio.run(drive_concurrent(base, queries, conc, args.k))}
        out["vs_sequential"] = round(out["qps"] / max(seq_qps, 1e-9), 2)
        print(json.dumps(out), flush=True)

    out = {"exp": "client_batched_b256",
           **asyncio.run(drive_batched(base, queries, 256, args.k))}
    out["vs_sequential"] = round(out["qps"] / max(seq_qps, 1e-9), 2)
    out["recall_at_k"] = asyncio.run(
        recall_probe(base, queries[:64], gt64, args.k))
    print(json.dumps(out), flush=True)

    # ---- binary wire path (msgpack + raw f32; server/wire.py) ----
    for conc in (64, 128, 256):
        asyncio.run(drive_concurrent(base, queries[: 4 * conc], conc,
                                     args.k, binary=True))  # warmup
        out = {"exp": f"binary_concurrent_singles_c{conc}",
               **asyncio.run(drive_concurrent(base, queries, conc, args.k,
                                              binary=True))}
        out["vs_sequential"] = round(out["qps"] / max(seq_qps, 1e-9), 2)
        print(json.dumps(out), flush=True)

    for batch in (256, 1024):
        if batch > len(queries):
            continue
        asyncio.run(drive_batched(base, queries[:batch], batch, args.k,
                                  binary=True))  # warmup
        out = {"exp": f"binary_client_batched_b{batch}",
               **asyncio.run(drive_batched(base, queries, batch, args.k,
                                           binary=True))}
        out["vs_sequential"] = round(out["qps"] / max(seq_qps, 1e-9), 2)
        out["recall_at_k"] = asyncio.run(
            recall_probe(base, queries[:64], gt64, args.k, binary=True))
        print(json.dumps(out), flush=True)

    # ---- int8 two-stage over HTTP (the serving-default mode) ----
    t0 = time.perf_counter()
    r = httpx.post(f"{base}/collections/load/index",
                   json={"kind": "int8", "params": {}}, timeout=3600)
    r.raise_for_status()
    qs = col._quantized
    print(json.dumps({"exp": "int8_build",
                      "s": round(time.perf_counter() - t0, 1),
                      # the serving path uses the TUNED candidate depth;
                      # a large tuned rerank multiplies the (B, c, D)
                      # rerank gather bytes vs the kernel bench's rr=4
                      "default_rerank": getattr(qs, "default_rerank", None),
                      "kind": getattr(qs, "kind", None)}), flush=True)
    for batch in (256, 1024):
        if batch > len(queries):
            continue
        asyncio.run(drive_batched(base, queries[:batch], batch, args.k,
                                  binary=True, mode="quantized"))  # warmup
        out = {"exp": f"binary_int8_batched_b{batch}",
               **asyncio.run(drive_batched(base, queries, batch, args.k,
                                           binary=True, mode="quantized"))}
        out["vs_sequential"] = round(out["qps"] / max(seq_qps, 1e-9), 2)
        out["recall_at_k"] = asyncio.run(recall_probe(
            base, queries[:64], gt64, args.k, binary=True,
            mode="quantized"))
        print(json.dumps(out), flush=True)

    # quantized singles coalesce through the batcher (their own
    # bucket); measure them like the exact singles
    for conc in (64, 256):
        out = {"exp": f"binary_int8_singles_c{conc}",
               **asyncio.run(drive_concurrent(
                   base, queries, conc, args.k, binary=True,
                   mode="quantized"))}
        out["vs_sequential"] = round(out["qps"] / max(seq_qps, 1e-9), 2)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
