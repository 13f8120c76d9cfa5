"""Benchmark CLI for the vector engine.

Parity with the reference's benchmark suites (examples/benchmark.py:
presets 10k-2M, category selection --only/--skip, JSON export, --compare
diffing, latency percentiles with reservoir sampling;
examples/benchmark_quantization.py: recall@k vs brute-force ground truth).

Usage:
  python benchmarks/benchmark.py --preset small --only search,quantized
  python benchmarks/benchmark.py --preset medium --export out.json
  python benchmarks/benchmark.py --compare before.json after.json
"""

from __future__ import annotations

import argparse
import json
import platform as _platform
import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

PRESETS = {
    "tiny": {"n": 2_000, "d": 64, "queries": 64, "batch": 32},
    "small": {"n": 10_000, "d": 384, "queries": 128, "batch": 32},
    "medium": {"n": 100_000, "d": 384, "queries": 256, "batch": 64},
    "large": {"n": 1_000_000, "d": 768, "queries": 256, "batch": 256},
    "xl": {"n": 2_000_000, "d": 768, "queries": 256, "batch": 256},
}

CATEGORIES = ["insert", "search", "filtered", "quantized", "ann", "memory"]


class LatencySampler:
    """Reservoir sampler for latency percentiles (reference:
    examples/benchmark.py:191-225)."""

    def __init__(self, capacity: int = 10_000, seed: int = 0):
        self.capacity = capacity
        self.samples = []
        self.count = 0
        self._rng = random.Random(seed)

    def add(self, value: float) -> None:
        self.count += 1
        if len(self.samples) < self.capacity:
            self.samples.append(value)
        else:
            j = self._rng.randrange(self.count)
            if j < self.capacity:
                self.samples[j] = value

    def percentiles(self) -> dict:
        if not self.samples:
            return {}
        arr = np.asarray(self.samples)
        return {"p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p95_ms": float(np.percentile(arr, 95) * 1e3),
                "p99_ms": float(np.percentile(arr, 99) * 1e3),
                "mean_ms": float(arr.mean() * 1e3)}


def recall_at_k(approx_rows, exact_rows, k: int) -> float:
    return float(np.mean([
        len(set(a[:k].tolist()) & set(e[:k].tolist())) / k
        for a, e in zip(approx_rows, exact_rows)]))


def make_data(n: int, d: int, queries: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((64, d)).astype(np.float32)
    v = (centers[rng.integers(0, 64, n)] +
         0.5 * rng.standard_normal((n, d)).astype(np.float32))
    q = (centers[rng.integers(0, 64, queries)] +
         0.5 * rng.standard_normal((queries, d)).astype(np.float32))
    return v, q


def run(preset: str, only=None, skip=None, seed: int = 0) -> dict:
    import jax
    from fastpyvectordb_jax import Collection, CollectionConfig, Filter

    cfg = PRESETS[preset]
    n, d, nq, batch = cfg["n"], cfg["d"], cfg["queries"], cfg["batch"]
    cats = [c for c in CATEGORIES if (not only or c in only)
            and (not skip or c not in skip)]
    v, q = make_data(n, d, nq, seed)
    results: dict = {
        "preset": preset, "config": cfg, "categories": cats,
        "system": {
            "platform": _platform.platform(),
            "python": _platform.python_version(),
            "jax_backend": jax.devices()[0].platform,
            "devices": len(jax.devices()),
        },
        "timestamp": time.time(),
        "benchmarks": {},
    }
    out = results["benchmarks"]

    col = Collection(CollectionConfig(
        name="bench", dimensions=d, metric="cosine",
        compute_dtype="bfloat16" if jax.devices()[0].platform == "gpu"
        else "float32"))

    # ---- insert ---------------------------------------------------------
    t0 = time.perf_counter()
    ids = [f"v{i}" for i in range(n)]
    metas = [{"cat": i % 10, "score": float(i % 100)} for i in range(n)]
    chunk = 100_000
    for s in range(0, n, chunk):
        col.insert_batch(v[s:s + chunk], ids[s:s + chunk], metas[s:s + chunk])
    dt = time.perf_counter() - t0
    if "insert" in cats:
        out["insert"] = {"bulk_vec_per_s": n / dt, "seconds": dt}

    # ---- search ---------------------------------------------------------
    if "search" in cats:
        col.search(q[0], k=10)  # warm compile
        lat = LatencySampler()
        t0 = time.perf_counter()
        for i in range(min(nq, 64)):
            t1 = time.perf_counter()
            col.search(q[i % nq], k=10)
            lat.add(time.perf_counter() - t1)
        single_qps = min(nq, 64) / (time.perf_counter() - t0)

        col.search_batch(q[:batch], k=10)  # warm
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            col.search_batch(q[:batch], k=10)
        batch_qps = iters * batch / (time.perf_counter() - t0)
        out["search"] = {"single_qps": single_qps, "batch_qps": batch_qps,
                         **lat.percentiles()}

    # ---- filtered -------------------------------------------------------
    if "filtered" in cats:
        f = Filter.and_([Filter.eq("cat", 3), Filter.gt("score", 50)])
        col.search_batch(q[:batch], k=10, filter=f)  # warm + mask build
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            col.search_batch(q[:batch], k=10, filter=f)
        out["filtered"] = {
            "batch_qps": iters * batch / (time.perf_counter() - t0),
            "selectivity": 0.05}

    # ---- quantized ------------------------------------------------------
    if "quantized" in cats:
        exact = [[h.id for h in hits]
                 for hits in col.search_batch(q[:32], k=10)]
        qres = {}
        kinds = ["int8", "binary"]
        if d % 8 == 0 and n <= 200_000:
            kinds.append("pq")  # ADC gather path; cheap only at small-mid N
        for kind in kinds:
            col.enable_quantized_scan(kind)
            col.search_quantized(q[:batch], k=10, rerank=4)  # warm
            iters = 5
            t0 = time.perf_counter()
            for _ in range(iters):
                col.search_quantized(q[:batch], k=10, rerank=4)
            qps = iters * batch / (time.perf_counter() - t0)
            approx = [[h.id for h in hits]
                      for hits in col.search_quantized(q[:32], k=10,
                                                       rerank=4)]
            rec = float(np.mean([
                len(set(a) & set(e)) / 10 for a, e in zip(approx, exact)]))
            mem = col._quantized.memory_usage()
            qres[kind] = {"batch_qps": qps, "recall_at_10": rec,
                          "compression": mem["compression_ratio"]}
        out["quantized"] = qres

    # ---- ann (IVF) ------------------------------------------------------
    if "ann" in cats:
        t0 = time.perf_counter()
        col.build_ann(iters=8)
        build_s = time.perf_counter() - t0
        exact = [[h.id for h in hits]
                 for hits in col.search_batch(q[:32], k=10, exact=True)]
        col.search_batch(q[:16], k=10, exact=False)  # warm
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            col.search_batch(q[:16], k=10, exact=False)
        qps = iters * 16 / (time.perf_counter() - t0)
        approx = [[h.id for h in hits]
                  for hits in col.search_batch(q[:32], k=10, exact=False)]
        rec = float(np.mean([len(set(a) & set(e)) / 10
                             for a, e in zip(approx, exact)]))
        out["ann"] = {"build_seconds": build_s, "qps": qps,
                      "recall_at_10": rec, **col._ann.stats()}

    # ---- memory ---------------------------------------------------------
    if "memory" in cats:
        st = col.stats()
        out["memory"] = {"device_bytes": st["device_bytes"],
                         "bytes_per_vector": st["device_bytes"] / max(n, 1)}

    return results


def compare(a_path: str, b_path: str) -> None:
    a = json.loads(Path(a_path).read_text())
    b = json.loads(Path(b_path).read_text())

    def walk(pa, pb, prefix=""):
        for key in pa:
            if key not in pb:
                continue
            va, vb = pa[key], pb[key]
            if isinstance(va, dict) and isinstance(vb, dict):
                walk(va, vb, f"{prefix}{key}.")
            elif isinstance(va, (int, float)) and isinstance(vb, (int, float)) \
                    and va:
                delta = (vb - va) / abs(va) * 100
                marker = "+" if delta >= 0 else ""
                print(f"  {prefix}{key}: {va:.4g} -> {vb:.4g} "
                      f"({marker}{delta:.1f}%)")

    print(f"compare {a_path} -> {b_path}")
    walk(a.get("benchmarks", {}), b.get("benchmarks", {}))


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", choices=PRESETS, default="small")
    p.add_argument("--only", help="comma-separated categories")
    p.add_argument("--skip", help="comma-separated categories")
    p.add_argument("--export", help="write results JSON to this path")
    p.add_argument("--compare", nargs=2, metavar=("BEFORE", "AFTER"))
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    if args.compare:
        compare(*args.compare)
        return

    only = args.only.split(",") if args.only else None
    skip = args.skip.split(",") if args.skip else None
    results = run(args.preset, only, skip, args.seed)
    print(json.dumps(results, indent=2, default=str))
    if args.export:
        Path(args.export).write_text(json.dumps(results, default=str))
        print(f"\nexported to {args.export}", file=sys.stderr)


if __name__ == "__main__":
    main()
