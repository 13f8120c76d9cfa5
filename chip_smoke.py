#!/usr/bin/env python3
"""Smoke run of the vector store's main path on a GPU, at deployment size.

Drives the library path a user calls — VectorDB -> create_collection ->
insert_batch -> search_arrays, filtered search, search_quantized,
build_ann + search, upsert / delete, save and reopen — over a 1M x 768
cosine corpus shaped like VectorDBBench's 768-dimension 1M performance
case (Cohere 1M), generated from a seed (benchmarks/_data.py).  Two
collections hold it: the default config (float32 storage and compute,
exact top-k) and the serving config (bfloat16 storage and compute).

Every phase prints one JSON line and checks its answers against a float64
NumPy brute force over the same rows and filter, on a sample of queries.
The ``kernels`` phase times XLA's version of each scan on the card, with
its roofline share (benchmarks/peaks.py); ``gpu_tests`` runs the suite's
card-only tests (``pytest -m gpu``) inside this process, so only one
process ever holds the card.

    python chip_smoke.py            # one card: every phase
    python chip_smoke.py --four     # four cards: the sharded path only

On success the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU the run stops in the ``device`` phase and exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DATA_DIR = ROOT / "chip_smoke_data"   # listed in .gitignore
K = 10


@dataclasses.dataclass(frozen=True)
class Size:
    """Scale of one run.  Widths are the source's (768-d cosine); only the
    row count and the batch shrink for rehearsals on the CPU."""
    n: int = 1_000_000
    d: int = 768
    batch: int = 1024
    n_check: int = 64          # queries checked against the f64 reference
    insert_chunk: int = 131_072
    nlist: int = 2048
    nprobe: int = 8
    n_writes: int = 300
    reps: int = 5
    kernel_batches: tuple = (1024, 8)
    pq_m: int = 96             # IVF-PQ default geometry: M = D/8, K = 256
    pq_k: int = 256
    seed: int = 0


FULL = Size()
# four cards: 1M rows per card; nlist 2048 (~sqrt(4M)) keeps the index
# build a quarter of what 8192 lists would cost
FOUR = dataclasses.replace(FULL, n=4_000_000)

# Stated tolerances against the float64 reference (tie_eps: f64 distance
# slack within which a swapped neighbour counts as an exact tie).
TOL = {
    # float32 rounding over 768 terms; TF32 would show ~1e-3
    "float32": {"recall": 0.999, "dist_err": 1e-4, "tie_eps": 1e-6},
    # bf16 keeps 8 mantissa bits on both operands of a 768-term sum
    "bfloat16": {"recall": 0.95, "dist_err": 2e-2, "tie_eps": 0.0},
    "int8": {"recall": 0.95, "dist_err": 2e-2, "tie_eps": 0.0},
    "ivf": {"recall": 0.90, "dist_err": 2e-2, "tie_eps": 0.0},
}


class PhaseFailed(RuntimeError):
    pass


T0 = time.perf_counter()


def emit(phase: str, **fields) -> dict:
    row = {"phase": phase, **fields,
           "elapsed_s": round(time.perf_counter() - T0, 3)}
    print(json.dumps(row, default=_json_default), flush=True)
    return row


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(type(o))


def require(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def nvidia_smi() -> list:
    """Name and power limit of each card, read by nvidia-smi (a child
    process that does not touch JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def timed(fn, reps: int) -> float:
    """Median wall-clock seconds of ``fn()`` after one warm-up call; every
    call waits for its results with block_until_ready."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


# --------------------------------------------------------------------------
# the plain reference: float64 brute force on the host
# --------------------------------------------------------------------------

class Reference:
    """Cosine top-k in float64 over the same rows, chunked over the
    corpus so the float64 copy never exists whole."""

    def __init__(self, x: np.ndarray, chunk: int = 131_072):
        self.x = x
        self.chunk = chunk
        self._memo = {}
        self.inv = np.empty(x.shape[0], np.float64)
        for s in range(0, x.shape[0], chunk):
            xc = x[s:s + chunk].astype(np.float64)
            self.inv[s:s + chunk] = 1.0 / np.maximum(
                np.linalg.norm(xc, axis=1), 1e-300)

    def _qn(self, q: np.ndarray) -> np.ndarray:
        q = q.astype(np.float64)
        return q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True),
                              1e-300)

    def topk(self, q: np.ndarray, k: int, mask: np.ndarray = None):
        key = (q.tobytes(), k, None if mask is None else mask.tobytes())
        if key not in self._memo:
            self._memo[key] = self._topk(q, k, mask)
        return self._memo[key]

    def _topk(self, q: np.ndarray, k: int, mask: np.ndarray = None):
        qn = self._qn(q)
        best_d = np.full((q.shape[0], 0), np.inf)
        best_r = np.zeros((q.shape[0], 0), np.int64)
        for s in range(0, self.x.shape[0], self.chunk):
            xc = self.x[s:s + self.chunk].astype(np.float64)
            dist = 1.0 - (qn @ xc.T) * self.inv[s:s + self.chunk][None, :]
            if mask is not None:
                dist = np.where(mask[s:s + self.chunk][None, :], dist,
                                np.inf)
            rows = np.arange(s, s + xc.shape[0])[None, :].repeat(
                q.shape[0], 0)
            cd = np.concatenate([best_d, dist], axis=1)
            cr = np.concatenate([best_r, rows], axis=1)
            part = np.argpartition(cd, min(k, cd.shape[1] - 1), axis=1)[:, :k]
            best_d = np.take_along_axis(cd, part, axis=1)
            best_r = np.take_along_axis(cr, part, axis=1)
        order = np.argsort(best_d, axis=1, kind="stable")
        return (np.take_along_axis(best_d, order, axis=1),
                np.take_along_axis(best_r, order, axis=1))

    def dist(self, q: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """f64 cosine distance of each query to each of its rows."""
        qn = self._qn(q)
        xr = self.x[rows].astype(np.float64)             # (B, k, D)
        return 1.0 - np.einsum("bd,bkd->bk", qn, xr) * self.inv[rows]


def rows_of(ids: np.ndarray) -> np.ndarray:
    """String ids "v<row>" back to corpus rows (-1 for a missing hit)."""
    out = np.full(ids.shape, -1, np.int64)
    for i, row in enumerate(ids):
        for j, s in enumerate(row):
            if s is not None:
                out[i, j] = int(str(s)[1:])
    return out


def compare(ref: Reference, q: np.ndarray, ids, dists, tol: dict,
            mask: np.ndarray = None, what: str = "") -> dict:
    """Recall@k and the largest distance error of a result against the
    float64 reference; fails the phase outside ``tol`` with an error that
    names ``what`` was compared."""
    rows = rows_of(np.asarray(ids))
    require((rows >= 0).all(), f"{what}: a query returned fewer than k hits")
    ref_d, ref_r = ref.topk(q, K, mask)
    sys_true = ref.dist(q, rows)
    kth = ref_d[:, K - 1:K]
    plain = float(np.mean([len(set(a) & set(b)) / K
                           for a, b in zip(rows.tolist(), ref_r.tolist())]))
    tie_ok = np.array([[r in set(rr) for r in row]
                       for row, rr in zip(rows.tolist(), ref_r.tolist())])
    tie_ok |= sys_true <= kth + tol["tie_eps"]
    recall = float(tie_ok.mean())
    err = float(np.max(np.abs(np.asarray(dists, np.float64) - sys_true)))
    out = {"recall_at_10": recall, "recall_at_10_plain": plain,
           "max_dist_err": err, "tol": tol}
    require(recall >= tol["recall"],
            f"{what}: recall@10 {recall} below {tol['recall']}")
    require(err <= tol["dist_err"],
            f"{what}: distance error {err} above {tol['dist_err']}")
    if mask is not None:
        require(bool(mask[rows].all()), f"{what}: a hit fails the filter")
    return out


# --------------------------------------------------------------------------
# phases of the one-card run
# --------------------------------------------------------------------------

def phase_device(require_gpu: bool = True, n_devices: int = 1) -> dict:
    import jax
    import jaxlib
    from fastpyvectordb_jax import compile_cache
    devs = jax.devices()
    platform = devs[0].platform
    if require_gpu and platform != "gpu":
        emit("device", ok=False, platform=platform,
             reason="no GPU: JAX found only the "
                    f"{platform!r} platform; this script measures the card")
        raise SystemExit(2)
    if len(devs) < n_devices:
        emit("device", ok=False, count=len(devs),
             reason=f"needs {n_devices} devices")
        raise SystemExit(2)
    card = nvidia_smi() if require_gpu else ["not measured (no GPU)"]
    kind = devs[0].device_kind
    if require_gpu:
        from benchmarks.peaks import peaks
        peaks(kind)  # an unknown card fails here, not after the run
    info = {"platform": platform, "kind": kind, "count": len(devs)}
    emit("device", ok=True, **info, jax=jax.__version__,
         jaxlib=jaxlib.__version__, xla_flags=os.environ.get("XLA_FLAGS", ""),
         compile_cache=jax.config.jax_compilation_cache_dir
         or compile_cache.cache_dir(), card=card)
    for line in card:
        print(line, flush=True)   # nvidia-smi's own line, verbatim
    return {**info, "card": card[0]}


def phase_data(size: Size) -> dict:
    from benchmarks._data import clustered_corpus, clustered_queries
    t0 = time.perf_counter()
    x, centers = clustered_corpus(size.n, size.d, seed=size.seed)
    q = clustered_queries(centers, size.batch, seed=size.seed + 1)
    bucket = np.random.default_rng(size.seed + 2).integers(
        0, 100, size.n).astype(np.int64)
    ref = Reference(x)
    emit("data", n=size.n, d=size.d, batch=size.batch,
         source="benchmarks/_data.py clustered_corpus (1024 centres)",
         setup_s=time.perf_counter() - t0)
    return {"x": x, "q": q, "centers": centers, "bucket": bucket,
            "ref": ref}


def phase_load(size: Size, data: dict, dev: dict, data_dir: Path) -> dict:
    from fastpyvectordb_jax import VectorDB
    shutil.rmtree(data_dir, ignore_errors=True)
    db = VectorDB(str(data_dir))
    cols = {
        "default": db.create_collection("default", size.d, "cosine"),
        "serving": db.create_collection(
            "serving", size.d, "cosine", compute_dtype="bfloat16",
            storage_dtype="bfloat16"),
    }
    x, bucket = data["x"], data["bucket"]
    ids = [f"v{i}" for i in range(size.n)]
    metas = [{"bucket": int(b)} for b in bucket]
    import jax
    for name, col in cols.items():
        t0 = time.perf_counter()
        for s in range(0, size.n, size.insert_chunk):
            e = min(s + size.insert_chunk, size.n)
            col.insert_batch(x[s:e], ids[s:e], metas[s:e])
        jax.block_until_ready(col._store.vectors)
        dt = time.perf_counter() - t0
        require(col.count() == size.n, f"{name} holds {col.count()} rows")
        emit("load", collection=name, rows=size.n, seconds=dt,
             rows_per_s=size.n / dt, card=dev["card"])
    return {"db": db, "cols": cols, "dir": data_dir}


def _dtype_of(name: str) -> str:
    return "float32" if name == "default" else "bfloat16"


def phase_exact(size: Size, data: dict, st: dict, dev: dict) -> None:
    q, ref, nc = data["q"], data["ref"], size.n_check
    for name, col in st["cols"].items():
        tol = TOL[_dtype_of(name)]
        ids, dists, _ = col.search_arrays(q, K, exact=True)
        chk = compare(ref, q[:nc], ids[:nc], dists[:nc], tol,
                      what=f"exact {name}")
        t_b = timed(lambda: col.search_arrays(q, K, exact=True), size.reps)
        one = [col.search_arrays(q[i:i + 1], K, exact=True)[:2]
               for i in range(nc)]          # B=1, one query at a time
        chk1 = compare(ref, q[:nc], np.concatenate([o[0] for o in one]),
                       np.concatenate([o[1] for o in one]), tol,
                       what=f"exact {name} B=1")
        t_1 = timed(lambda: col.search_arrays(q[:1], K, exact=True),
                    size.reps)
        emit("exact", collection=name, batch=size.batch,
             qps=size.batch / t_b, ms_per_batch=1e3 * t_b, ms_b1=1e3 * t_1,
             **chk, b1_recall_at_10=chk1["recall_at_10"],
             b1_max_dist_err=chk1["max_dist_err"], card=dev["card"])


def phase_filtered(size: Size, data: dict, st: dict, dev: dict) -> None:
    from fastpyvectordb_jax import Filter
    q, ref, bucket, nc = data["q"], data["ref"], data["bucket"], size.n_check
    cases = {"eq_bucket_7": (Filter.eq("bucket", 7), bucket == 7),
             "lt_bucket_50": (Filter.lt("bucket", 50), bucket < 50)}
    for name, col in st["cols"].items():
        tol = TOL[_dtype_of(name)]
        for fname, (flt, mask) in cases.items():
            ids, dists, _ = col.search_arrays(q, K, filter=flt, exact=True)
            chk = compare(ref, q[:nc], ids[:nc], dists[:nc], tol, mask=mask,
                          what=f"filtered {name} {fname}")
            rows = rows_of(ids)
            require(bool(mask[rows[rows >= 0]].all()),
                    "a hit fails the filter")
            t_b = timed(lambda: col.search_arrays(q, K, filter=flt,
                                                  exact=True), size.reps)
            emit("filtered", collection=name, filter=fname,
                 selectivity=float(mask.mean()), batch=size.batch,
                 qps=size.batch / t_b, ms_per_batch=1e3 * t_b, **chk,
                 card=dev["card"])


def phase_int8(size: Size, data: dict, st: dict, dev: dict) -> None:
    q, ref, nc = data["q"], data["ref"], size.n_check
    col = st["cols"]["serving"]
    t0 = time.perf_counter()
    col.enable_quantized_scan("int8", tune=False)
    build = time.perf_counter() - t0
    ids, dists, _ = col.search_quantized_arrays(q, K, rerank=4)
    chk = compare(ref, q[:nc], ids[:nc], dists[:nc], TOL["int8"],
                  what="int8")
    t_b = timed(lambda: col.search_quantized_arrays(q, K, rerank=4),
                size.reps)
    emit("int8", collection="serving", rerank=4, build_s=build,
         batch=size.batch, qps=size.batch / t_b, ms_per_batch=1e3 * t_b,
         **chk, card=dev["card"])


def phase_ivf(size: Size, data: dict, st: dict, dev: dict) -> None:
    q, ref, nc = data["q"], data["ref"], size.n_check
    col = st["cols"]["serving"]
    t0 = time.perf_counter()
    col.build_ann(kind="ivf", cell_dtype="int8", nlist=size.nlist,
                  nprobe=size.nprobe, tune=False)
    build = time.perf_counter() - t0
    require(size.batch * size.nprobe >= size.nlist,
            "the batch does not take the grouped dispatch")
    ids, dists, _ = col.search_arrays(q, K, exact=False)
    chk = compare(ref, q[:nc], ids[:nc], dists[:nc], TOL["ivf"],
                  what="ivf")
    t_b = timed(lambda: col.search_arrays(q, K, exact=False), size.reps)
    emit("ivf", collection="serving", nlist=size.nlist, nprobe=size.nprobe,
         cell_dtype="int8", rerank=int(col._ann.rerank), build_s=build,
         dispatch="grouped", dropped_pairs=int(col._ann.last_dropped),
         batch=size.batch, qps=size.batch / t_b, ms_per_batch=1e3 * t_b,
         **chk, card=dev["card"])


def _snapshot(cols: dict, q: np.ndarray) -> dict:
    out = {}
    for name, col in cols.items():
        out[name, "exact"] = col.search_arrays(q, K, exact=True)[:2]
    serving = cols["serving"]
    out["serving", "int8"] = serving.search_quantized_arrays(
        q, K, rerank=4)[:2]
    out["serving", "ivf"] = serving.search_arrays(q, K, exact=False)[:2]
    return out


def phase_writes(size: Size, data: dict, st: dict, dev: dict) -> None:
    from fastpyvectordb_jax import VectorDB
    rng = np.random.default_rng(size.seed + 3)
    x, d = data["x"], size.d
    picked = rng.choice(size.n, 2 * size.n_writes, replace=False)
    up_rows, del_rows = picked[:size.n_writes], picked[size.n_writes:]
    fresh = rng.standard_normal((2 * size.n_writes, d)).astype(np.float32)
    fresh /= np.linalg.norm(fresh, axis=1, keepdims=True)
    up_vecs, new_vecs = fresh[:size.n_writes], fresh[size.n_writes:]
    new_ids = [f"n{i}" for i in range(size.n_writes)]
    cols = st["cols"]
    t0 = time.perf_counter()
    for col in cols.values():
        for r, v in zip(up_rows, up_vecs):
            col.upsert(v, f"v{r}", {"bucket": 1000})
        col.insert_batch(new_vecs, new_ids,
                         [{"bucket": 1001}] * size.n_writes)
        col.delete_batch([f"v{r}" for r in del_rows])
    write_s = time.perf_counter() - t0
    serving = cols["serving"]
    paths = {
        "default_exact": lambda q: cols["default"].search_arrays(
            q, K, exact=True),
        "serving_exact": lambda q: serving.search_arrays(q, K, exact=True),
        "serving_int8": lambda q: serving.search_quantized_arrays(
            q, K, rerank=4),
        "serving_ivf": lambda q: serving.search_arrays(q, K, exact=False),
    }
    deleted = {f"v{r}" for r in del_rows}
    for pname, run in paths.items():
        ids_up = run(up_vecs)[0]
        require(all(row[0] == f"v{r}" for row, r in zip(ids_up, up_rows)),
                f"{pname}: an upserted vector is not its own top hit")
        ids_new = run(new_vecs)[0]
        require(all(row[0] == i for row, i in zip(ids_new, new_ids)),
                f"{pname}: an inserted vector is not its own top hit")
        ids_del = run(x[del_rows])[0]
        require(not deleted & {s for row in ids_del for s in row},
                f"{pname}: a deleted id is still returned")
    for col in cols.values():   # +inserts -deletes; upserts keep the count
        require(col.count() == size.n, "row count after writes")
    # persistence: save, reopen in a new VectorDB, identical answers
    qs = data["q"][:size.n_check]
    before = _snapshot(cols, qs)
    t0 = time.perf_counter()
    st["db"].save()
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    db2 = VectorDB(str(st["dir"]))
    cols2 = {name: db2.get_collection(name) for name in cols}
    load_s = time.perf_counter() - t0
    after = _snapshot(cols2, qs)
    for key in before:
        (ib, db_), (ia, da) = before[key], after[key]
        require(np.array_equal(ib, ia) and np.array_equal(db_, da),
                f"{key}: results differ after save and reopen")
    emit("writes", upserts=size.n_writes, inserts=size.n_writes,
         deletes=size.n_writes, write_s=write_s, save_s=save_s,
         reopen_s=load_s, paths_checked=sorted(paths),
         identical_after_reopen=[f"{a}_{b}" for a, b in before],
         card=dev["card"])
    del cols2, db2
    gc.collect()


def phase_memory(dev: dict) -> dict:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    row = {k: stats.get(k, "not measured")
           for k in ("peak_bytes_in_use", "bytes_in_use", "bytes_limit")}
    return emit("memory", **row, card=dev["card"])


# ---- kernels: XLA's version of every scan that had a hand-written kernel ----

def _hlo_summary(compiled_text: str) -> dict:
    """What an XLA program lowered to: its custom-call targets, fusion
    backends, and whether it sorts."""
    calls = sorted(set(re.findall(r'custom_call_target="([^"]+)"',
                                  compiled_text)))
    kinds = sorted(set(re.findall(r'"kind":"(__[a-z_]+)"', compiled_text)))
    return {"custom_calls": calls, "fusion_kinds": kinds,
            "sorts": bool(re.search(r"\bsort\(", compiled_text))}


def int_gemm_lines(compiled_text: str) -> list:
    """Instructions of an optimized HLO module that multiply two s8
    operands into an s32 result: a dot (alone or inside a GEMM fusion) or
    a GEMM library call."""
    name = r"%?([\w.\-]+)"
    types = {}
    for m in re.finditer(name + r": (\w+\[)", compiled_text):   # params
        types[m.group(1)] = m.group(2)
    for m in re.finditer(r"^\s*(?:ROOT )?" + name + r" = \(?(\w+\[)",
                         compiled_text, re.M):
        types[m.group(1)] = m.group(2)
    out = []
    pat = re.compile(r"^\s*(?:ROOT )?" + name + r" = \(?s32\[[^=]*?"
                     r"(?:dot|custom-call)\(" + name + ", " + name + r"\)",
                     re.M)
    for m in pat.finditer(compiled_text):
        if types.get(m.group(2)) == "s8[" and types.get(m.group(3)) == "s8[":
            out.append(compiled_text[m.start():m.end()].strip()[:240])
    return out


def _kernel_row(dev: dict, name: str, fn, args, reps: int, *,
                flops: float, flops_dtype: str, bytes_moved: float,
                extra: dict = None) -> dict:
    import jax
    from benchmarks.peaks import roofline
    compiled = jax.jit(fn).lower(*args).compile()
    text = compiled.as_text()
    t = timed(lambda: compiled(*args), reps)
    if dev["platform"] == "gpu":
        roof = roofline(dev["kind"], t, flops=flops, flops_dtype=flops_dtype,
                        bytes_moved=bytes_moved)
    else:
        roof = {"roofline_share": "not measured", "flops": flops,
                "bytes": bytes_moved, "flops_dtype": flops_dtype}
    return emit("kernels", kernel=name, ms=1e3 * t, **roof,
                lowered=_hlo_summary(text), **(extra or {}),
                card=dev["card"])


def phase_kernels(size: Size, data: dict, st: dict, dev: dict) -> list:
    import functools

    import jax
    import jax.numpy as jnp

    from fastpyvectordb_jax.ann.ivf_grouped import (
        grouped_cell_candidates, grouped_qcap, route_scores)
    from fastpyvectordb_jax.ann.ivfpq import _grouped_pq_candidates
    from fastpyvectordb_jax.core.types import DistanceMetric
    from fastpyvectordb_jax.quant import int4, scalar
    from fastpyvectordb_jax.quant.binary import BinaryQuantizer, _hamming
    from fastpyvectordb_jax.quant.int4 import Int4Quantizer

    cos = DistanceMetric.COSINE
    serving = st["cols"]["serving"]
    store = serving._store
    n, d = store.vectors.shape              # capacity rows (pow2)
    scan = serving._quantized
    codes8 = jnp.asarray(scan.codes)
    vsq8, rinv8 = scan.quantizer.corpus_stats(codes8)
    qz4 = Int4Quantizer().train(jnp.asarray(data["x"][:262_144]))
    codes4 = qz4.encode(store.vectors)
    vsq4, rinv4 = qz4.corpus_stats(codes4)
    bq = BinaryQuantizer().train(data["x"][:262_144])
    codes1 = bq.encode(store.vectors)
    rows = []
    reps = size.reps
    for b in size.kernel_batches:
        qf = jnp.asarray(np.resize(data["q"], (b, d)))
        out_bytes = 4.0 * b * n
        mm8 = functools.partial(scalar._distances_int8_matmul, metric=cos)
        row = _kernel_row(
            dev, f"int8mm_b{b}", mm8,
            (qf, codes8, scan.quantizer.vmin, scan.quantizer.scale, vsq8,
             rinv8), reps, flops=2.0 * b * n * d, flops_dtype="int8",
            bytes_moved=n * d + out_bytes)
        text = jax.jit(mm8).lower(
            qf, codes8, scan.quantizer.vmin, scan.quantizer.scale, vsq8,
            rinv8).compile().as_text()
        row["int_gemm"] = int_gemm_lines(text)
        emit("kernels", kernel=f"int8mm_b{b}_lowering",
             int_gemm=bool(row["int_gemm"]), lines=row["int_gemm"][:4])
        rows.append(row)
        rows.append(_kernel_row(
            dev, f"int8_chunked_b{b}",
            functools.partial(scalar._distances, metric=cos),
            (qf, codes8, scan.quantizer.vmin, scan.quantizer.scale), reps,
            flops=2.0 * b * n * d, flops_dtype="float32",
            bytes_moved=n * d + out_bytes))
        rows.append(_kernel_row(
            dev, f"int4mm_b{b}",
            functools.partial(int4._distances_int4_matmul, metric=cos),
            (qf, codes4, qz4.vmin, qz4.scale, vsq4, rinv4), reps,
            flops=2.0 * b * n * d, flops_dtype="int8",
            bytes_moved=n * d / 2 + out_bytes))
        rows.append(_kernel_row(
            dev, f"int4_chunked_b{b}",
            functools.partial(int4._distances, metric=cos),
            (qf, codes4, qz4.vmin, qz4.scale), reps,
            flops=2.0 * b * n * d, flops_dtype="float32",
            bytes_moved=n * d / 2 + out_bytes))
        qcodes = bq.encode(np.asarray(qf))
        rows.append(_kernel_row(
            dev, f"hamming_b{b}", _hamming, (qcodes, codes1), reps,
            flops=0.0, flops_dtype="int8",
            bytes_moved=4.0 * n * codes1.shape[1] + out_bytes))
        rows += _grouped_rows(dev, size, st, qf, b, reps, route_scores,
                              grouped_cell_candidates, grouped_qcap,
                              _grouped_pq_candidates)
    rows += _selection_rows(dev, size, n, reps)
    rows += _reference_rows(dev, reps)
    return rows


def _grouped_rows(dev, size, st, qf, b, reps, route_scores,
                  grouped_cell_candidates, grouped_qcap,
                  _grouped_pq_candidates) -> list:
    """The grouped (cell-major) IVF scorers at the index's own shapes:
    bf16 cells, int8 cells and IVF-PQ (K=256) codes."""
    import functools

    import jax
    import jax.numpy as jnp

    from fastpyvectordb_jax.core.types import DistanceMetric
    cos = DistanceMetric.COSINE
    idx = st["cols"]["serving"]._ann
    nlist, cmax, d = idx.cells.shape
    nprobe = size.nprobe
    qcap = grouped_qcap(b, nprobe, nlist, cmax)
    okc, _ = idx._ok_cached()
    norms = idx._cell_norms_cached()
    croute = route_scores(qf, idx.centroids, cos)
    u = min(nlist, b * nprobe)
    rows = []
    cells_bf = idx.cells.astype(jnp.bfloat16)
    for tag, cells, cd, fdt, cb in (
            ("bf16", cells_bf, "bfloat16", "bfloat16", 2),
            ("int8", idx.cells, "bfloat16", "int8", 1)):
        fn = functools.partial(grouped_cell_candidates, metric=cos,
                               nprobe=nprobe, qcap=qcap, compute_dtype=cd)
        rows.append(_kernel_row(
            dev, f"grouped_{tag}_b{b}", fn,
            (qf, croute, cells, idx.row_table, okc, idx.quantizer.vmin,
             idx.quantizer.scale, norms), reps,
            flops=2.0 * nlist * qcap * cmax * d, flops_dtype=fdt,
            bytes_moved=cb * u * cmax * d + 4.0 * nlist * qcap * cmax,
            extra={"nlist": nlist, "cmax": cmax, "qcap": qcap,
                   "nprobe": nprobe}))
    # IVF-PQ at the default geometry (M = D/8 subspaces of K = 256): the
    # shapes drive the time, so the codes and codebooks are random
    rng = np.random.default_rng(size.seed + 4)
    m, kk = size.pq_m, size.pq_k
    codes_t = jnp.asarray(rng.integers(0, kk, (nlist, m, cmax),
                                       dtype=np.uint8))
    codebooks = jnp.asarray(rng.standard_normal((m, kk, d // m),
                                                dtype=np.float32))
    qc = jnp.dot(qf, idx.centroids.T, precision=jax.lax.Precision.HIGHEST)
    _, probe = jax.lax.top_k(qc, nprobe)
    fn = functools.partial(_grouped_pq_candidates, metric=cos, qcap=qcap)
    rows.append(_kernel_row(
        dev, f"grouped_pq_k{kk}_b{b}", fn,
        (qf, qc, probe, codes_t, codebooks, norms, idx.row_table, okc),
        reps, flops=2.0 * u * qcap * m * kk * cmax, flops_dtype="bfloat16",
        bytes_moved=u * m * cmax + 2.0 * u * qcap * m * kk
        + 4.0 * u * qcap * cmax,
        extra={"nlist": nlist, "cmax": cmax, "qcap": qcap, "m": m, "k": kk}))
    return rows


def _selection_rows(dev, size, n, reps) -> list:
    """lax.top_k against lax.approx_max_k on the exact scan's (B, N) f32
    score block, and what each lowered to on this platform."""
    import jax
    import jax.numpy as jnp
    b = size.batch
    s = jax.random.normal(jax.random.PRNGKey(size.seed), (b, n),
                          jnp.float32)
    exact = _kernel_row(dev, f"top_k_b{b}",
                        lambda x: jax.lax.top_k(-x, K), (s,), reps,
                        flops=0.0, flops_dtype="float32",
                        bytes_moved=4.0 * b * n)
    approx = _kernel_row(
        dev, f"approx_max_k_b{b}",
        lambda x: jax.lax.approx_max_k(-x, K, recall_target=0.99), (s,),
        reps, flops=0.0, flops_dtype="float32", bytes_moved=4.0 * b * n)
    _, r_e = jax.lax.top_k(-s, K)
    _, r_a = jax.lax.approx_max_k(-s, K, recall_target=0.99)
    r_e, r_a = np.asarray(r_e), np.asarray(r_a)
    rec = float(np.mean([len(set(a) & set(e)) / K
                         for a, e in zip(r_a.tolist(), r_e.tolist())]))
    emit("kernels", kernel="selection_verdict",
         approx_recall_vs_top_k=rec,
         approx_over_exact_time=approx["ms"] / exact["ms"],
         faster="approx_max_k" if approx["ms"] < exact["ms"] else "top_k")
    del s
    return [exact, approx]


def _reference_rows(dev, reps) -> list:
    """What a large plain bf16 matmul and a large copy reach on this
    card: the practical ceilings beside the published ones."""
    import jax
    import jax.numpy as jnp
    big = 8192 if dev["platform"] == "gpu" else 512
    a = jnp.ones((big, big), jnp.bfloat16)
    mm = _kernel_row(dev, f"ref_bf16_matmul_{big}",
                     lambda x, y: jnp.dot(x, y,
                                          preferred_element_type=jnp.float32),
                     (a, a), reps, flops=2.0 * big ** 3,
                     flops_dtype="bfloat16", bytes_moved=3.0 * 2 * big * big)
    nbytes = (1 << 30) if dev["platform"] == "gpu" else (1 << 22)
    x = jnp.ones((nbytes // 4,), jnp.float32)
    cp = _kernel_row(dev, "ref_copy_1GiB" if nbytes == 1 << 30
                     else "ref_copy", lambda v: v * 2.0, (x,), reps,
                     flops=0.0, flops_dtype="float32",
                     bytes_moved=2.0 * nbytes)
    return [mm, cp]


def phase_gpu_tests(dev: dict) -> None:
    """The suite's card-only tests, in this process (one process per
    card): ``pytest -m gpu tests/test_gpu.py``."""
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", str(ROOT / "tests" / "test_gpu.py")])
    require(rc == 0, f"gpu tests failed (pytest exit {int(rc)})")
    emit("gpu_tests", ok=True, card=dev["card"])


def run_one_card(size: Size, require_gpu: bool = True,
                 gpu_tests: bool = True, data_dir: Path = DATA_DIR) -> dict:
    sys.path.insert(0, str(ROOT))
    from fastpyvectordb_jax import compile_cache
    compile_cache.enable()
    dev = phase_device(require_gpu)
    data = phase_data(size)
    st = phase_load(size, data, dev, data_dir)
    phase_exact(size, data, st, dev)
    phase_filtered(size, data, st, dev)
    phase_int8(size, data, st, dev)
    phase_ivf(size, data, st, dev)
    phase_kernels(size, data, st, dev)
    phase_writes(size, data, st, dev)
    phase_memory(dev)
    st.clear()
    gc.collect()
    shutil.rmtree(data_dir, ignore_errors=True)
    if gpu_tests:
        phase_gpu_tests(dev)
    return dev


# --------------------------------------------------------------------------
# four cards: the sharded path and the single-device result it must match
# --------------------------------------------------------------------------

def _placed_on(arr, n_devices: int) -> None:
    devs = {s.device for s in arr.addressable_shards}
    require(len(devs) == n_devices,
            f"array spans {len(devs)} devices, expected {n_devices}")
    rows = {s.data.shape[0] for s in arr.addressable_shards}
    require(len(rows) == 1 and rows.pop() == arr.shape[0] // n_devices,
            "shards are not equal row blocks")


def _same_up_to_ties(r1, d1, r4, d4, tie: float) -> float:
    """Share of hits that differ between two results; every differing hit
    must be an exact tie (equal score within ``tie``)."""
    r1, r4 = np.asarray(r1), np.asarray(r4)
    d1, d4 = np.asarray(d1, np.float64), np.asarray(d4, np.float64)
    require(np.allclose(d1, d4, atol=tie, rtol=0),
            "sharded scores differ from the single-device scores")
    diff = np.array([len(set(a) ^ set(b)) / (2 * K)
                     for a, b in zip(r1.tolist(), r4.tolist())])
    return float(diff.mean())


def run_four_cards(size: Size, require_gpu: bool = True,
                   n_devices: int = 4) -> dict:
    sys.path.insert(0, str(ROOT))
    import jax
    import jax.numpy as jnp

    from fastpyvectordb_jax import Collection, CollectionConfig
    from fastpyvectordb_jax import compile_cache
    from fastpyvectordb_jax.dist.mesh import make_mesh
    from fastpyvectordb_jax.dist.sharded import (ShardedSearcher,
                                                 build_sharded_kmeans_step)
    from fastpyvectordb_jax.dist.sharded_ann import ShardedInt8, ShardedIVF
    compile_cache.enable()
    dev = phase_device(require_gpu, n_devices)
    dev["count"] = n_devices
    data = phase_data(size)
    q, ref, nc = data["q"], data["ref"], size.n_check
    col = Collection(CollectionConfig(
        name="sharded", dimensions=size.d, metric="cosine",
        compute_dtype="bfloat16", storage_dtype="bfloat16"))
    t0 = time.perf_counter()
    for s in range(0, size.n, size.insert_chunk):
        e = min(s + size.insert_chunk, size.n)
        col.insert_batch(data["x"][s:e], [f"v{i}" for i in range(s, e)])
    emit("load", collection="sharded", rows=size.n,
         seconds=time.perf_counter() - t0, card=dev["card"])
    store = col._store
    mesh1, mesh4 = make_mesh(1), make_mesh(n_devices)

    def as_ids(rows):
        return np.vectorize(lambda r: f"v{r}", otypes=[object])(rows)

    # exact: row-sharded corpus, per-shard top-k, all_gather merge
    res = {}
    for tag, mesh in (("one", mesh1), ("four", mesh4)):
        s = ShardedSearcher(mesh, store.vectors, store.valid,
                            metric="cosine", compute_dtype="bfloat16")
        if tag == "four":
            _placed_on(s.vectors, n_devices)
        d_, r_ = s.search(jnp.asarray(q), K)
        res[tag] = (np.asarray(d_), np.asarray(r_))
        t = timed(lambda: s.search(jnp.asarray(q), K), size.reps)
        res[tag + "_t"] = t
        del s
    differ = _same_up_to_ties(res["one"][1], res["one"][0], res["four"][1],
                              res["four"][0], tie=1e-4)
    chk = compare(ref, q[:nc], as_ids(res["four"][1][:nc]),
                  res["four"][0][:nc], TOL["bfloat16"],
                  what="sharded exact")
    emit("sharded_exact", devices=n_devices, rows=size.n,
         differing_hits=differ, qps_four=size.batch / res["four_t"],
         qps_one=size.batch / res["one_t"], **chk, card=dev["card"])

    # one distributed Lloyd step against the same step on one device
    kc = 256
    cents = jnp.asarray(data["x"][:kc])
    weights = store.valid.astype(jnp.float32)
    out = {}
    for tag, mesh in (("one", mesh1), ("four", mesh4)):
        step = build_sharded_kmeans_step(mesh, k=kc)
        c_, n_ = step(store.vectors, weights, cents)
        out[tag] = (np.asarray(c_), np.asarray(n_))
    err = float(np.max(np.abs(out["one"][0] - out["four"][0])))
    # a row equidistant to two centroids within float32 rounding may land
    # in either; anything beyond a handful of such rows is a fault
    moved = float(np.abs(out["one"][1] - out["four"][1]).sum() / 2)
    require(moved <= 1e-4 * size.n, f"{moved} rows changed centroid")
    require(err <= 1e-4, f"sharded centroids differ by {err}")
    emit("sharded_kmeans", devices=n_devices, k=kc, rows_moved=moved,
         max_centroid_diff=err, tol=1e-4, card=dev["card"])
    # int8 two-stage: row-sharded codes, shard-local re-rank, merge
    # the one-device runs answer only the checked queries: one card cannot
    # hold the (1024, 4M) coarse score block of the whole batch
    scan = col.enable_quantized_scan("int8", tune=False)
    recs = {}
    for tag, mesh in (("one", mesh1), ("four", mesh4)):
        s8 = ShardedInt8.from_scan(mesh, scan)
        d_, r_ = s8.search(q if tag == "four" else q[:nc], K, rerank=4)
        recs[tag] = compare(ref, q[:nc], as_ids(r_[:nc]), d_[:nc],
                            TOL["int8"], what=f"sharded int8 {tag}")
        recs[tag + "_rows"] = r_[:nc]
        if tag == "four":
            _placed_on(s8.codes, n_devices)
            recs["four_t"] = timed(lambda: s8.search(q, K, rerank=4),
                                   size.reps)
        del s8
    # per-shard candidate pools are a superset of the global pool, so the
    # four-card answer may only be closer, never worse
    require(recs["four"]["recall_at_10"] >= recs["one"]["recall_at_10"],
            "sharded int8 recall below the single-device recall")
    emit("sharded_int8", devices=n_devices, rerank=4,
         recall_one=recs["one"]["recall_at_10"], **recs["four"],
         overlap_with_one=float(np.mean(
             [len(set(a) & set(b)) / K for a, b in
              zip(recs["one_rows"].tolist(), recs["four_rows"].tolist())])),
         qps_four=size.batch / recs["four_t"], card=dev["card"])

    # IVF over int8 cells, cell-sharded: per-shard routing and probing
    t0 = time.perf_counter()
    col.build_ann(kind="ivf", cell_dtype="int8", nlist=size.nlist,
                  nprobe=size.nprobe, tune=False)
    build = time.perf_counter() - t0
    s1 = ShardedIVF.from_index(mesh1, col._ann)
    d1, r1 = s1.search(q[:nc], K)
    one = compare(ref, q[:nc], as_ids(r1), d1, TOL["ivf"],
                  what="sharded ivf one")
    del s1
    si = ShardedIVF.from_index(mesh4, col._ann)
    _placed_on(si.cells, n_devices)
    d_, r_ = si.search(q, K)
    four = compare(ref, q[:nc], as_ids(np.asarray(r_)[:nc]),
                   np.asarray(d_)[:nc], TOL["ivf"], what="sharded ivf four")
    t = timed(lambda: si.search(q, K), size.reps)
    emit("sharded_ivf", devices=n_devices, nlist=size.nlist,
         nprobe=size.nprobe, build_s=build,
         overflow_rows=int((np.asarray(col._ann.overflow_rows) >= 0).sum()),
         cmax=int(si.cells.shape[1]),
         nprobe_local_four=si.nprobe_local,
         recall_one=one["recall_at_10"], **four,
         qps_four=size.batch / t, card=dev["card"])

    phase_memory(dev)
    return dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path, on four cards")
    args = ap.parse_args(argv)
    try:
        if args.four:
            dev = run_four_cards(FOUR)
        else:
            dev = run_one_card(FULL)
    except PhaseFailed as e:
        print(json.dumps({"ok": False, "error": str(e)}), flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
