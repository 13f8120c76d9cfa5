"""BigCollection: corpora beyond device memory — host vectors, device codes.

The reference's >10M-row recipe is "memory-mapped store + binary codes +
candidate re-rank" (README.md:571-578; parallel_search.py:427-750 mmap
store, :895-947 search_hybrid).  This is the device-side inversion of the
same idea, sized so the *hot* scan never leaves the device:

  * full-precision vectors live on the HOST (any (N, D) float32 array-like:
    ndarray, np.memmap, np.load(..., mmap_mode="r")) — 20M x 768 f32 is
    57 GB, trivial for host RAM/disk;
  * a compressed snapshot lives on the DEVICE — 1-bit packed codes (32x,
    word-major), int4 packed nibbles (8x, quant/int4.py), or int8 codes
    (4x) — so the coarse scan over ALL rows is one fused device dispatch;
  * search = device coarse scan + top-C -> host gather of C candidate rows
    (a few hundred KB) -> exact f32 re-rank on host BLAS -> top-k.

Compare core/outofcore.py, which streams every byte of the corpus through
the device per search (bandwidth-bound, exact): BigCollection streams only
candidates, trading exactness for a quantized coarse stage that the exact
re-rank repairs (recall measured in benchmarks).

Appends encode incrementally into pre-allocated power-of-two device code
buffers (no rebuild); deletes are validity-mask tombstones; metadata
filters compile to masks fused into the coarse scan, exactly like the core
Collection.

Recall note: 1-bit codes collapse near-duplicate rows onto identical sign
patterns, so the candidate count (k * rerank) must exceed the typical
same-code mass.  If your corpus has huge tight clusters, raise ``rerank``
(or use the int8 codec, which keeps 8 bits/dim of resolution).
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..persist.format import load_container, save_container
from .filters import ColumnView, Filter
from .types import DistanceMetric, SearchResult, as_f32_matrix

MIN_CAP = 4096
STORE_FILE = "bigcollection.fpvt"
VECTORS_FILE = "vectors.npy"


def _next_pow2(n: int) -> int:
    p = MIN_CAP
    while p < n:
        p <<= 1
    return p


class BigCollection:
    """Host-resident vectors + device-resident compressed serving codes."""

    def __init__(self, dims: int, metric: "DistanceMetric | str" = "cosine",
                 codec: str = "binary", name: str = "big",
                 base_path: Optional[Path] = None,
                 train_rows: int = 200_000, rerank: int = 16):
        if codec not in ("binary", "int8", "int4"):
            raise ValueError(
                f"unknown codec {codec!r} (binary | int8 | int4)")
        self.name = name
        self.dims = int(dims)
        self.metric = DistanceMetric.parse(metric)
        self.codec = codec
        self.rerank = rerank
        self.train_rows = train_rows
        self.base_path = Path(base_path) if base_path is not None else None
        self._lock = threading.RLock()

        self._vectors: Optional[np.ndarray] = None  # host (N_cap, D) f32
        self._count = 0
        self._valid = np.zeros(0, dtype=bool)       # host, length count
        self._row_to_id: List[Optional[str]] = []
        self._id_to_row: Dict[str, int] = {}
        self._metadata: List[Optional[dict]] = []
        self._columns: Optional[ColumnView] = None

        self._qz = None            # trained codec
        self._codes = None         # device: binary (W, cap) uint32 / int8 (cap, D)
        self._code_cap = 0
        self._sq_stats = None      # int8: (vsq, rinv) device arrays, len cap
        self._dvalid = None        # device bool (cap,), padding False

        if self.base_path is not None and \
                (self.base_path / STORE_FILE).exists():
            self._load()

    # ------------------------------------------------------------------
    def count(self) -> int:
        return int(self._valid[:self._count].sum())

    def __len__(self) -> int:
        return self.count()

    def all_ids(self) -> List[str]:
        return [i for i in self._row_to_id if i is not None]

    # ------------------------------------------------------------------
    # Ingest
    # ------------------------------------------------------------------
    def insert_batch(self, vectors, ids: Optional[Sequence[str]] = None,
                     metadatas: Optional[Sequence[Optional[dict]]] = None
                     ) -> List[str]:
        v = as_f32_matrix(vectors, self.dims)
        n = v.shape[0]
        if ids is None:
            ids = [f"{self.name}-{self._count + i}" for i in range(n)]
        ids = list(ids)
        if len(ids) != n:
            raise ValueError(f"got {len(ids)} ids for {n} vectors")
        if metadatas is not None and len(metadatas) != n:
            raise ValueError(f"got {len(metadatas)} metadatas for {n} vectors")
        if len(set(ids)) != n:
            raise ValueError("duplicate ids within the batch")
        with self._lock:
            dup = [i for i in ids if i in self._id_to_row]
            if dup:
                raise ValueError(f"duplicate ids: {dup[:5]}"
                                 + ("..." if len(dup) > 5 else ""))
            self._grow_host(self._count + n)
            self._vectors[self._count:self._count + n] = v
            total = self._count + n
            if self._qz is None:
                self._train(self._vectors[:total])
                self._trained_rows = total
            elif (total >= 8 * getattr(self, "_trained_rows", total)
                  and getattr(self, "_trained_rows", 0) < self.train_rows):
                # the codec was trained on a much smaller prefix (e.g. a
                # single first row -> degenerate scale/thresholds and
                # near-random coarse ordering); retrain on the grown
                # corpus and re-encode.  Triggers O(log N) times total.
                self._train(self._vectors[:total])
                self._trained_rows = total
                self._rebuild_codes(self._count)
            self._append_codes(v)
            start = self._count
            self._count += n
            self._valid = np.concatenate(
                [self._valid, np.ones(n, dtype=bool)])
            for j, (rid) in enumerate(ids):
                self._id_to_row[rid] = start + j
            self._row_to_id.extend(ids)
            self._metadata.extend(metadatas if metadatas is not None
                                  else [None] * n)
            self._columns = None
            # incremental device-validity update: a full capacity-sized
            # rebuild + upload per mutation is O(cap) bytes (20 MB at the
            # 20M scale) — only capacity changes force it
            if (self._dvalid is None
                    or self._dvalid.shape[0] != self._code_cap):
                self._sync_dvalid()
            else:
                self._dvalid = jax.lax.dynamic_update_slice(
                    self._dvalid, jnp.ones((n,), bool), (start,))
        return ids

    def insert(self, vector, id: Optional[str] = None,
               metadata: Optional[dict] = None) -> str:
        return self.insert_batch(as_f32_matrix(vector, self.dims),
                                 None if id is None else [id],
                                 None if metadata is None else [metadata])[0]

    def delete(self, id: str) -> bool:
        return self.delete_batch([id]) == 1

    def delete_batch(self, ids: Sequence[str]) -> int:
        with self._lock:
            rows = [self._id_to_row.pop(i) for i in ids
                    if i in self._id_to_row]
            for r in rows:
                self._valid[r] = False
                self._row_to_id[r] = None
                self._metadata[r] = None
            if rows:
                self._columns = None
                if (self._dvalid is None
                        or self._dvalid.shape[0] != self._code_cap):
                    self._sync_dvalid()
                else:  # point tombstones, O(len(rows)) not O(capacity)
                    self._dvalid = self._dvalid.at[
                        jnp.asarray(np.asarray(rows))].set(False)
            return len(rows)

    def get(self, id: str, include_vector: bool = False) -> Optional[dict]:
        row = self._id_to_row.get(id)
        if row is None:
            return None
        out = {"id": id, "metadata": self._metadata[row] or {}}
        if include_vector:
            out["vector"] = np.array(self._vectors[row])
        return out

    # ------------------------------------------------------------------
    # Search: device coarse scan -> host gather -> exact host re-rank
    # ------------------------------------------------------------------
    def search(self, query, k: int = 10, filter: Optional[Filter] = None,
               rerank: Optional[int] = None) -> List[SearchResult]:
        return self.search_batch(query, k, filter, rerank)[0]

    def search_batch(self, queries, k: int = 10,
                     filter: Optional[Filter] = None,
                     rerank: Optional[int] = None
                     ) -> List[List[SearchResult]]:
        q = as_f32_matrix(queries, self.dims)
        with self._lock:
            if self.count() == 0:
                return [[] for _ in range(q.shape[0])]
            fmask = (filter.mask(self._column_view())
                     if filter is not None else None)
            c = min(max(k * (rerank or self.rerank), k),
                    int(self._valid.sum()))
            mask = self._device_mask(fmask)
            cvals, crows = self._coarse(q, c, mask)        # (B, C) host
            # host gather + exact re-rank (C rows x 3 KB — the only
            # full-precision bytes a query ever touches)
            safe = np.clip(crows, 0, self._count - 1)
            cand = self._vectors[safe.reshape(-1)].reshape(
                q.shape[0], -1, self.dims)                  # (B, C, D) f32
            # a selective filter can match fewer rows than c: the coarse
            # top-c then contains MASKED picks whose clipped indices are
            # arbitrary rows — screen them by coarse value, not just by
            # validity (quant/scan.py's cand_ok contract)
            from ..kernels.distances import MASKED
            ok = (cvals < MASKED * 0.5) & np.take(self._valid, safe)
            if fmask is not None:
                ok &= np.take(fmask, safe)
            dists = self._exact_host(q, cand)               # (B, C)
            dists = np.where(ok, dists, np.inf)
            order = np.argsort(dists, axis=1)[:, :k]
            top_d = np.take_along_axis(dists, order, axis=1)
            top_r = np.take_along_axis(safe, order, axis=1)
            results: List[List[SearchResult]] = []
            for bi in range(q.shape[0]):
                hits: List[SearchResult] = []
                for ki in range(top_d.shape[1]):
                    if not np.isfinite(top_d[bi, ki]):
                        continue
                    row = int(top_r[bi, ki])
                    rid = self._row_to_id[row]
                    if rid is None:
                        continue
                    hits.append(SearchResult(
                        id=rid, score=float(top_d[bi, ki]),
                        metadata=self._metadata[row] or {}))
                results.append(hits)
            return results

    # ------------------------------------------------------------------
    def memory_usage(self) -> dict:
        n = self._count
        host = n * self.dims * 4
        if self.codec == "binary":
            per_row = (self._codes.shape[0] * 4
                       if self._codes is not None else 0)
        elif self.codec == "int4":
            per_row = (self._codes.shape[1]
                       if self._codes is not None else (self.dims + 1) // 2)
        else:
            per_row = self.dims
        dev = n * per_row
        cap_dev = self._code_cap * per_row
        return {"rows": n, "host_vector_bytes": host,
                "device_code_bytes": dev,
                "device_code_capacity_bytes": cap_dev,
                "compression": round(host / max(dev, 1), 1)}

    def stats(self) -> dict:
        return {"kind": "bigcollection", "codec": self.codec,
                "rows": self._count, "live": self.count(),
                **self.memory_usage()}

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------
    def _grow_host(self, needed: int) -> None:
        cap = 0 if self._vectors is None else self._vectors.shape[0]
        if needed <= cap:
            return
        new_cap = _next_pow2(needed)
        grown = np.empty((new_cap, self.dims), np.float32)
        if self._count:
            grown[:self._count] = self._vectors[:self._count]
        self._vectors = grown

    def _train(self, sample: np.ndarray) -> None:
        from ..quant.binary import BinaryQuantizer
        from ..quant.int4 import Int4Quantizer
        from ..quant.scalar import ScalarQuantizer
        # strided sample (not the prefix): an ingestion-ordered corpus
        # would otherwise train on one drifted slice
        step = max(1, sample.shape[0] // self.train_rows)
        s = sample[::step][:self.train_rows]
        cls = {"binary": BinaryQuantizer,
               "int4": Int4Quantizer}.get(self.codec, ScalarQuantizer)
        self._qz = cls().train(s)

    def _rebuild_codes(self, rows: int) -> None:
        """Re-encode the first ``rows`` host rows through the current
        codec (after a retrain), chunked like _load."""
        saved = rows
        self._codes, self._code_cap, self._sq_stats = None, 0, None
        count_bak = self._count
        self._count = 0
        chunk = 1_000_000
        for st in range(0, saved, chunk):
            self._append_codes(np.asarray(
                self._vectors[st:min(st + chunk, saved)],
                dtype=np.float32))
            self._count += min(chunk, saved - st)
        self._count = count_bak
        self._dvalid = None  # capacity may have changed; rebuild lazily

    def _append_codes(self, v: np.ndarray) -> None:
        """Encode new rows on device into the pre-allocated code buffer."""
        n = v.shape[0]
        needed = self._count + n
        if self.codec == "binary":
            new = self._qz.encode(v).T                     # (W, n) uint32
            w = new.shape[0]
            if needed > self._code_cap:
                cap = _next_pow2(needed)
                old = self._codes
                self._codes = jnp.zeros((w, cap), dtype=jnp.uint32)
                if old is not None and self._count:
                    self._codes = jax.lax.dynamic_update_slice(
                        self._codes, old[:, :self._count], (0, 0))
                self._code_cap = cap
            self._codes = jax.lax.dynamic_update_slice(
                self._codes, new, (0, self._count))
        else:
            # int8: (n, D) int8 | int4: (n, W) packed uint8 — identical
            # row-major buffer mechanics, both carry dequant row stats
            new = self._qz.encode(v)
            if needed > self._code_cap:
                cap = _next_pow2(needed)
                old, old_stats = self._codes, self._sq_stats
                self._codes = jnp.zeros((cap, new.shape[1]),
                                        dtype=new.dtype)
                vsq = jnp.zeros((cap,), jnp.float32)
                rinv = jnp.zeros((cap,), jnp.float32)
                if old is not None and self._count:
                    self._codes = jax.lax.dynamic_update_slice(
                        self._codes, old[:self._count], (0, 0))
                    vsq = jax.lax.dynamic_update_slice(
                        vsq, old_stats[0][:self._count], (0,))
                    rinv = jax.lax.dynamic_update_slice(
                        rinv, old_stats[1][:self._count], (0,))
                self._sq_stats = (vsq, rinv)
                self._code_cap = cap
            self._codes = jax.lax.dynamic_update_slice(
                self._codes, new, (self._count, 0))
            nsq, nrinv = self._qz.corpus_stats(new)
            self._sq_stats = (
                jax.lax.dynamic_update_slice(self._sq_stats[0], nsq,
                                             (self._count,)),
                jax.lax.dynamic_update_slice(self._sq_stats[1], nrinv,
                                             (self._count,)))

    def _sync_dvalid(self) -> None:
        m = np.zeros(self._code_cap, dtype=bool)
        m[:self._count] = self._valid[:self._count]
        self._dvalid = jnp.asarray(m)

    def _device_mask(self, fmask: Optional[np.ndarray]):
        if self._dvalid is None:
            self._sync_dvalid()
        if fmask is None:
            return self._dvalid
        m = np.zeros(self._code_cap, dtype=bool)
        m[:self._count] = self._valid[:self._count] & fmask[:self._count]
        return jnp.asarray(m)

    def _column_view(self) -> ColumnView:
        if self._columns is None:
            self._columns = ColumnView(self._metadata)
        return self._columns

    def _coarse(self, q: np.ndarray, c: int, mask) -> np.ndarray:
        if self.codec == "binary":
            from ..quant.scan import _hamming_coarse_topk, _pow2ge
            qcodes = self._qz.encode(q)                    # (B, W)
            vals, rows = _hamming_coarse_topk(
                qcodes.T, self._codes, mask, k=c,
                chunk=int(min(262_144, _pow2ge(self._code_cap))))
            return np.asarray(vals), np.asarray(rows)
        if self.codec == "int4":
            from ..quant.scan import _int4_coarse_topk
            vsq, rinv = self._sq_stats
            qd = jnp.asarray(self._qz._pad_data(jnp.asarray(q)))
            vals, rows = _int4_coarse_topk(
                qd, self._codes, self._qz.vmin, self._qz.scale,
                vsq, rinv, mask, metric=self.metric, k=c)
            return np.asarray(vals), np.asarray(rows)
        # int8 coarse
        from ..quant.scan import _int8_coarse_topk
        vsq, rinv = self._sq_stats
        vals, rows = _int8_coarse_topk(
            jnp.asarray(q), self._codes, self._qz.vmin, self._qz.scale,
            vsq, rinv, mask, metric=self.metric, k=c)
        return np.asarray(vals), np.asarray(rows)

    def _exact_host(self, q: np.ndarray, cand: np.ndarray) -> np.ndarray:
        """Exact metric on gathered candidates, host BLAS ((B,C,D) tiny)."""
        from ..kernels.distances import host_exact_scores
        return host_exact_scores(q, cand, self.metric)

    # ------------------------------------------------------------------
    # Persistence: container for ids/meta/codec, raw .npy for vectors
    # (np.load(..., mmap_mode="r") keeps reloads lazy at any scale)
    # ------------------------------------------------------------------
    def save(self) -> None:
        if self.base_path is None:
            raise ValueError("BigCollection has no base_path; cannot save")
        with self._lock:
            self.base_path.mkdir(parents=True, exist_ok=True)
            # After _load(), self._vectors may still be a read-only memmap
            # of vectors.npy itself; np.save would truncate the backing
            # file before reading the mapped pages (SIGBUS / corruption).
            # Write to a temp file and atomically swap.
            import os
            tmp = self.base_path / "vectors.tmp.npy"  # .npy: np.save keeps it
            np.save(tmp, self._vectors[:self._count])
            os.replace(tmp, self.base_path / VECTORS_FILE)
            if self.codec == "binary":
                qz_sections = {"thresholds": np.asarray(self._qz.thresholds)}
            else:
                qz_sections = {"vmin": np.asarray(self._qz.vmin),
                               "scale": np.asarray(self._qz.scale)}
            save_container(
                self.base_path / STORE_FILE,
                {"ids": self._row_to_id, "metadata": self._metadata,
                 "valid": self._valid[:self._count], **qz_sections},
                meta={"kind": "bigcollection", "name": self.name,
                      "dims": self.dims, "metric": self.metric.value,
                      "codec": self.codec, "count": self._count,
                      "rerank": self.rerank})

    def _load(self) -> None:
        c = load_container(self.base_path / STORE_FILE)
        meta = c.meta
        self.name = meta["name"]
        self.dims = int(meta["dims"])
        self.metric = DistanceMetric.parse(meta["metric"])
        self.codec = meta["codec"]
        self.rerank = int(meta.get("rerank", 16))
        vecs = np.load(self.base_path / VECTORS_FILE, mmap_mode="r")
        n = int(meta["count"])
        # host copy stays a memmap until the first append forces growth
        self._vectors = vecs
        self._count = n
        # np.array (copy): the container reader hands back a read-only
        # buffer view, and delete_batch writes into _valid in place
        self._valid = np.array(c.read("valid"), dtype=bool)
        self._row_to_id = list(c.read("ids"))
        self._metadata = list(c.read("metadata"))
        self._id_to_row = {i: j for j, i in enumerate(self._row_to_id)
                           if i is not None}
        from ..quant.binary import BinaryQuantizer
        from ..quant.int4 import Int4Quantizer
        from ..quant.scalar import ScalarQuantizer
        if self.codec == "binary":
            qz = BinaryQuantizer(self.dims)
            qz.thresholds = jnp.asarray(np.asarray(c.read("thresholds")))
            qz.dims = self.dims
        else:
            qz = (Int4Quantizer(self.dims) if self.codec == "int4"
                  else ScalarQuantizer())
            qz.vmin = jnp.asarray(np.asarray(c.read("vmin")))
            qz.scale = jnp.asarray(np.asarray(c.read("scale")))
        self._qz = qz
        # re-encode the serving codes on device, chunked (encode is a
        # single fused kernel; at 20M rows this is seconds, not minutes)
        saved_count, self._count = n, 0
        self._codes, self._code_cap, self._sq_stats = None, 0, None
        chunk = 1_000_000
        for s in range(0, saved_count, chunk):
            self._append_codes(np.asarray(vecs[s:s + chunk],
                                          dtype=np.float32))
            self._count += min(chunk, saved_count - s)
        self._sync_dvalid()
