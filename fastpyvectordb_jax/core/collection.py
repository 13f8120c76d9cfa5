"""Core Collection: CRUD + exact/ANN search + filters + persistence.

Capability parity with the reference's optimized engine
(vectordb_optimized.py:207-739) on a device-resident substrate:

  * vectors live on-device in a DeviceVectorStore (core/store.py) — there is
    no separate index object holding the data, and no lazily-rebuilt matrix
    cache (vectordb_optimized.py:236-269 is unnecessary by construction);
  * ``search``/``search_batch`` are the *same* fused kernel — a single query
    is a batch of one.  Filters compile to device masks fused into top-k,
    replacing over-fetch + per-hit Python evaluation
    (vectordb_optimized.py:531, 550-573);
  * deletes tombstone the validity mask (mark_deleted semantics,
    vectordb_optimized.py:467-501) and ``compact()`` physically reclaims;
  * persistence is one FPVT container per collection instead of
    {index.bin, metadata.json, state.json, config.json}
    (vectordb_optimized.py:306-331).
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..kernels import topk as topk_mod
from ..persist.format import load_container, save_container
from .filters import ColumnView, Filter
from .store import DeviceVectorStore
from .types import CollectionConfig, DistanceMetric, SearchResult, as_f32_matrix

STORE_FILE = "collection.fpvt"


class Collection:
    """A named set of vectors with string ids and metadata dicts."""

    def __init__(self, config: CollectionConfig,
                 base_path: Optional[Path] = None):
        self.config = config
        self.base_path = Path(base_path) if base_path is not None else None
        self._lock = threading.RLock()
        self._store = DeviceVectorStore(config.dimensions,
                                        storage_dtype=config.storage_dtype)
        self._id_to_row: Dict[str, int] = {}
        self._row_to_id: List[Optional[str]] = []
        self._metadata: List[Optional[dict]] = []
        self._version = 0  # bumped on any mutation; invalidates caches
        self._columns: Optional[ColumnView] = None
        self._columns_version = -1
        self._columns_dirty: Optional[str] = None  # None | "sync" | "rebuild"
        self._columns_patchset: set = set()  # rows pending point-patch
        self._mask_cache: Dict[str, Tuple[int, np.ndarray]] = {}
        self._ids_arr: Optional[np.ndarray] = None  # object-array id cache
        self._ids_arr_version = -1
        self._ann = None  # optional ANN index (ann/ivf.py), built on demand
        self._quantized = None  # optional quantized scan state (quant/)
        self._rebuild_thread: Optional[threading.Thread] = None
        self._row_epoch = 0  # bumped by row RENUMBERING (compact/load):
        # a background rebuild spawned before must not swap in after
        self._serving_mode: Optional[str] = None  # optimize()-installed
        # default for search(exact=None): None | exact | ann | quantized
        self._wal = None  # write-ahead log (persist/wal.py), durability="wal"
        # durability is a runtime preference, not a data property: the
        # constructor's requested value wins over whatever the snapshot
        # recorded (else enabling WAL on an existing snapshot collection
        # would be silently ignored — _load replaces self.config)
        requested_durability = getattr(config, "durability", "snapshot")
        requested_fsync = getattr(config, "wal_fsync", False)
        if self.base_path is not None and (self.base_path / STORE_FILE).exists():
            self._load()
            self.config.durability = requested_durability
            self.config.wal_fsync = requested_fsync
        # subclass hook (e.g. HybridCollection's BM25 snapshot): runs
        # after the snapshot load but BEFORE WAL replay, so replayed
        # mutations layer on top of the loaded sidecar state
        self._after_snapshot_load()
        if self.base_path is not None and requested_durability == "wal":
            from ..persist.wal import WriteAheadLog
            self._wal = WriteAheadLog(self.base_path / "wal.log",
                                      fsync=requested_fsync)
            self._replay_wal()
        if self.base_path is not None:
            # config sidecar (reference: config.json per collection dir,
            # vectordb_optimized.py:306-331): VectorDB restart must
            # reconstruct durability/dims BEFORE deciding whether to
            # replay the WAL — without this, a reload defaulted to
            # snapshot durability and silently dropped WAL-only writes
            self._write_config_sidecar()

    def _after_snapshot_load(self) -> None:
        """Subclass hook; see __init__."""

    def _write_config_sidecar(self) -> None:
        import dataclasses
        import json as _json
        d = dataclasses.asdict(self.config)
        d["metric"] = DistanceMetric.parse(self.config.metric).value
        payload = _json.dumps(d, default=str)
        target = self.base_path / "config.json"
        import errno
        import os
        try:
            # skip the write when the sidecar already matches — pure reloads
            # must succeed on read-only snapshots/mounts, and concurrent
            # opens of the same directory should not race on the file
            if target.exists() and target.read_text() == payload:
                return
            self.base_path.mkdir(parents=True, exist_ok=True)
            tmp = self.base_path / "config.json.tmp"
            tmp.write_text(payload)
            os.replace(tmp, target)
        except OSError as e:
            # ONLY read-only/permission errors are survivable (opening a
            # snapshot mount must work); anything else — disk full,
            # transient I/O — must surface, or the next process reloads a
            # stale config and silently serves with the wrong knobs
            if e.errno not in (errno.EROFS, errno.EACCES, errno.EPERM):
                raise

    @staticmethod
    def load_config_sidecar(base_path) -> Optional[CollectionConfig]:
        import dataclasses
        import json as _json
        f = Path(base_path) / "config.json"
        if not f.exists():
            return None
        try:
            d = _json.loads(f.read_text())
        except (OSError, _json.JSONDecodeError):
            return None
        names = {fld.name for fld in dataclasses.fields(CollectionConfig)}
        return CollectionConfig(**{k: v for k, v in d.items() if k in names})

    # ------------------------------------------------------------------
    # CRUD
    # ------------------------------------------------------------------
    def insert(self, vector, id: Optional[str] = None,
               metadata: Optional[dict] = None) -> str:
        ids = self.insert_batch(as_f32_matrix(vector, self.config.dimensions),
                                [id] if id is not None else None,
                                [metadata] if metadata is not None else None)
        return ids[0]

    def insert_batch(self, vectors, ids: Optional[Sequence[str]] = None,
                     metadatas: Optional[Sequence[Optional[dict]]] = None
                     ) -> List[str]:
        arr = as_f32_matrix(vectors, self.config.dimensions)
        n = arr.shape[0]
        if ids is None:
            import uuid
            ids = [str(uuid.uuid4()) for _ in range(n)]
        else:
            ids = [str(i) for i in ids]
            if len(ids) != n:
                raise ValueError(
                    f"got {len(ids)} ids for {n} vectors")
            if len(set(ids)) != n:
                raise ValueError("duplicate ids within batch")
        if metadatas is not None and len(metadatas) != n:
            raise ValueError(f"got {len(metadatas)} metadatas for {n} vectors")
        with self._lock:
            dup = [i for i in ids if i in self._id_to_row]
            if dup:
                raise ValueError(f"IDs already exist: {dup[:8]}")
            if self._wal is not None:
                self._wal.log_insert(
                    ids, metadatas if metadatas is not None else [None] * n,
                    arr)
            rows = self._store.append(arr)
            for j, (rid, row) in enumerate(zip(ids, rows)):
                self._id_to_row[rid] = int(row)
            self._row_to_id.extend(ids)
            self._metadata.extend(
                [dict(m) if m else {} for m in metadatas] if metadatas is not None
                else [{} for _ in range(n)])
            self._bump(append_only=True)
        return list(ids)

    def upsert(self, vector, id: str, metadata: Optional[dict] = None) -> str:
        return self.upsert2(vector, id, metadata)[0]

    def upsert2(self, vector, id: str, metadata: Optional[dict] = None
                ) -> Tuple[str, bool]:
        """Upsert reporting (id, existed) atomically under the lock —
        callers deciding UPDATE-vs-INSERT semantics (the server's change
        feed) must not race a separate pre-read against the write."""
        with self._lock:
            existed = id in self._id_to_row
            if existed:
                self.delete(id)
            return self.insert(vector, id, metadata), existed

    def get(self, id: str, include_vector: bool = False) -> Optional[dict]:
        return self.get_batch([id], include_vector)[0]

    def get_batch(self, ids: Sequence[str], include_vectors: bool = False
                  ) -> List[Optional[dict]]:
        with self._lock:
            rows, found = [], []
            for i in ids:
                r = self._id_to_row.get(str(i))
                found.append(r)
                if r is not None:
                    rows.append(r)
            vecs = (self._store.get_rows(np.asarray(rows, dtype=np.int64))
                    if include_vectors and rows else None)
            out: List[Optional[dict]] = []
            vi = 0
            for i, r in zip(ids, found):
                if r is None:
                    out.append(None)
                    continue
                d = {"id": str(i), "metadata": dict(self._metadata[r] or {})}
                if include_vectors:
                    d["vector"] = vecs[vi]
                    vi += 1
                out.append(d)
            return out

    def delete(self, id: str) -> bool:
        return self.delete_batch([id]) == 1

    def delete_batch(self, ids: Sequence[str]) -> int:
        with self._lock:
            if self._wal is not None:
                live = [i for i in ids if str(i) in self._id_to_row]
                if live:
                    self._wal.log_delete(live)
            rows = []
            for i in ids:
                r = self._id_to_row.pop(str(i), None)
                if r is not None:
                    rows.append(r)
                    self._row_to_id[r] = None
                    self._metadata[r] = None
            if rows:
                self._store.delete_rows(np.asarray(rows, dtype=np.int64))
                # deletes never invalidate ANN/quantized state: the store
                # validity mask already excludes tombstones at search time
                self._bump(keep_indexes=True, patched_rows=rows)
            return len(rows)

    def update_metadata(self, id: str, metadata: dict, merge: bool = True) -> bool:
        with self._lock:
            r = self._id_to_row.get(str(id))
            if r is None:
                return False
            if self._wal is not None:
                self._wal.log_update_metadata(str(id), metadata, merge)
            if merge and self._metadata[r]:
                self._metadata[r] = {**self._metadata[r], **metadata}
            else:
                self._metadata[r] = dict(metadata)
            self._bump(keep_indexes=True, patched_rows=[r])  # vectors same
            return True

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------
    def search(self, query, k: int = 10, filter: Optional[Filter] = None,
               include_vectors: bool = False, exact: Optional[bool] = None
               ) -> List[SearchResult]:
        return self.search_batch(as_f32_matrix(query, self.config.dimensions),
                                 k, filter, include_vectors, exact)[0]

    def search_batch(self, queries, k: int = 10,
                     filter: Optional[Filter] = None,
                     include_vectors: bool = False,
                     exact: Optional[bool] = None
                     ) -> List[List[SearchResult]]:
        q = as_f32_matrix(queries, self.config.dimensions, allow_device=True)
        with self._lock:
            if self._store.n_valid == 0:
                return [[] for _ in range(q.shape[0])]
            dists, rows = self._search_rows(q, k, filter, exact)
            return self._assemble(q, dists, rows, k, include_vectors)

    def search_arrays(self, queries, k: int = 10,
                      filter: Optional[Filter] = None,
                      exact: Optional[bool] = None):
        """Array-shaped search for high-throughput callers (the binary
        serving path): same kernel dispatch as ``search_batch`` but the
        result is ``(ids, scores, rows)`` — an object ndarray of ids
        (B, k; None where fewer than k hits), an f32 score grid (B, k;
        +inf on empty slots), and the raw int32 store rows — with no
        per-hit SearchResult / metadata-dict construction.  The reference
        has no analogue because hnswlib already returns label arrays
        (vectordb_optimized.py:610); this restores that property."""
        q = as_f32_matrix(queries, self.config.dimensions, allow_device=True)
        with self._lock:
            b = q.shape[0]
            if self._store.n_valid == 0:
                return (np.full((b, k), None, dtype=object),
                        np.full((b, k), np.inf, dtype=np.float32),
                        np.full((b, k), -1, dtype=np.int32))
            dists, rows = self._search_rows(q, k, filter, exact)
            return self._arrays_of(dists, rows, k)

    def search_arrays_stream(self, batches, k: int = 10,
                             filter: Optional[Filter] = None,
                             depth: int = 2,
                             wire_dtype: Optional[str] = None):
        """Pipelined ``search_arrays`` over an iterable of query batches:
        yields one (ids, scores, rows) triple per batch, keeping up to
        ``depth`` batches in flight so batch i+1's host->device upload and
        kernel dispatch overlap batch i's result fetch and assembly.

        The synchronous path serializes upload, kernel and result fetch
        per call, while JAX transfers and dispatches are async; this
        overlaps them.  Its gain on the GPU is not measured.
        The reference's analogue is hnswlib's batch ``knn_query``
        returning raw label arrays (vectordb_optimized.py:610).

        wire_dtype: forwarded to the store ("int8" ships 4x-compressed
        query codes; None = bf16 when compute is bf16).  Pipelines the
        exact scan; if a quantized/ANN serving mode is installed the
        stream degrades to per-batch synchronous calls (still one triple
        per batch, no pipelining) rather than silently changing mode.
        """
        serving_exact = (self._serving_mode in (None, "exact")
                         and (self.config.index == "flat"
                              or self._ann is None))
        if not serving_exact:
            for q in batches:
                yield self.search_arrays(q, k, filter)
            return
        from collections import deque
        inflight: deque = deque()
        for q in batches:
            q = as_f32_matrix(q, self.config.dimensions, allow_device=True)
            with self._lock:
                if self._store.n_valid == 0:
                    b = q.shape[0]
                    inflight.append((None, b))
                else:
                    mask = self._filter_mask(filter)
                    dv, rv = self._store.search(
                        q, k, self.config.metric, extra_mask=mask,
                        compute_dtype=self.config.compute_dtype,
                        topk=self.config.topk, return_device=True,
                        wire_dtype=wire_dtype)
                    inflight.append(((dv, rv), q.shape[0]))
            if len(inflight) >= max(1, depth):
                yield self._drain_one(inflight, k)
        while inflight:
            yield self._drain_one(inflight, k)

    def _drain_one(self, inflight, k: int):
        head, b = inflight.popleft()
        if head is None:
            return (np.full((b, k), None, dtype=object),
                    np.full((b, k), np.inf, dtype=np.float32),
                    np.full((b, k), -1, dtype=np.int32))
        import jax as _jax
        dists, rows = _jax.device_get(head)
        with self._lock:
            return self._arrays_of(dists, rows, k)

    def _arrays_of(self, dists, rows, k: int):
        """(dists, rows) -> the (ids, scores, rows) array triple of
        ``search_arrays``.  Caller holds the lock."""
        dists = np.asarray(dists)[:, :k].astype(np.float32, copy=False)
        rows = np.asarray(rows)[:, :k]
        ok = np.asarray(topk_mod.valid_hits(dists))
        nrow = len(self._row_to_id)
        ok &= (rows >= 0) & (rows < max(nrow, 1))
        if nrow:
            ids = self._ids_object_array()[np.clip(rows, 0, nrow - 1)]
            ok &= ids != None  # noqa: E711 - elementwise
        else:
            ids = np.full(rows.shape, None, dtype=object)
        ids = np.where(ok, ids, None)
        dists = np.where(ok, dists, np.float32(np.inf))
        rows = np.where(ok, rows, -1).astype(np.int32, copy=False)
        return ids, dists, rows

    def metadata_for_rows(self, rows: np.ndarray) -> list:
        """Per-row metadata dict copies for ``search_arrays`` results
        (row < 0 → None), fetched under the collection lock."""
        with self._lock:
            md = self._metadata
            n = len(md)
            return [[dict(md[r] or {}) if 0 <= r < n else None
                     for r in row] for row in np.asarray(rows).tolist()]

    def _search_rows(self, q, k: int, filter: Optional[Filter],
                     exact: Optional[bool]):
        """Shared dispatch: (ANN | exact masked scan | optimized default)
        → (dists, rows).  Caller holds the lock and has handled the
        empty-store case."""
        if exact is None and self._serving_mode is not None:
            # optimize()-installed default; explicit exact=True/False
            # always overrides
            if (self._serving_mode == "quantized"
                    and self._quantized is not None):
                return self._quantized_rows(np.asarray(q), k, None, filter)
            if self._serving_mode == "exact":
                exact = True
            elif self._serving_mode == "ann":
                exact = False
        use_ann = (exact is False) or (
            exact is None and self.config.index != "flat"
            and self._ann is not None)
        mask = self._filter_mask(filter)
        if (use_ann and self._ann is not None and mask is not None
                and exact is None
                and int(mask.sum()) <= max(1024, 32 * k)):
            # Highly selective filter: the exact masked scan over the
            # few matching rows is both faster and recall-1.0, while a
            # post-filtered ANN pass would collapse recall (the classic
            # filtered-ANN failure mode; hnswlib has the same issue).
            use_ann = False
        if use_ann and self._ann is not None:
            if self._index_rebuild_due(self._ann) and not self._ann.stale:
                if self.config.rebuild == "inline":
                    self._ann.mark_stale()  # rebuilt inside .search()
                else:
                    # background: THIS search (and every one until the
                    # swap) serves through the stale index + exact tail
                    # merge — correct, just less amortized — instead of
                    # blocking a request on a minutes-long k-means
                    self._spawn_rebuild("ann")
            if not isinstance(q, np.ndarray):
                q = np.asarray(q)  # ANN routing runs host-side numpy
            dists, rows = self._ann.search(
                q, k, mask=mask,
                overfetch=self.config.overfetch if filter is not None else 1)
            built = self._ann._built_count
            if self._store.count > built:
                # appended tail not yet in the index: exact-scan it and
                # merge (row spaces are disjoint, so no dedup needed)
                td, tr = self._tail_exact(q, k, mask, built)
                dists, rows = topk_mod.merge_topk_host(
                    dists, rows, td, tr, k)
            return dists, rows
        return self._store.search(
            q, k, self.config.metric, extra_mask=mask,
            compute_dtype=self.config.compute_dtype,
            topk=self.config.topk)

    def prewarm(self, max_batch: int = 1024, k: int = 10,
                modes: Optional[Sequence[str]] = None) -> Dict[str, float]:
        """Compile the serving dispatch for every power-of-two query batch
        size up to ``max_batch``, populating XLA's persistent compile cache.

        The query batch is padded to a power of two (store.search), so the
        compile set is finite and enumerable; a primed persistent cache
        (``jax_compilation_cache_dir``) lets every later process skip the
        compiles.  Call once at deployment startup so the first request
        does not pay a compile.

        modes: subset of {"exact", "quantized", "ann"}; defaults to the
        paths this collection has enabled.  Returns {mode_bN: seconds}.
        """
        import time as _time
        if self._store.n_valid == 0:
            return {}
        want = set(modes) if modes is not None else None

        def on(name: str, enabled: bool) -> bool:
            return enabled if want is None else (name in want)

        rng = np.random.default_rng(0)
        timings: Dict[str, float] = {}
        b = 1
        while True:
            if b > max_batch and b // 2 >= max_batch:
                break  # the covering pow2 bucket is already compiled
            q = rng.standard_normal(
                (b, self.config.dimensions)).astype(np.float32)
            if on("exact", True):
                t0 = _time.perf_counter()
                self.search_arrays(q, k=k, exact=True)
                timings[f"exact_b{b}"] = round(_time.perf_counter() - t0, 3)
            if on("quantized", self._quantized is not None):
                t0 = _time.perf_counter()
                self.search_quantized_arrays(q, k=k)
                timings[f"quantized_b{b}"] = round(
                    _time.perf_counter() - t0, 3)
            if on("ann", self._ann is not None):
                t0 = _time.perf_counter()
                self.search_arrays(q, k=k, exact=False)
                timings[f"ann_b{b}"] = round(_time.perf_counter() - t0, 3)
            b <<= 1
        return timings

    def brute_force_search(self, query, k: int = 10,
                           filter: Optional[Filter] = None,
                           include_vectors: bool = False
                           ) -> List[SearchResult]:
        """Exact search (always the flat path).  On the device this *is* the
        primary path, unlike the reference where brute force is the slow
        fallback (vectordb_optimized.py:650-721)."""
        return self.search(query, k, filter, include_vectors, exact=True)

    def _ids_object_array(self) -> np.ndarray:
        """``_row_to_id`` as an object ndarray, memoized per mutation version
        — turns the per-hit id lookup in ``_assemble`` into one vectorized
        gather (the assembly loop was 6x the kernel cost at B=1024)."""
        if self._ids_arr is None or self._ids_arr_version != self._version \
                or len(self._ids_arr) != len(self._row_to_id):
            self._ids_arr = np.array(self._row_to_id, dtype=object)
            self._ids_arr_version = self._version
        return self._ids_arr

    def _assemble(self, q, dists: np.ndarray, rows: np.ndarray,
                  k: int, include_vectors: bool) -> List[List[SearchResult]]:
        dists = np.asarray(dists)
        rows = np.asarray(rows)
        ok = np.asarray(topk_mod.valid_hits(dists))
        nrow = len(self._row_to_id)
        in_range = (rows >= 0) & (rows < nrow)
        if nrow:
            ids_arr = self._ids_object_array()
            rid_grid = ids_arr[np.clip(rows, 0, nrow - 1)]
            # None entries = tombstoned between mask build and assembly
            ok = ok & in_range & (rid_grid != None)  # noqa: E711 - elementwise
        else:
            ok = ok & in_range
            rid_grid = rows  # unused: ok is all-False
        results: List[List[SearchResult]] = []
        if include_vectors:
            # one gather for every candidate slot, indexed positionally so
            # skipped hits can't desynchronize the mapping
            vecs = self._store.get_rows(
                np.maximum(rows, 0).reshape(-1).astype(np.int64)
            ).reshape(rows.shape[0], rows.shape[1], -1)
        md = self._metadata
        # bulk-convert the numpy grids to Python lists ONCE: per-element
        # numpy indexing costs ~1 us a touch and the loop below touches
        # B*k elements three times
        dlist = dists.tolist()
        rlist = rows.tolist()
        idlist = (rid_grid.tolist() if nrow else rlist)
        all_ok = bool(ok.all())  # unfiltered steady state: no per-row scan
        full_sel = list(range(min(k, rows.shape[1])))
        for bi in range(rows.shape[0]):
            if all_ok:
                sel = full_sel
            else:
                sel = np.nonzero(ok[bi])[0]
                sel = sel[:k].tolist() if sel.size > k else sel.tolist()
            drow, rrow, irow = dlist[bi], rlist[bi], idlist[bi]
            hits = []
            for ki in sel:
                m = md[rrow[ki]]
                hits.append(SearchResult(
                    id=irow[ki],
                    score=drow[ki],
                    metadata={} if m is None else dict(m),
                    vector=(vecs[bi, ki] if include_vectors else None),
                ))
            results.append(hits)
        return results

    # ------------------------------------------------------------------
    # Filters
    # ------------------------------------------------------------------
    def _column_view(self) -> ColumnView:
        if self._columns is not None and self._columns_version != self._version \
                and self._columns_dirty == "sync":
            # appends extend; deleted/updated rows are point-patched —
            # neither needs the O(N x columns) rebuild
            self._columns.sync_appended()
            if self._columns_patchset:
                self._columns.patch_rows(sorted(self._columns_patchset))
            self._columns_patchset.clear()
            self._columns_version = self._version
            self._columns_dirty = None
        if self._columns is None or self._columns_version != self._version:
            self._columns = ColumnView(self._metadata)
            self._columns_version = self._version
            self._columns_dirty = None
            self._columns_patchset.clear()
        return self._columns

    def ids_matching(self, filter: Filter) -> List[str]:
        """Ids of live rows whose metadata matches ``filter`` — one
        vectorized mask pass (the high-level client's where-scans used to
        loop get() per id: O(N) lock round-trips)."""
        with self._lock:
            mask = self._filter_mask(filter)
            if mask is None:
                return self.all_ids()
            return [rid for rid, hit in zip(self._row_to_id, mask)
                    if hit and rid is not None]

    def _filter_mask(self, filter: Optional[Filter]) -> Optional[np.ndarray]:
        """Compile a Filter to a host boolean mask over rows [0, count)."""
        if filter is None:
            return None
        fp = filter.fingerprint()
        cached = self._mask_cache.get(fp)
        if cached is not None and cached[0] == self._version:
            return cached[1]
        mask = filter.mask(self._column_view())
        if len(self._mask_cache) > 64:
            self._mask_cache.clear()
        self._mask_cache[fp] = (self._version, mask)
        return mask

    def _bump(self, append_only: bool = False,
              keep_indexes: bool = False,
              patched_rows: Optional[Sequence[int]] = None) -> None:
        self._version += 1
        # column-cache invalidation: appends cheaply sync, known row
        # mutations (delete tombstones / metadata updates) point-patch;
        # only shape-changing mutations (compact, load) force a rebuild
        if patched_rows is not None:
            if self._columns_dirty != "rebuild":
                self._columns_patchset.update(int(r) for r in patched_rows)
                self._columns_dirty = "sync"
        elif not append_only:
            self._columns_dirty = "rebuild"
        elif self._columns_dirty != "rebuild":
            self._columns_dirty = "sync"
        if append_only or keep_indexes:
            # Incremental maintenance (hnswlib parity: add_items into a
            # live index, vectordb_optimized.py:337-416): appended rows are
            # served by an exact scan over the tail merged with the index's
            # hits (search_batch); deletes/metadata updates are covered by
            # the validity mask.  A threshold-triggered rebuild amortizes
            # (_index_rebuild_due).
            return
        if self._ann is not None:
            self._ann.mark_stale()
        if self._quantized is not None:
            self._quantized = None

    def _index_rebuild_due(self, snapshot) -> bool:
        """True when an index built over ``snapshot._built_count`` rows has
        drifted enough (tail growth or mass deletes) that a rebuild beats
        serving through the merge path.

        The mass-delete clause compares against the LIVE row count at
        build time: comparing against built_count (which includes
        tombstones) never resets after a rebuild — the condition stayed
        true forever and every subsequent query paid a full rebuild until
        compact().)"""
        built_count = getattr(snapshot, "_built_count",
                              getattr(snapshot, "built_count", 0))
        built_live = getattr(snapshot, "_built_n_valid",
                             getattr(snapshot, "built_n_valid",
                                     built_count))
        tail = self._store.count - built_count
        return (tail > max(built_count // 4, 4096)
                or self._store.n_valid * 2 < built_live)

    def _spawn_rebuild(self, kind: str) -> None:
        """Background index rebuild (one in flight per collection): build a
        fresh index off-lock with the live index's own recipe, then swap
        it in atomically.  The swap is guarded against row RENUMBERING
        (compact/load bump ``_row_epoch``; a pre-renumbering build would
        reference dead row ids) and against the index object having been
        replaced meanwhile (user re-ran build_ann / enable_quantized_scan).
        Rows appended during the build serve through the tail merge, and
        deletes ride the validity mask, so the un-swapped window is always
        correct — just less amortized.  Caller holds the lock."""
        t = self._rebuild_thread
        if t is not None and t.is_alive():
            return
        epoch = self._row_epoch
        if kind == "ann":
            snap = self._ann

            def work():
                new = snap.rebuilt()
                with self._lock:
                    if self._ann is snap and self._row_epoch == epoch:
                        self._ann = new
        else:
            snap = self._quantized
            kw = dict(getattr(self, "_quant_kwargs", {}))

            def work():
                from ..quant.scan import QuantizedScan
                new = QuantizedScan.build(self, kind=snap.kind, **kw)
                tuned = getattr(snap, "default_rerank", None)
                if tuned is not None:  # tune_rerank's depth survives
                    new.default_rerank = tuned
                with self._lock:
                    if (self._quantized is snap
                            and self._row_epoch == epoch):
                        self._quantized = new

        def runner():
            try:
                work()
            except Exception as e:  # noqa: BLE001 - background best-effort
                import sys
                print(f"background {kind} rebuild failed "
                      f"({type(e).__name__}: {e}); serving continues on "
                      "the stale index + tail merge", file=sys.stderr)

        t = threading.Thread(target=runner, daemon=True,
                             name=f"fpv-rebuild-{self.config.name}")
        self._rebuild_thread = t
        t.start()

    def wait_for_rebuild(self, timeout: Optional[float] = None) -> bool:
        """Block until any in-flight background rebuild finishes (returns
        False on timeout).  Must NOT be called while holding operations
        open in other threads that could need the collection lock; the
        rebuild's final swap briefly takes it."""
        t = self._rebuild_thread
        if t is None or not t.is_alive():
            return True
        t.join(timeout)
        return not t.is_alive()

    def _tail_exact(self, q: np.ndarray, k: int,
                    mask: Optional[np.ndarray], start: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact scan restricted to rows appended after an index snapshot."""
        count = self._store.count
        tm = np.zeros((count,), dtype=bool)
        tm[start:] = True
        if mask is not None:
            tm[: mask.shape[0]] &= mask
        return self._store.search(
            q, k, self.config.metric, extra_mask=tm,
            compute_dtype=self.config.compute_dtype, topk=self.config.topk)

    # ------------------------------------------------------------------
    # ANN / quantization hooks (implemented in ann/ and quant/)
    # ------------------------------------------------------------------
    # corpora below this size skip build-time auto-tune by default: the
    # exact oracle there is trivially cheap to the caller anyway, and the
    # extra XLA compiles would dominate small-collection workflows
    _AUTOTUNE_MIN_ROWS = 4096

    def _sample_live_queries(self, n: int = 32) -> Optional[np.ndarray]:
        """Strided sample of live corpus rows as a self-query tuning set
        (the recall oracle's queries; spread across the corpus so ordered
        ingests don't bias the sample to the first cluster)."""
        live = self._store.live_rows_host()
        if live.size == 0:
            return None
        take = int(min(n, live.size))
        idx = live[np.linspace(0, live.size - 1, take).astype(np.int64)]
        return np.asarray(self._store.get_rows(idx.astype(np.int64)),
                          dtype=np.float32)

    def build_ann(self, kind: str = "ivf", tune: Optional[bool] = None,
                  tune_target: float = 0.95, tune_queries: int = 32,
                  **kwargs) -> None:
        """Build an approximate index: "ivf" (ann/ivf.py) or "ivfpq"
        (ann/ivfpq.py, ~30x index compression).

        "graph" (ann/graph_ann.py) is accepted for compatibility but
        EXPERIMENTAL and demoted from the advertised kinds: its serial
        beam iterations leave the matrix units idle, and on the GPU it is
        not measured against the exact scan or IVF.  Use "ivf" (low
        latency AND high batch throughput) or "ivfpq" (memory-bound
        regimes) instead.

        By default (``tune=None``) corpora >= 4096 rows auto-tune the
        index's recall knobs (nprobe / rerank / beam) against the exact
        path on a sampled self-query set right after the build — untuned
        defaults can silently serve <=0.74 recall on clustered corpora
        (round-2 crossover measurements). Pass ``tune=False`` to skip."""
        if kind == "graph":
            import warnings
            warnings.warn(
                "build_ann(kind='graph') is experimental: its serial "
                "beam search leaves the matrix units idle; prefer "
                "kind='ivf' "
                "(see ann/graph_ann.py docstring)", stacklevel=2)
        with self._lock:
            if kind == "ivf":
                from ..ann.ivf import IVFIndex
                self._ann = IVFIndex.build(self, **kwargs)
            elif kind == "ivfpq":
                from ..ann.ivfpq import IVFPQIndex
                self._ann = IVFPQIndex.build(self, **kwargs)
            elif kind == "graph":
                from ..ann.graph_ann import GraphANN
                self._ann = GraphANN.build(self, **kwargs)
            else:
                raise ValueError(f"unknown ANN kind {kind!r}")
            # drift-triggered rebuilds must reuse the caller's build
            # parameters (spill_choices, max_cell_factor, iters, ...) —
            # rebuilding with defaults silently regresses recall
            self._ann._build_kwargs = dict(kwargs)
            self.config.index = kind
            # explicit recall knobs are a caller decision — auto-tune
            # (tune=None) must never override them; only opt-in
            # tune=True re-tunes past an explicit setting
            knobs = {"ivf": ("nprobe",), "ivfpq": ("nprobe", "rerank"),
                     "graph": ("beam", "iters")}[kind]
            explicit = any(kwargs.get(kb) is not None for kb in knobs)
            if tune is None:
                tune = (not explicit
                        and self._store.n_valid >= self._AUTOTUNE_MIN_ROWS)
            if tune:
                qs = self._sample_live_queries(tune_queries)
                if qs is not None:
                    if kind == "ivf":
                        self._ann.tune_nprobe(qs, target_recall=tune_target)
                    else:  # ivfpq and graph expose a joint .tune()
                        self._ann.tune(qs, target_recall=tune_target)

    def enable_quantized_scan(self, kind: str = "int8",
                              tune: Optional[bool] = None,
                              tune_target: float = 0.95,
                              tune_queries: int = 32, **kwargs):
        """Build the two-stage quantized scan snapshot.

        By default (``tune=None``) corpora >= 4096 rows run
        ``tune_rerank`` on a sampled self-query set at build time, so the
        serving default re-rank depth clears ``tune_target`` recall@10 —
        the untuned binary default measured 0.50 recall on clustered
        corpora (round-2 verdict #4). Pass ``tune=False`` to skip."""
        from ..quant.scan import QuantizedScan
        with self._lock:
            self._quantized = QuantizedScan.build(self, kind=kind, **kwargs)
            self._quant_kwargs = dict(kwargs)  # for threshold rebuilds
            if tune is None:
                tune = self._store.n_valid >= self._AUTOTUNE_MIN_ROWS
            if tune:
                qs = self._sample_live_queries(tune_queries)
                if qs is not None:
                    self._quantized.tune_rerank(qs, target_recall=tune_target)
            return self._quantized

    def set_search_params(self, **params) -> None:
        """Tune the active ANN index's recall/latency knobs at runtime —
        the reference's ``set_ef_search`` (vectordb_optimized.py:737)
        generalized: IVF accepts ``nprobe``; graph ANN accepts ``beam``,
        ``expand``, ``iters``."""
        with self._lock:
            if self._ann is None:
                raise ValueError("no ANN index built; call build_ann first")
            for key, value in params.items():
                if not hasattr(self._ann, key):
                    raise ValueError(
                        f"{type(self._ann).__name__} has no parameter {key!r}")
                setattr(self._ann, key, int(value))

    def optimize(self, target_recall: float = 0.95, k: int = 10,
                 sample_queries: int = 32, build: bool = True,
                 install: bool = True, serving_batch: int = 256) -> dict:
        """Pick the cheapest serving mode clearing ``target_recall`` on
        sampled self-queries and install it as the default for
        ``search()`` / ``search_batch()`` (explicit ``exact=``/
        ``search_quantized`` calls always override).

        Automates the reference's manual scale ladder (README.md:571-578
        "<100k HNSW · 100k-1M +SQ · ...").  Candidates: the exact scan
        (recall 1.0 by construction), the quantized two-stage scan
        (built with auto-tune if absent and ``build=True``), and any
        already-built ANN index.  Recall is measured against the exact
        float32 oracle.

        Cost ranking: every candidate is timed on the sample queries
        (already compiled and warm from the recall pass), waiting for
        its results with ``block_until_ready``; the fastest eligible
        mode wins.  Bytes alone would misrank modes whose cost is
        compute (IVF-PQ's one-hot ADC streams the fewest bytes), so the
        report also carries each mode's bytes and flops per query from
        core/costmodel.py, amortized over ``serving_batch``.

        Returns a report: ``{mode: {recall, bytes_per_query,
        flops_per_query, us_per_query, eligible}}`` plus ``installed``."""
        from . import costmodel as cm

        def recall_at_k(rows, oracle):
            return float(np.mean([
                len(set(a.tolist()) & set(e.tolist())) / max(len(e), 1)
                for a, e in zip(np.asarray(rows), np.asarray(oracle))]))

        dtype_bytes = {"float32": 4, "bfloat16": 2, "float16": 2}
        with self._lock:
            qs = self._sample_live_queries(sample_queries)
            report: Dict[str, dict] = {}
            runners: Dict[str, object] = {}
            n = max(self._store.n_valid, 1)
            d = self.config.dimensions
            store_b = dtype_bytes.get(self.config.storage_dtype, 4)
            compute_dtype = self.config.compute_dtype

            def work(mc) -> dict:
                return {"bytes_per_query": mc.bytes,
                        "flops_per_query": mc.flops}

            report["exact"] = {
                "recall": 1.0,
                **work(cm.exact_cost(n, d, store_b, serving_batch)),
                "eligible": True}
            if qs is None:
                if install:
                    self._serving_mode = "exact"
                report["installed"] = "exact" if install else None
                return report
            _, oracle = self._store.search(
                qs, k, self.config.metric, compute_dtype="float32",
                topk="exact")
            runners["exact"] = lambda: self._store.search(
                qs, k, self.config.metric, compute_dtype=compute_dtype)

            if self._quantized is None and build and n >= 4096:
                self.enable_quantized_scan("int8",
                                           tune_target=target_recall)
            if self._quantized is not None:
                _, rows = self._quantized_rows(qs, k, None, None)
                rec = recall_at_k(rows, oracle)
                kind = self._quantized.kind
                code_b = {"int8": d, "int4": (d + 1) // 2,
                          "binary": d // 8,
                          "pq": int(self._quantized.codes.shape[-1])}
                rr = getattr(self._quantized, "default_rerank", 4)
                cb = code_b.get(kind, d)
                pq_k = (int(self._quantized.quantizer.k) if kind == "pq"
                        else 16)
                report["quantized"] = {
                    "recall": round(rec, 4),
                    **work(cm.quantized_cost(n, d, kind, cb, store_b,
                                             rr * k, serving_batch,
                                             pq_k=pq_k)),
                    "eligible": rec >= target_recall}
                runners["quantized"] = lambda: self._quantized_rows(
                    qs, k, None, None)
            if self._ann is not None and not self._ann.stale:
                _, rows = self._ann.search(qs, k)
                rec = recall_at_k(rows, oracle)
                st = self._ann.stats() if hasattr(self._ann, "stats") else {}
                nlist = st.get("nlist")
                if nlist:  # IVF family: probed fraction + overflow
                    cell_b = 1 if getattr(self._ann, "quantizer",
                                          None) is not None else store_b
                    pq_k = 0
                    if hasattr(self._ann, "codes"):  # IVF-PQ: M bytes/row
                        cell_b = self._ann.codes.shape[2]
                        pq_k = int(self._ann.codebooks.shape[1])
                    else:
                        cell_b = cell_b * d
                    nprobe = getattr(self._ann, "nprobe", 8)
                    over = int(getattr(self._ann, "overflow_rows",
                                       np.empty(0)).shape[0])
                    rr = getattr(self._ann, "rerank", 0)
                    amc = cm.ivf_cost(n, d, cell_b, nlist, nprobe, over,
                                      store_b, rr * k, serving_batch,
                                      pq_k=pq_k)
                else:  # graph beam search: iters * expand * beam gathers
                    beam = getattr(self._ann, "beam", 128)
                    iters = getattr(self._ann, "iters", 16)
                    expand = getattr(self._ann, "expand", 4)
                    r = getattr(self._ann, "neighbors",
                                np.zeros((0, 32))).shape[1]
                    amc = cm.graph_cost(d, store_b, beam, iters, expand, r)
                report["ann"] = {
                    "recall": round(rec, 4), **work(amc),
                    "eligible": rec >= target_recall}
                runners["ann"] = lambda: self._ann.search(qs, k)

            # every candidate is compiled and warm from the recall pass;
            # the best of three runs ranks it
            import time as _time

            import jax as _jax
            for mode, run in runners.items():
                best_s = float("inf")
                for _ in range(3):
                    t0 = _time.perf_counter()
                    _jax.block_until_ready(run())
                    best_s = min(best_s, _time.perf_counter() - t0)
                report[mode]["us_per_query"] = 1e6 * best_s / max(len(qs), 1)

            eligible = {m: v for m, v in report.items()
                        if isinstance(v, dict) and v.get("eligible")}
            best = min(eligible, key=lambda m: report[m]["us_per_query"])
            if install:
                self._serving_mode = best
            report["installed"] = best if install else None
            return report

    def search_quantized(self, queries, k: int = 10,
                         rerank: Optional[int] = None,
                         filter: Optional[Filter] = None,
                         include_vectors: bool = False
                         ) -> List[List[SearchResult]]:
        """Two-stage compressed scan -> exact re-rank (the reference's hybrid
        pipelines, parallel_search.py:895-947 / benchmark_quantization.py:
        321-362) as two fused device stages."""
        q = as_f32_matrix(queries, self.config.dimensions)
        with self._lock:
            if self._store.n_valid == 0 and self._store.count == 0:
                # mirror search_batch's empty guard: training a quantizer
                # over zero rows raises from a zero-size reduction
                return [[] for _ in range(q.shape[0])]
            dists, rows = self._quantized_rows(q, k, rerank, filter)
            return self._assemble(q, dists, rows, k, include_vectors)

    def search_quantized_arrays(self, queries, k: int = 10,
                                rerank: Optional[int] = None,
                                filter: Optional[Filter] = None):
        """Array-shaped quantized search for high-throughput callers (the
        binary serving path): same fused two-stage dispatch, returning the
        ``(ids, scores, rows)`` triple of ``search_arrays`` with no
        SearchResult construction."""
        q = as_f32_matrix(queries, self.config.dimensions)
        with self._lock:
            b = q.shape[0]
            if self._store.n_valid == 0 and self._store.count == 0:
                return (np.full((b, k), None, dtype=object),
                        np.full((b, k), np.inf, dtype=np.float32),
                        np.full((b, k), -1, dtype=np.int32))
            dists, rows = self._quantized_rows(q, k, rerank, filter)
            return self._arrays_of(dists, rows, k)

    def _quantized_rows(self, q: np.ndarray, k: int,
                        rerank: Optional[int], filter: Optional[Filter]):
        """Shared quantized dispatch -> (dists, rows).  Caller holds the
        lock and has handled the empty-store case."""
        if self._quantized is None:
            self.enable_quantized_scan()
        elif self._index_rebuild_due(self._quantized):
            if self.config.rebuild == "inline":
                # a threshold rebuild must not silently discard the tuned
                # candidate depth (tune_rerank) — recall would collapse
                # back to the untuned default on clustered corpora
                tuned = getattr(self._quantized, "default_rerank", None)
                self.enable_quantized_scan(
                    kind=self._quantized.kind, tune=False,
                    **getattr(self, "_quant_kwargs", {}))
                if tuned is not None:
                    self._quantized.default_rerank = tuned
            else:
                self._spawn_rebuild("quantized")
        mask = self._filter_mask(filter)
        if rerank is None:  # tuned default if set (tune_rerank), else 4
            rerank = getattr(self._quantized, "default_rerank", 4)
        dists, rows = self._quantized.search(q, k, rerank=rerank, mask=mask)
        built = self._quantized.built_count
        if self._store.count > built:
            if rerank <= 1:
                # with no re-rank stage the scan returned COARSE-unit
                # scores (squared L2 for int8, Hamming counts for
                # binary) — rescore exactly before merging against the
                # exact-unit tail distances, or the argsort compares
                # incompatible units and misorders results
                dists = self._exact_rescore(q, dists, rows)
            td, tr = self._tail_exact(q, k, mask, built)
            dists, rows = topk_mod.merge_topk_host(dists, rows, td, tr, k)
        return dists, rows

    def _exact_rescore(self, q: np.ndarray, dists: np.ndarray,
                       rows: np.ndarray) -> np.ndarray:
        """Exact metric distances for (B, k) candidate rows (host BLAS on a
        tiny gather); masked entries stay masked."""
        import jax.numpy as jnp
        from ..kernels.distances import MASKED
        from ..kernels.distances import host_exact_scores
        rows = np.asarray(rows)
        safe = np.maximum(rows, 0)
        cand = np.asarray(jnp.take(self._store.vectors, jnp.asarray(safe),
                                   axis=0), dtype=np.float32)  # (B, k, D)
        out = host_exact_scores(q, cand, self.config.metric)
        bad = (rows < 0) | (np.asarray(dists) >= float(MASKED) * 0.5)
        return np.where(bad, np.inf, out).astype(np.float32)

    # ------------------------------------------------------------------
    # Multi-chip
    # ------------------------------------------------------------------
    def as_sharded_searcher(self, mesh=None):
        """Snapshot this collection into a row-sharded multi-chip searcher
        (dist/sharded.py).  The store's power-of-two capacity divides any
        power-of-two mesh, so the device buffers shard without copies."""
        from ..dist.mesh import make_mesh
        from ..dist.sharded import ShardedSearcher
        with self._lock:
            mesh = mesh or make_mesh()
            return ShardedSearcher(
                mesh, self._store.vectors, self._store.valid,
                metric=self.config.metric,
                compute_dtype=self.config.compute_dtype)

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    def count(self) -> int:
        return self._store.n_valid

    def __len__(self) -> int:
        return self.count()

    def list_ids(self, limit: int = 100, offset: int = 0) -> List[str]:
        with self._lock:
            live = [i for i in self._row_to_id if i is not None]
            return live[offset: offset + limit]

    def all_ids(self) -> List[str]:
        with self._lock:
            return [i for i in self._row_to_id if i is not None]

    def stats(self) -> dict:
        return {
            "name": self.config.name,
            "count": self.count(),
            "allocated_rows": self._store.count,
            "capacity": self._store.capacity,
            "dimensions": self.config.dimensions,
            "metric": self.config.metric.value,
            "index": self.config.index,
            "device_bytes": int(self._store.capacity * self.config.dimensions
                                * np.dtype(self.config.storage_dtype).itemsize),
        }

    # ------------------------------------------------------------------
    # Maintenance
    # ------------------------------------------------------------------
    def compact(self) -> int:
        """Physically remove tombstones; returns rows reclaimed."""
        with self._lock:
            before = self._store.count
            live = self._store.compact()
            old_ids, old_meta = self._row_to_id, self._metadata
            self._row_to_id = [old_ids[r] for r in live]
            self._metadata = [old_meta[r] for r in live]
            self._id_to_row = {i: j for j, i in enumerate(self._row_to_id)}
            self._row_epoch += 1  # rows renumbered: fence out any
            # background rebuild spawned over the old numbering
            self._bump()
            return before - self._store.count

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------
    def save(self) -> None:
        if self.base_path is None:
            raise ValueError("collection has no base_path; cannot save")
        with self._lock:
            self.base_path.mkdir(parents=True, exist_ok=True)
            arrays = self._store.export_arrays()
            sections = {
                "vectors": arrays["vectors"],
                "valid": arrays["valid"],
                "sq": arrays["sq"],
                "ids": self._row_to_id,
                "metadata": self._metadata,
            }
            meta = {"config": self.config.to_dict(), "kind": "collection"}
            if self._serving_mode is not None:
                meta["serving_mode"] = self._serving_mode
            # persist the ANN structure alongside (parity with hnswlib's
            # index.bin, vectordb_optimized.py:306-331)
            if self._ann is not None and not self._ann.stale:
                ann_sections, ann_meta = self._ann.export_sections()
                sections.update(ann_sections)
                meta["ann"] = ann_meta
            # persist the quantized-scan snapshot (codes + quantizer params
            # + tuned rerank) so a reload serves search_quantized without
            # re-training/re-encoding (reference: quantization.py:196-213)
            if self._quantized is not None:
                q_sections, q_meta = self._quantized.export_sections()
                sections.update(q_sections)
                meta["quantized"] = q_meta
            save_container(self.base_path / STORE_FILE, sections, meta=meta)
            if self._wal is not None:
                # the snapshot now covers everything in the log
                self._wal.truncate()

    def _replay_wal(self) -> None:
        """Re-apply logged mutations on top of the loaded snapshot.

        Replay is *forgiving* (inserts upsert, deletes/updates of missing
        ids no-op) so a crash between the snapshot rename and the log
        truncation — which leaves already-snapshotted records in the log —
        converges to the same state instead of erroring on duplicates.
        """
        from ..persist import wal as W
        wal, self._wal = self._wal, None  # suppress re-logging during replay
        try:
            for op, obj, vecs in wal.replay():
                if op == W.OP_INSERT:
                    if not obj["ids"]:
                        continue  # zero-row insert: nothing to re-apply
                    dup = [i for i in obj["ids"] if i in self._id_to_row]
                    if dup:
                        self.delete_batch(dup)
                    self.insert_batch(vecs, obj["ids"], obj["metadatas"])
                elif op == W.OP_DELETE:
                    self.delete_batch(
                        [i for i in obj["ids"] if i in self._id_to_row])
                elif op == W.OP_UPDATE_META:
                    self.update_metadata(obj["id"], obj["metadata"],
                                         obj.get("merge", True))
        finally:
            self._wal = wal

    def _load(self) -> None:
        c = load_container(self.base_path / STORE_FILE)
        cfg = CollectionConfig.from_dict(c.meta["config"])
        self.config = cfg
        vectors = np.asarray(c.read("vectors"), dtype=np.float32)
        valid = np.asarray(c.read("valid"), dtype=bool)
        self._store = DeviceVectorStore.from_arrays(
            vectors, valid, storage_dtype=cfg.storage_dtype,
            sq=c.read("sq") if "sq" in c.sections else None)
        self._row_to_id = list(c.read("ids"))
        self._metadata = list(c.read("metadata"))
        self._id_to_row = {i: r for r, i in enumerate(self._row_to_id)
                           if i is not None and valid[r]}
        self._row_epoch += 1  # row space replaced wholesale
        self._bump()
        self._serving_mode = c.meta.get("serving_mode")
        ann_meta = c.meta.get("ann")
        if ann_meta:
            sections = {k: c.read(k) for k in c.keys()
                        if k.startswith("ann_")}
            if ann_meta["kind"] == "ivf":
                from ..ann.ivf import IVFIndex
                self._ann = IVFIndex.from_sections(self, sections, ann_meta)
            elif ann_meta["kind"] == "ivfpq":
                from ..ann.ivfpq import IVFPQIndex
                self._ann = IVFPQIndex.from_sections(self, sections, ann_meta)
            elif ann_meta["kind"] == "graph":
                from ..ann.graph_ann import GraphANN
                self._ann = GraphANN.from_sections(self, sections, ann_meta)
        q_meta = c.meta.get("quantized")
        if q_meta:
            from ..quant.scan import QuantizedScan
            q_sections = {k: c.read(k) for k in c.keys()
                          if k.startswith("quant_")}
            self._quantized = QuantizedScan.from_sections(
                self, q_sections, q_meta)
