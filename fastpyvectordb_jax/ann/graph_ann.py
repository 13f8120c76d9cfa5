"""Graph ANN: fixed-degree neighbor array + batched device beam search.

This is the device-side replacement for hnswlib's HNSW
(vectordb_optimized.py:271-280): instead of a C++ pointer-chasing
multi-layer graph, the index is a flat ``(N, R)`` int32 neighbor table and
search is a *batched, fixed-shape* best-first beam search compiled by XLA:

  * **Build runs on the device.**  The R-NN graph is computed exactly
    with chunked distance matmuls + top-k (build time on the GPU: not
    measured).  Reverse and pseudo-random long-range links keep
    every node reachable, and each query routes to its own entry points
    through k-means centroid medoids (flat graphs with global entries are
    un-navigable in a few iterations at 1M+ nodes).
  * **Search is data-parallel over queries.**  Each iteration expands the
    E best not-yet-expanded beam entries (gather their neighbor lists,
    one fused distance matmul for all B queries), merges candidates into
    the beam, and deduplicates by sorting on node id — the visited-set
    semantics of HNSW expressed in static shapes (duplicate entries get
    their score forced to +inf; the expanded flag survives the sort by
    riding a composite sort key).

Recall is controlled by (beam width W, expansion width E, iterations T);
`tune` picks the cheapest setting clearing a recall target against the
exact path, mirroring ann/ivf.py.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import DistanceMetric
from ..kernels.distances import MASKED, matmul_precision
from ..quant.kmeans import kmeans_fit

INVALID = jnp.int32(2_147_483_647)  # sentinel id sorting after all real ids


def _scores_vs_rows(q, vecs, metric, compute_dtype):
    """q (B, D) f32, vecs (B, C, D) any dtype -> (B, C) scores (lower=closer).

    Norm-expansion form: no elementwise (B, C, D) temporaries (an
    .astype / diff would materialize a full copy of the gathered block).
    """
    prec = matmul_precision(compute_dtype)
    cd = jnp.dtype(compute_dtype)
    qf = q.astype(jnp.float32)
    vsq = jnp.einsum("bcd,bcd->bc", vecs, vecs,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    cross = jnp.einsum("bd,bcd->bc", qf.astype(cd), vecs.astype(cd),
                       preferred_element_type=jnp.float32, precision=prec)
    if metric == DistanceMetric.COSINE:
        qinv = 1.0 / jnp.maximum(jnp.linalg.norm(qf, axis=1, keepdims=True),
                                 1e-30)
        rinv = jax.lax.rsqrt(jnp.maximum(vsq, 1e-30))
        return 1.0 - cross * qinv * rinv
    if metric == DistanceMetric.L2:
        qsq = jnp.einsum("bd,bd->b", qf, qf,
                         preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        return jnp.maximum(qsq[:, None] + vsq - 2.0 * cross, 0.0)
    return -cross


@functools.partial(
    jax.jit, static_argnames=("metric", "k", "beam", "expand", "iters",
                              "n_init", "compute_dtype"))
def _beam_search_kernel(
    q: jnp.ndarray,            # (B, D) f32
    vectors: jnp.ndarray,      # (cap, D)
    neighbors: jnp.ndarray,    # (N, R) int32
    centroids: jnp.ndarray,    # (n_e, D) f32 routing centroids
    medoids: jnp.ndarray,      # (n_e,) int32 rows nearest each centroid
    init_ok: jnp.ndarray,      # (n_e,) bool — medoid row live (callers
                               #   pre-mask deleted NEIGHBOR targets to -1
                               #   in the neighbor table itself instead of
                               #   a per-call validmask[rows] gather)
    filtermask: Optional[jnp.ndarray],  # (cap,) bool filter, or None
    *,
    metric: DistanceMetric,
    k: int,
    beam: int = 64,
    expand: int = 4,
    iters: int = 12,
    n_init: int = 16,
    compute_dtype: str = "bfloat16",
):
    b, d = q.shape
    r = neighbors.shape[1]
    w = beam

    def gather_scores(rows):  # rows (B, C) int32 -> (B, C) f32
        safe = jnp.maximum(rows, 0)
        vecs = jnp.take(vectors, safe, axis=0)  # native storage dtype
        s = _scores_vs_rows(q, vecs, metric, compute_dtype)
        # tombstoned targets are already -1 in the neighbor table
        return jnp.where(rows >= 0, s, MASKED)

    # ---- route each query to its own entry points ----------------------
    # A flat graph with a handful of global entries can't be navigated in
    # a few beam iterations at 1M+ nodes; routing via k-means centroids
    # starts every query inside its own neighborhood (the DiskANN-medoid /
    # SPANN idea).
    prec = matmul_precision(compute_dtype)
    qf = q.astype(jnp.float32)
    if metric == DistanceMetric.COSINE:
        qn = qf / jnp.maximum(jnp.linalg.norm(qf, axis=1, keepdims=True),
                              1e-30)
        cn = centroids / jnp.maximum(
            jnp.linalg.norm(centroids, axis=1, keepdims=True), 1e-30)
        croute = -jnp.dot(qn, cn.T, preferred_element_type=jnp.float32,
                          precision=prec)
    elif metric == DistanceMetric.DOT:
        croute = -jnp.dot(qf, centroids.T,
                          preferred_element_type=jnp.float32, precision=prec)
    else:
        csq = jnp.einsum("kd,kd->k", centroids, centroids,
                         preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        croute = csq[None, :] - 2.0 * jnp.dot(
            qf, centroids.T, preferred_element_type=jnp.float32,
            precision=prec)
    e0 = min(n_init, w, medoids.shape[0])
    _, route = jax.lax.top_k(-croute, e0)               # (B, e0)
    init_ids = jnp.take(medoids, route, axis=0)         # (B, e0)
    init_scores = jnp.where(jnp.take(init_ok, route, axis=0),
                            gather_scores(init_ids), MASKED)
    pad = w - e0
    beam_ids = jnp.pad(init_ids, ((0, 0), (0, pad)), constant_values=-1)
    beam_scores = jnp.pad(init_scores, ((0, 0), (0, pad)),
                          constant_values=MASKED)
    beam_exp = jnp.zeros((b, w), dtype=bool)

    def body(state, _):
        ids, scores_, expanded = state
        # pick the E best unexpanded entries
        sel_scores = jnp.where(expanded | (ids < 0), MASKED, scores_)
        _, pos = jax.lax.top_k(-sel_scores, expand)          # (B, E)
        exp_ids = jnp.take_along_axis(ids, pos, axis=1)      # (B, E)
        # mark them expanded (scatter along axis 1 via one-hot OR)
        onehot = jax.nn.one_hot(pos, w, dtype=jnp.bool_)      # (B, E, W)
        expanded = expanded | jnp.any(onehot, axis=1)
        # gather neighbor lists; invalid expansion rows contribute nothing
        safe = jnp.maximum(exp_ids, 0)
        cand = jnp.take(neighbors, safe, axis=0).reshape(b, expand * r)
        cand = jnp.where(
            jnp.repeat(exp_ids < 0, r, axis=1), jnp.int32(-1), cand)
        cand_scores = gather_scores(cand)
        # merge beam + candidates
        all_ids = jnp.concatenate([ids, cand], axis=1)
        all_scores = jnp.concatenate([scores_, cand_scores], axis=1)
        all_exp = jnp.concatenate(
            [expanded, jnp.zeros((b, expand * r), dtype=bool)], axis=1)
        # dedup by id: composite key = 2*id + (1 - expanded) so the
        # expanded copy of a node sorts first and survives.  Keys stay in
        # int32 range: ids < N, invalid = 2N+2 (x64 is disabled in JAX).
        n_limit = jnp.int32(neighbors.shape[0])
        real = (all_ids >= 0) & (all_scores < MASKED * 0.5)
        id_key = jnp.where(real, all_ids * 2 + (1 - all_exp.astype(jnp.int32)),
                           n_limit * 2 + 2)
        order = jnp.argsort(id_key, axis=1)
        s_ids = jnp.take_along_axis(all_ids, order, axis=1)
        s_scores = jnp.take_along_axis(all_scores, order, axis=1)
        s_exp = jnp.take_along_axis(all_exp, order, axis=1)
        dup = jnp.concatenate(
            [jnp.zeros((b, 1), dtype=bool), s_ids[:, 1:] == s_ids[:, :-1]],
            axis=1)
        s_scores = jnp.where(dup, MASKED, s_scores)
        # keep best W by score
        _, keep = jax.lax.top_k(-s_scores, w)
        new_ids = jnp.take_along_axis(s_ids, keep, axis=1)
        new_scores = jnp.take_along_axis(s_scores, keep, axis=1)
        new_exp = jnp.take_along_axis(s_exp, keep, axis=1)
        new_ids = jnp.where(new_scores >= MASKED * 0.5, -1, new_ids)
        return (new_ids, new_scores, new_exp), None

    (beam_ids, beam_scores, beam_exp), _ = jax.lax.scan(
        body, (beam_ids, beam_scores, beam_exp), None, length=iters)

    if filtermask is not None:
        # Post-navigation filtering: the beam navigates the full graph
        # (a mask fused into navigation scores would make filtered-out
        # regions impassable and collapse recall); only the final selection
        # over the W beam entries applies the filter.
        fok = ((beam_ids >= 0)
               & jnp.take(filtermask, jnp.maximum(beam_ids, 0), axis=0))
        beam_scores = jnp.where(fok, beam_scores, MASKED)
    _, pos = jax.lax.top_k(-beam_scores, min(k, w))
    out_ids = jnp.take_along_axis(beam_ids, pos, axis=1)
    out_scores = jnp.take_along_axis(beam_scores, pos, axis=1)
    if metric == DistanceMetric.L2:
        out_scores = jnp.where(out_scores >= MASKED * 0.5, out_scores,
                               jnp.sqrt(jnp.maximum(out_scores, 0.0)))
    return out_scores, out_ids


@functools.partial(jax.jit, static_argnames=("r", "chunk", "n_static"))
def _knn_graph_chunk(vectors, sq_norms, start, *, r: int, chunk: int,
                     n_static: int):
    """Exact R-NN of rows [start, start+chunk) against the full corpus."""
    block = jax.lax.dynamic_slice(vectors, (start, 0),
                                  (chunk, vectors.shape[1]))
    bsq = jax.lax.dynamic_slice(sq_norms, (start,), (chunk,))
    d2 = (bsq[:, None] + sq_norms[None, :]
          - 2.0 * jnp.dot(block.astype(jnp.bfloat16),
                          vectors.astype(jnp.bfloat16).T,
                          preferred_element_type=jnp.float32))
    # exclude self: rows index == start + i
    row_ids = jax.lax.broadcasted_iota(jnp.int32, (chunk, 1), 0) + start
    col_ids = jax.lax.broadcasted_iota(jnp.int32, (1, n_static), 1)
    d2 = jnp.where(col_ids == row_ids, MASKED, d2)
    if n_static > 65536:
        # 0.99 recall target inflates the approx-reduction intermediates
        # enough to OOM at (8192, 1M); 0.95 edges are fine in practice
        neg, idx = jax.lax.approx_max_k(-d2, r, recall_target=0.95)
    else:
        neg, idx = jax.lax.top_k(-d2, r)
    return idx.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("chunk",))
def _snap_medoids(vectors, sqn, cents, chunk: int = 256):
    """Nearest corpus row per centroid, chunked over centroids — the full
    (n_entries, N) distance matrix would be GBs at large entry counts."""
    k = cents.shape[0]
    pad = (-k) % chunk
    cents_p = jnp.pad(cents, ((0, pad), (0, 0))) if pad else cents

    def body(_, cc):
        d2 = (jnp.einsum("kd,kd->k", cc, cc,
                         preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)[:, None]
              + sqn[None, :]
              - 2.0 * jnp.dot(cc, vectors.T,
                              preferred_element_type=jnp.float32,
                              precision=jax.lax.Precision.HIGHEST))
        return None, jnp.argmin(d2, axis=1).astype(jnp.int32)

    _, out = jax.lax.scan(body, None,
                          cents_p.reshape(-1, chunk, cents.shape[1]))
    return out.reshape(-1)[:k]


class GraphANN:
    """Neighbor-array ANN index over a collection's device store."""

    def __init__(self, neighbors: jnp.ndarray, centroids: jnp.ndarray,
                 medoids: jnp.ndarray, collection, beam: int = 128,
                 expand: int = 8, iters: int = 16, n_init: int = 32):
        self.neighbors = neighbors
        self.centroids = centroids     # (n_e, D) routing centroids
        self.medoids = medoids         # (n_e,) rows nearest each centroid
        self._collection = collection
        self.beam, self.expand, self.iters = beam, expand, iters
        self.n_init = n_init
        self.stale = False
        self._built_count = collection._store.count
        self._built_n_valid = collection._store.n_valid

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, collection, r: int = 32, n_entries: int = 4096,
              random_links: int = 4, seed: int = 0, chunk: int = 4096,
              **search_params) -> "GraphANN":
        """Exact R-NN graph on device + random long-range links + medoid
        entry points.  Memory parity with hnswlib M=16 (2M level-0 links)."""
        store = collection._store
        n = store.count
        if n == 0:
            raise ValueError("cannot build GraphANN over an empty collection")
        metric = collection.config.metric
        if metric == DistanceMetric.DOT:
            raise ValueError(
                "graph ANN does not support dot-product (MIPS) "
                "collections: the L2 edge graph excludes the high-norm "
                "rows inner-product search needs — use kind='ivf' or the "
                "int8 quantized scan for dot metrics")
        vectors = store.vectors[:n].astype(jnp.float32)
        if metric == DistanceMetric.COSINE:
            # edges must follow the SEARCH metric: L2-KNN over the raw
            # vectors drifts from cosine neighborhoods when rows are
            # unnormalized — build the graph over unit vectors (same
            # ordering as cosine); search still scores the real store
            vectors = vectors / jnp.maximum(
                jnp.linalg.norm(vectors, axis=1, keepdims=True), 1e-30)
        sqn = jnp.einsum("nd,nd->n", vectors, vectors,
                         preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        chunk = int(min(chunk, n))
        # half the degree budget goes to forward KNN links; the rest to
        # reverse links (every node gets in-edges — a directed exact-KNN
        # graph leaves outliers unreachable; HNSW gets this from its
        # bidirectional insertion) and pseudo-random long-range links.
        knn = max(r // 2, r - random_links - r // 4) if n > r * 4 else r
        # tiny collections: top_k k cannot exceed the corpus size
        # (excluding self), and fill/reverse links need n >= 2
        knn = max(1, min(knn, n - 1)) if n > 1 else 1
        parts = []
        for start in range(0, n, chunk):
            s = min(start, max(n - chunk, 0))  # overlap final ragged chunk
            parts.append((s, _knn_graph_chunk(vectors, sqn, jnp.int32(s),
                                              r=knn, chunk=chunk,
                                              n_static=n)))
        fwd = np.empty((n, knn), dtype=np.int32)
        for s, idx in parts:
            fwd[s:s + chunk] = np.asarray(idx)
        tbl = fwd
        if knn < r:
            rng = np.random.default_rng(seed)
            extra = r - knn
            fill = np.empty((n, extra), dtype=np.int32)
            # self-loop-free random fill as the default
            offs = rng.integers(1, n, (n, extra), dtype=np.int64)
            fill[:] = ((np.arange(n, dtype=np.int64)[:, None] + offs)
                       % n).astype(np.int32)
            # reverse edges, vectorized: for each forward edge u->v give v
            # up to `extra` slots pointing back at u (random subset)
            srcs = np.repeat(np.arange(n, dtype=np.int64), knn)
            dsts = fwd.reshape(-1).astype(np.int64)
            perm = rng.permutation(srcs.size)
            srcs, dsts = srcs[perm], dsts[perm]
            order = np.argsort(dsts, kind="stable")
            dsts_s, srcs_s = dsts[order], srcs[order]
            grp_start = np.searchsorted(dsts_s, np.arange(n))
            pos = np.arange(dsts_s.size) - grp_start[dsts_s]
            sel = pos < extra
            fill[dsts_s[sel], pos[sel]] = srcs_s[sel]
            tbl = np.concatenate([fwd, fill], axis=1)
        # per-query routing structure: k-means centroids + medoid rows
        # (cap at n/8 so small collections don't degenerate into k = n)
        n_entries = max(1, min(n_entries, max(16, n // 8)))
        cents = kmeans_fit(vectors, jax.random.PRNGKey(seed), k=n_entries,
                           iters=5, chunk=int(min(16384, n)))
        medoids = _snap_medoids(vectors, sqn, cents)
        return cls(jnp.asarray(tbl), cents, medoids, collection,
                   **search_params)

    # ------------------------------------------------------------------
    def search(self, queries: np.ndarray, k: int,
               mask: Optional[np.ndarray] = None, overfetch: int = 1,
               beam: Optional[int] = None, iters: Optional[int] = None,
               expand: Optional[int] = None, n_init: Optional[int] = None,
               device_out: bool = False
               ) -> Tuple[np.ndarray, np.ndarray]:
        if self.stale:
            self.__dict__.update(self.rebuilt().__dict__)
        store = self._collection._store
        cfg = self._collection.config
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        b = q.shape[0]
        bp = max(8, 1 << (b - 1).bit_length())
        qp = np.pad(q, ((0, bp - b), (0, 0)))
        # tombstone navigation masks, memoized per validity epoch: deleted
        # neighbor targets become -1 in the table (identical semantics to
        # a per-call validmask[rows] element gather, without paying it on
        # every search)
        valid = store.valid
        memo = getattr(self, "_nav_memo", None)
        if (memo is None or memo[0] is not valid
                or memo[1] is not self.neighbors):
            ok_n = (self.neighbors >= 0) & jnp.take(
                valid, jnp.maximum(self.neighbors, 0), axis=0)
            nbr_masked = jnp.where(ok_n, self.neighbors, -1)
            init_ok = (self.medoids >= 0) & jnp.take(
                valid, jnp.maximum(self.medoids, 0), axis=0)
            memo = (valid, self.neighbors, nbr_masked, init_ok)
            self._nav_memo = memo
        nbr_masked, init_ok = memo[2], memo[3]
        filtermask = None
        # None-checks, not `or`: an explicit 0 override (sweeps measuring
        # the no-routing / no-expansion corner) must not silently fall
        # back to the built defaults
        w = self.beam if beam is None else beam
        expand = self.expand if expand is None else expand
        iters = self.iters if iters is None else iters
        n_init = self.n_init if n_init is None else n_init
        if mask is not None:
            m = np.zeros((store.capacity,), dtype=bool)
            m[: mask.shape[0]] = mask
            filtermask = jnp.asarray(m)
            # post-filter semantics need headroom: widen the beam so up to
            # k*overfetch filtered survivors fit among the W beam entries
            want = max(k * max(overfetch, 1), w)
            w = min(512, 1 << (want - 1).bit_length()) if want > w else w
        if k > w:
            # the kernel returns min(k, beam) columns — without widening,
            # an unfiltered k=200 search on a beam-128 index silently
            # returned 128 hits.  Preserve the filter-overfetch margin in
            # this path too: a filtered large-k search must still carry
            # k*overfetch candidate headroom.  No cap: a very large k
            # costs beam-state memory, never silent truncation.
            want = k if filtermask is None else k * max(overfetch, 1)
            w = 1 << (want - 1).bit_length()
        vals, rows = _beam_search_kernel(
            jnp.asarray(qp), store.vectors, nbr_masked, self.centroids,
            self.medoids, init_ok, filtermask, metric=cfg.metric, k=k,
            beam=w, expand=expand, iters=iters, n_init=n_init,
            compute_dtype="bfloat16" if cfg.compute_dtype == "bfloat16"
            else "float32")
        if device_out:
            # keep results on device: the caller decides when to pay the
            # host fetch
            return vals[:b], rows[:b]
        return np.asarray(vals)[:b], np.asarray(rows)[:b]

    def mark_stale(self) -> None:
        self.stale = True

    def rebuilt(self) -> "GraphANN":
        """A fresh index built with this index's recipe (build kwargs +
        runtime-tuned beam/expand/iters/n_init) over the collection's
        current rows; shared by the stale path and Collection's
        background rebuild."""
        kw = dict(getattr(self, "_build_kwargs", {}))
        kw.setdefault("r", self.neighbors.shape[1])
        kw.setdefault("n_entries", self.medoids.shape[0])
        kw.update(beam=self.beam, expand=self.expand,
                  iters=self.iters, n_init=self.n_init)
        return GraphANN.build(self._collection, **kw)

    def stats(self) -> dict:
        n, r = self.neighbors.shape
        return {"kind": "graph", "nodes": n, "degree": r,
                "entries": int(self.medoids.shape[0]),
                "n_init": self.n_init,
                "beam": self.beam, "expand": self.expand,
                "iters": self.iters,
                "graph_bytes": int(n * r * 4)}

    # -- persistence ---------------------------------------------------
    def export_sections(self) -> tuple:
        return ({"ann_neighbors": np.asarray(self.neighbors),
                 "ann_centroids": np.asarray(self.centroids),
                 "ann_medoids": np.asarray(self.medoids)},
                {"kind": "graph", "beam": self.beam, "expand": self.expand,
                 "iters": self.iters, "n_init": self.n_init,
                 "built_count": self._built_count})

    @classmethod
    def from_sections(cls, collection, sections: dict, meta: dict
                      ) -> "GraphANN":
        idx = cls(jnp.asarray(np.asarray(sections["ann_neighbors"])),
                  jnp.asarray(np.asarray(sections["ann_centroids"])),
                  jnp.asarray(np.asarray(sections["ann_medoids"])),
                  collection, beam=int(meta["beam"]),
                  expand=int(meta["expand"]), iters=int(meta["iters"]),
                  n_init=int(meta.get("n_init", 16)))
        idx._built_count = int(meta["built_count"])
        # growth past built_count is served by the collection's tail merge;
        # only an impossible shrink (container mismatch) forces a rebuild
        idx.stale = idx._built_count > collection._store.count
        return idx

    def tune(self, queries: np.ndarray, target_recall: float = 0.95,
             k: int = 10) -> dict:
        """Smallest (beam, iters) clearing the recall target on a sample."""
        store = self._collection._store
        cfg = self._collection.config
        _, exact_rows = store.search(queries, k, cfg.metric,
                                     compute_dtype=cfg.compute_dtype)
        for beam in (32, 64, 128, 256):
            for iters in (8, 16, 32):
                _, rows = self.search(queries, k, beam=beam, iters=iters)
                rec = np.mean([
                    len(set(a.tolist()) & set(e.tolist())) / k
                    for a, e in zip(rows, exact_rows)])
                if rec >= target_recall:
                    self.beam, self.iters = beam, iters
                    return {"beam": beam, "iters": iters,
                            "recall": float(rec)}
        return {"beam": self.beam, "iters": self.iters, "recall": float(rec)}
