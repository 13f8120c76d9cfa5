"""IVF-Flat ANN index — the accelerator-friendly replacement for HNSW.

The reference delegates ANN to hnswlib's pointer-chasing C++ graph
(vectordb_optimized.py:271-280, 540, 610), which is hostile to a batched
accelerator's execution model (data-dependent traversal, dynamic shapes).  IVF inverts
the structure into fixed shapes the compiler can tile:

  * k-means partitions the corpus into ``nlist`` cells (quant/kmeans.py,
    trained on device) with **capacity-capped balanced assignment** —
    overflow rows spill to their next-nearest cell so the padded layout
    stays dense (an unbalanced padded table blows up both memory and the
    probe gather);
  * cell contents are materialized as a **cell-major (nlist, cmax, D)
    tensor in the serving dtype**, so probing gathers ``nprobe`` whole
    cell blocks per query (hundreds of megabyte-sized contiguous reads)
    instead of hundreds of thousands of scattered rows;
  * a query scores all centroids with one small matmul, gathers its
    probed cells, scores the candidates exactly, and top-ks — every stage
    is a static-shape jitted kernel.

Recall is controlled by ``nprobe`` (and the spill fraction); `tune_nprobe`
picks the cheapest setting that clears a recall target against exact
ground truth, mirroring the reference benchmarks' recall@k oracle
(examples/benchmark_quantization.py:249-259).

Note: the *exact* flat scan is one GEMM over the corpus; IVF pays off for
very large corpora or small query batches, and the crossover has to be
measured on the device.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import DistanceMetric
from ..kernels.distances import MASKED, matmul_precision
from ..quant.kmeans import kmeans_fit
from .ivf_grouped import route_scores

_HIGHEST = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("m", "chunk", "n"))
def _assign_topm(data: jnp.ndarray, centroids: jnp.ndarray, *, m: int,
                 chunk: int = 16384, n: int = None) -> jnp.ndarray:
    """Top-m nearest centroids for the first ``n`` rows, chunked over the
    buffer.  Like kmeans_fit, accepts a capacity-padded buffer directly
    so no full-corpus pad/slice copy is ever materialized (rows past
    ``n`` are computed and discarded — they cost one partial chunk)."""
    if n is None:
        n = data.shape[0]
    nb, d = data.shape
    pad = (-nb) % chunk
    data_p = jnp.pad(data, ((0, pad), (0, 0))) if pad else data
    csq = jnp.einsum("kd,kd->k", centroids, centroids,
                     preferred_element_type=jnp.float32, precision=_HIGHEST)

    def body(_, x):
        dist = csq[None, :] - 2.0 * jnp.dot(
            x, centroids.T, preferred_element_type=jnp.float32,
            precision=_HIGHEST)
        _, idx = jax.lax.top_k(-dist, m)
        return None, idx.astype(jnp.int32)

    _, out = jax.lax.scan(body, None, data_p.reshape(-1, chunk, d))
    return out.reshape(-1, m)[:n]


@functools.partial(jax.jit,
                   static_argnames=("metric", "k", "nprobe", "compute_dtype",
                                    "rerank"))
def _ivf_search_kernel(
    q: jnp.ndarray,            # (B, D) f32
    centroids: jnp.ndarray,    # (nlist, D) f32
    cells: jnp.ndarray,        # (nlist, cmax, D) serving-dtype OR int8 codes
    row_table: jnp.ndarray,    # (nlist, cmax) int32, -1 = padding
    overflow_vecs: jnp.ndarray,  # (O, D) serving dtype (O may be 0)
    overflow_rows: jnp.ndarray,  # (O,) int32
    ok_cells: jnp.ndarray,     # (nlist, cmax) bool — slot live (padding AND
                               #   tombstones AND filter pre-applied)
    ok_overflow: jnp.ndarray,  # (O,) bool — same, for the overflow block
    vmin: jnp.ndarray,         # (D,) f32 — int8 cells only (else zeros)
    scale: jnp.ndarray,        # (D,) f32 — int8 cells only (else ones)
    cell_norms: jnp.ndarray,   # (nlist, cmax) f32 ||x||^2 — int8 cells only
    vectors: Optional[jnp.ndarray] = None,  # (cap, D) store rows — only
                               #   read when rerank > 0 (exact re-rank src)
    *,
    metric: DistanceMetric,
    k: int,
    nprobe: int,
    compute_dtype: str = "bfloat16",
    rerank: int = 0,           # exact re-rank of the top rerank*k (int8
                               #   cells lose ~5-7 recall points to
                               #   quantized ordering without it)
):
    b, d = q.shape
    cmax = cells.shape[1]
    prec = matmul_precision(compute_dtype)
    cd = jnp.dtype(compute_dtype)
    qf = q.astype(jnp.float32)
    # ---- stage 1: route queries to cells ---------------------------------
    croute = route_scores(qf, centroids, metric)
    _, probe = jax.lax.top_k(-croute, nprobe)          # (B, nprobe)

    # ---- stage 2: block-gather probed cells (+ overflow block) and score
    # Scoring uses norm-expansion einsums directly on the serving dtype:
    # an .astype(f32) of the gathered block would materialize a multi-GB
    # copy per dispatch.
    vecs = jnp.take(cells, probe, axis=0)              # (B, nprobe, cmax, D)
    vecs = vecs.reshape(b, nprobe * cmax, d)
    cand = jnp.take(row_table, probe, axis=0).reshape(b, -1)
    # per-slot validity rides the same contiguous cell-row gather — the
    # caller precomputes ok_cells ONCE per validity epoch instead of an
    # element gather from a (cap,) mask here
    ok = jnp.take(ok_cells, probe, axis=0).reshape(b, -1)

    qsq = jnp.einsum("bd,bd->b", qf, qf, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    qinv = 1.0 / jnp.maximum(jnp.sqrt(qsq[:, None]), 1e-30)

    def metric_scores(vsq, cross):
        if metric == DistanceMetric.COSINE:
            rinv = jax.lax.rsqrt(jnp.maximum(vsq, 1e-30))
            return 1.0 - cross * qinv * rinv
        if metric == DistanceMetric.L2:
            return jnp.sqrt(jnp.maximum(qsq[:, None] + vsq - 2.0 * cross,
                                        0.0))
        return -cross

    if cells.dtype == jnp.int8:
        # quantized cells: dequant(c) = (c+128)/255*scale + vmin, so
        #   q . dequant(c) = (q*rs) . c + q . (128*rs + vmin)
        # — the gathered block stays int8 in memory (4x less bandwidth than
        # bf16 cells) and converts inside the fused matmul.  cell_norms
        # are the DEQUANTIZED norms ||x_hat||^2: the distance computed is
        # then exactly ||q - x_hat|| (distance to the perturbed point).
        # Mixing exact norms with the approximate cross term measures
        # ~15 points worse recall — the norm-vs-cross quantization errors
        # stop cancelling.
        rs = scale / 255.0
        qs = qf * rs
        const = jnp.dot(qf, 128.0 * rs + vmin,
                        preferred_element_type=jnp.float32,
                        precision=_HIGHEST)
        cross = jnp.einsum("bd,bcd->bc", qs.astype(cd), vecs,
                           preferred_element_type=jnp.float32,
                           precision=prec) + const[:, None]
        vsq = jnp.take(cell_norms, probe, axis=0).reshape(b, -1)
    else:
        vsq = jnp.einsum("bcd,bcd->bc", vecs, vecs,
                         preferred_element_type=jnp.float32,
                         precision=_HIGHEST)
        cross = jnp.einsum("bd,bcd->bc", qf.astype(cd), vecs,
                           preferred_element_type=jnp.float32,
                           precision=prec)
    s = metric_scores(vsq, cross)

    if overflow_rows.shape[0] > 0:
        # overflow rows fit none of their nearest cells: scan them exactly
        # for every query via a shared 2-D matmul (broadcasting the block
        # per query would materialize (B, O, D))
        ovsq = jnp.einsum("od,od->o", overflow_vecs, overflow_vecs,
                          preferred_element_type=jnp.float32,
                          precision=_HIGHEST)
        ocross = jax.lax.dot_general(
            qf.astype(cd), overflow_vecs,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32, precision=prec)
        s = jnp.concatenate(
            [s, metric_scores(ovsq[None, :], ocross)], axis=1)
        cand = jnp.concatenate(
            [cand, jnp.broadcast_to(overflow_rows[None],
                                    (b, overflow_rows.shape[0]))], axis=1)
        ok = jnp.concatenate(
            [ok, jnp.broadcast_to(ok_overflow[None],
                                  (b, overflow_rows.shape[0]))], axis=1)

    s = jnp.where(ok, s, MASKED)
    if rerank > 0 and vectors is not None:
        # exact-metric re-rank of the quantized top-c (same stage as the
        # grouped kernel / quant/scan two-stage / ivfpq do_rerank)
        c = int(min(max(k, k * rerank), s.shape[1]))
        cneg, cpos = jax.lax.top_k(-s, c)
        crows = jnp.take_along_axis(cand, cpos, axis=1)
        cok = (-cneg < MASKED * 0.5) & (crows >= 0)
        cand_vecs = jnp.take(vectors, jnp.maximum(crows, 0), axis=0)
        from ..quant.scan import _rerank_body
        return _rerank_body(qf, cand_vecs, crows, cok, metric,
                            min(k, c), compute_dtype)
    neg, pos = jax.lax.top_k(-s, k)
    return -neg, jnp.take_along_axis(cand, pos, axis=1)


@functools.partial(jax.jit, static_argnames=("blk",))
def _encode_cells(vectors: jnp.ndarray, safe: jnp.ndarray,
                  vmin: jnp.ndarray, scale: jnp.ndarray, *, blk: int
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Gather + scalar-quantize the cell tensor blockwise:
    (capacity, D) storage-dtype buffer -> ((nlist, cap, D) int8 cells,
    (nlist, cap) f32 dequantized norms) via a lax.scan over cell blocks.

    Never materializes full-capacity int8 codes: at 4M x 768 that would
    add 3.2 GB beside the resident bf16 store (6.4 GB) and the gathered
    cell tensor (4 GB); per-block the transient is a few hundred MB.  Norms are of the DEQUANTIZED rows (encode/decode
    round trip), exactly matching ScalarQuantizer.corpus_stats."""
    from ..quant.scalar import _encode
    nlist, cap = safe.shape
    d = vectors.shape[1]
    pad = (-nlist) % blk
    safe_p = jnp.pad(safe, ((0, pad), (0, 0))) if pad else safe

    def body(_, sb):  # sb: (blk, cap) int32 row ids (padding -> row 0)
        v = jnp.take(vectors, sb.reshape(-1), axis=0)
        c = _encode(v, vmin, scale)                     # (blk*cap, D) int8
        vhat = ((c.astype(jnp.float32) + 128.0) / 255.0 * scale[None, :]
                + vmin[None, :])
        nrm = jnp.einsum("nd,nd->n", vhat, vhat,
                         preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        return None, (c.reshape(blk, cap, d), nrm.reshape(blk, cap))

    _, (cells, norms) = jax.lax.scan(body, None,
                                     safe_p.reshape(-1, blk, cap))
    return (cells.reshape(-1, cap, d)[:nlist],
            norms.reshape(-1, cap)[:nlist])


def _balanced_assignment(topm: np.ndarray, nlist: int, cap: int
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy capacity-capped assignment from per-row top-m cell choices.

    Returns (row_table (nlist, cap) int32 padded with -1, counts (nlist,),
    overflow_rows).  Rows overflowing their nearest cell spill to the
    next-nearest cell with space; rows that fit none of their m choices
    become OVERFLOW — scanned exactly on every query rather than dumped
    into an arbitrary far cell where no probe would ever find them (that
    silently caps recall)."""
    n, m = topm.shape
    counts = np.zeros(nlist, dtype=np.int64)
    table = np.full((nlist, cap), -1, dtype=np.int32)
    # pass 1..m: vectorized-ish greedy by choice rank
    unassigned = np.arange(n, dtype=np.int64)
    for rank in range(m):
        if unassigned.size == 0:
            break
        choice = topm[unassigned, rank].astype(np.int64)
        # process cell by cell so capacity is respected deterministically
        order = np.argsort(choice, kind="stable")
        rows_sorted = unassigned[order]
        cells_sorted = choice[order]
        starts = np.searchsorted(cells_sorted, np.arange(nlist))
        ends = np.searchsorted(cells_sorted, np.arange(nlist) + 1)
        next_unassigned = []
        for c in range(nlist):
            seg = rows_sorted[starts[c]:ends[c]]
            if seg.size == 0:
                continue
            space = cap - counts[c]
            take = seg[:space]
            if take.size:
                table[c, counts[c]: counts[c] + take.size] = take
                counts[c] += take.size
            if seg.size > space:
                next_unassigned.append(seg[space:])
        unassigned = (np.concatenate(next_unassigned)
                      if next_unassigned else np.empty(0, dtype=np.int64))
    return table, counts, unassigned.astype(np.int32)


def ok_slot_masks(index, extra: "Optional[jnp.ndarray | np.ndarray]" = None
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-slot liveness masks ((nlist, cmax) and (O,)) for a cell-table
    index (IVFIndex / IVFPQIndex): slot occupied AND row not tombstoned
    (AND the filter mask when given).

    The base masks are memoized on the IDENTITY of ``store.valid`` /
    ``row_table`` — every store mutation replaces the validity buffer, and
    a rebuild replaces the table — because a per-call
    ``validmask[row_table]`` element gather touches every slot of the
    cell table on every search.

    ``extra`` as a HOST ndarray (a row mask over [0, count), as handed out
    by ``Collection._filter_mask``) gets the same treatment: the filtered
    slot masks are memoized per host-mask identity, so a REPEATED filter
    (tenant / category — the production common case) pays the slot gather
    once per (filter, store-version) instead of per call.  A device-array
    ``extra`` is the uncached legacy path."""
    valid = index._collection._store.valid
    memo = getattr(index, "_ok_memo", None)
    if (memo is None or memo[0] is not valid
            or memo[1] is not index.row_table
            or memo[2] is not index.overflow_rows):
        okc = (index.row_table >= 0) & jnp.take(
            valid, jnp.maximum(index.row_table, 0), axis=0)
        oko = (index.overflow_rows >= 0) & jnp.take(
            valid, jnp.maximum(index.overflow_rows, 0), axis=0)
        memo = (valid, index.row_table, index.overflow_rows, okc, oko)
        index._ok_memo = memo
    okc, oko = memo[3], memo[4]
    if extra is None:
        return okc, oko
    if isinstance(extra, np.ndarray):
        fmemo = getattr(index, "_okf_memo", None)
        key = id(extra)
        if fmemo is not None:
            hit = fmemo.get(key)
            # strong refs inside the memo make id() reuse impossible while
            # the entry lives; validity/table identity guards staleness
            if (hit is not None and hit[0] is extra and hit[1] is valid
                    and hit[2] is index.row_table):
                return hit[3], hit[4]
        m = np.zeros((int(index._collection._store.capacity),), dtype=bool)
        m[: extra.shape[0]] = extra
        dm = jnp.asarray(m)
        okcf = okc & jnp.take(dm, jnp.maximum(index.row_table, 0), axis=0)
        okof = oko & jnp.take(dm, jnp.maximum(index.overflow_rows, 0),
                              axis=0)
        if fmemo is None or len(fmemo) >= 4:  # pin at most 4 filters
            fmemo = {}
            index._okf_memo = fmemo
        fmemo[key] = (extra, valid, index.row_table, okcf, okof)
        return okcf, okof
    okc = okc & jnp.take(extra, jnp.maximum(index.row_table, 0), axis=0)
    oko = oko & jnp.take(extra, jnp.maximum(index.overflow_rows, 0),
                         axis=0)
    return okc, oko


class IVFIndex:
    """Inverted-file flat index over a collection's device store."""

    def __init__(self, centroids: jnp.ndarray, cells: jnp.ndarray,
                 row_table: jnp.ndarray, overflow_vecs: jnp.ndarray,
                 overflow_rows: jnp.ndarray, collection, nprobe: int):
        self.centroids = centroids
        self.cells = cells                # (nlist, cmax, D) serving dtype
        self.row_table = row_table        # (nlist, cmax) int32
        self.overflow_vecs = overflow_vecs  # (O, D) always-scanned block
        self.overflow_rows = overflow_rows  # (O,) int32, -1 = padding
        self._collection = collection
        self.nprobe = nprobe
        self.rerank = 0          # exact re-rank factor (int8 builds set 4)
        self.stale = False
        self._built_count = collection._store.count
        self._built_n_valid = collection._store.n_valid
        self.quantizer = None    # set when cells are int8 codes
        self.cell_norms = None   # (nlist, cmax) f32, int8 cells only

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, collection, nlist: Optional[int] = None,
              nprobe: Optional[int] = None, iters: int = 10,
              seed: int = 0, max_cell_factor: float = 1.5,
              spill_choices: int = 8,
              cell_dtype: Optional[str] = None) -> "IVFIndex":
        """``cell_dtype="int8"`` stores the cell tensor as scalar-quantized
        codes (4x less memory than f32 cells, 2x less than bf16) with exact
        per-row norms — the probe matmul reads int8 and converts in the
        fused dot, so at equal nprobe the scan streams a quarter of the
        bytes.  Default (None) keeps cells in the serving dtype."""
        store = collection._store
        n = store.count
        if n == 0:
            raise ValueError("cannot build IVF index over an empty collection")
        # stay in the STORAGE dtype AND keep the full capacity buffer: an
        # .astype(f32) (15 GB at 5M x 768) or even a [:n] slice /
        # pad-to-chunk copy (6+ GB) of a big store doubles device memory on
        # top of the resident corpus.  kmeans/assignment take the buffer as-is with
        # an explicit n bound; row ids from the balanced assignment are
        # all < n, so cell gathers never touch padding rows.
        vectors = store.vectors
        if nlist is None:
            nlist = int(min(max(int(math.sqrt(n)) * 2, 8), 8192,
                            max(n // 4, 1)))
        nlist = max(1, min(nlist, n))
        if nprobe is None:
            nprobe = max(1, min(nlist, collection.config.ivf_nprobe))
        centroids = kmeans_fit(vectors, jax.random.PRNGKey(seed), k=nlist,
                               iters=iters,
                               chunk=int(min(16384, _pow2_at_least(n))),
                               n=n)
        topm = np.asarray(_assign_topm(vectors, centroids,
                                       m=min(spill_choices, nlist), n=n))
        # capacity rounds to a 128 multiple (a matmul-friendly width);
        # padding rows are masked everywhere via row_table == -1
        cap = int(max(128, -(-int(max_cell_factor * n / nlist) // 128) * 128))
        table, counts, overflow = _balanced_assignment(topm, nlist, cap)
        # cell-major serving-dtype corpus copy: probing becomes a block
        # gather of whole cells instead of a scattered row gather
        dtype = (jnp.bfloat16 if collection.config.compute_dtype == "bfloat16"
                 else jnp.float32)
        safe = jnp.maximum(jnp.asarray(table), 0)
        quant = None
        cell_norms = None
        if cell_dtype == "int8":
            # train + encode fully on device (ScalarQuantizer.encode would
            # round-trip the corpus through the host)
            from ..quant.scalar import ScalarQuantizer, _train
            quant = ScalarQuantizer(dims=int(vectors.shape[1]))
            # strided sample (not the insertion-order prefix): a drifting
            # corpus would otherwise clip rows outside the prefix's range
            step = max(1, n // 200_000)
            sample_idx = jnp.asarray(
                np.arange(0, n, step, dtype=np.int64)[:200_000])
            quant.vmin, quant.scale = _train(
                jnp.take(vectors, sample_idx, axis=0).astype(jnp.float32))
            # blockwise gather+encode straight into cell layout: never
            # materializes full-capacity int8 codes (see _encode_cells)
            # ~100k rows per block: the f32 encode intermediate stays
            # ~300 MB at D=768 regardless of corpus size
            blk = max(1, min(nlist, -(-100_000 // cap)))
            cells, cell_norms = _encode_cells(
                vectors, safe, quant.vmin, quant.scale, blk=blk)
            cell_norms = jnp.where(jnp.asarray(table) >= 0, cell_norms, 0.0)
        else:
            cells = jnp.take(vectors, safe.reshape(-1), axis=0).astype(
                dtype).reshape(nlist, cap, vectors.shape[1])
        opad = (-overflow.size) % 8
        orows = np.concatenate([overflow,
                                np.full(opad, -1, np.int32)]) if             (overflow.size or opad) else overflow
        ovecs = jnp.take(vectors, jnp.maximum(jnp.asarray(orows), 0),
                         axis=0).astype(dtype) if orows.size else             jnp.zeros((0, vectors.shape[1]), dtype)
        idx = cls(centroids, cells, jnp.asarray(table), ovecs,
                  jnp.asarray(orows), collection, nprobe)
        idx._cell_counts = counts
        if quant is not None:
            idx.quantizer = quant
            idx.cell_norms = cell_norms
            # int8 cell scores scramble ordering near the top-k boundary
            # (~5-7 recall points on clustered corpora); a 4x exact
            # re-rank of a small candidate gather recovers it
            idx.rerank = 4
        return idx

    # ------------------------------------------------------------------
    def _ok_cached(self, extra: Optional[jnp.ndarray] = None
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        return ok_slot_masks(self, extra)

    # ------------------------------------------------------------------
    def _cell_norms_cached(self) -> jnp.ndarray:
        """Per-(cell, position) squared row norms, built once and cached.
        int8 builds already store the dequantized norms; serving-dtype
        cells compute them lazily on first grouped dispatch."""
        if self.cell_norms is None:
            self.cell_norms = jnp.where(
                self.row_table >= 0,
                jnp.einsum("ncd,ncd->nc", self.cells, self.cells,
                           preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST), 0.0)
        return self.cell_norms

    def _search_grouped(self, q: np.ndarray, k: int, okc, oko, nprobe: int,
                        qcap: Optional[int] = None, rerank: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Cell-major batched dispatch (ivf_grouped.py): each probed cell
        is read from device memory once per batch and scored against all
        queries probing it in one batched matmul — the large-batch regime
        where the per-query gather would move many times the corpus."""
        from .ivf_grouped import grouped_ivf_search_kernel
        cfg = self._collection.config
        nlist, cmax = self.row_table.shape
        d = self.centroids.shape[1]
        if self.quantizer is not None:
            vmin, scale = self.quantizer.vmin, self.quantizer.scale
        else:
            vmin = jnp.zeros((d,), jnp.float32)
            scale = jnp.ones((d,), jnp.float32)
        cnorms = self._cell_norms_cached()
        # keep the (nlist, qcap, cmax) score tensor under ~2 GB
        qcap_mem = max(8, int((2 << 30) // max(nlist * cmax * 4, 1)))
        sub_max = max(8, (qcap_mem * nlist) // (4 * nprobe) // 8 * 8)
        outs_d, outs_r = [], []
        self.last_dropped = 0
        for s in range(0, q.shape[0], sub_max):
            subq = q[s: s + sub_max]
            real = subq.shape[0]
            pad = (-real) % 8
            if pad:
                subq = np.pad(subq, ((0, pad), (0, 0)))
            # shared heuristic (grouped_qcap): 8x mean-load headroom,
            # pow2, memory-capped; callers can override (tune paths / the
            # no-drop equivalence tests)
            if qcap is None:
                from .ivf_grouped import grouped_qcap
                sub_qcap = grouped_qcap(subq.shape[0], nprobe, nlist, cmax)
            else:
                sub_qcap = min(qcap, qcap_mem)
            dd, rr, dropped = grouped_ivf_search_kernel(
                jnp.asarray(subq), self.centroids, self.cells,
                self.row_table, self.overflow_vecs, self.overflow_rows,
                okc, oko, vmin, scale, cnorms,
                self._collection._store.vectors if rerank > 0 else None,
                metric=cfg.metric, k=min(k, cmax * nprobe), nprobe=nprobe,
                qcap=int(sub_qcap), compute_dtype=cfg.compute_dtype,
                rerank=rerank)
            self.last_dropped += int(dropped)
            outs_d.append(np.asarray(dd)[:real])
            outs_r.append(np.asarray(rr)[:real])
        return np.concatenate(outs_d), np.concatenate(outs_r)

    def search(self, queries: np.ndarray, k: int,
               mask: Optional[np.ndarray] = None, overfetch: int = 1,
               nprobe: Optional[int] = None,
               max_query_batch: int = 64,
               grouped: Optional[bool] = None,
               qcap: Optional[int] = None,
               rerank: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        if self.stale:
            self.__dict__.update(self.rebuilt().__dict__)
        store = self._collection._store
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        nprobe = int(min(nprobe or self.nprobe, self.centroids.shape[0]))
        if mask is not None and overfetch > 1:
            # filtered queries: the mask is fused into candidate scoring,
            # so recall under selective filters is recovered by probing
            # more cells (the IVF analogue of over-fetching)
            nprobe = int(min(self.centroids.shape[0], nprobe * overfetch))
        # pass the HOST mask straight through: ok_slot_masks memoizes the
        # filtered slot gather per (mask identity, store version), and
        # Collection._filter_mask hands out a stable array per fingerprint
        okc, oko = self._ok_cached(
            np.ascontiguousarray(mask, dtype=bool) if mask is not None
            and not isinstance(mask, np.ndarray) else mask)
        cfg = self._collection.config
        # large batches go cell-major: once the per-query gather would
        # move more bytes than the whole cell tensor (b * nprobe >= nlist
        # up to the qcap headroom), reading each cell once and batching
        # its queries is strictly less memory traffic AND one dispatch
        rr = int(self.rerank if rerank is None else rerank)
        if grouped is None:
            grouped = q.shape[0] * nprobe >= self.centroids.shape[0]
        if grouped:
            return self._search_grouped(q, k, okc, oko, nprobe, qcap=qcap,
                                        rerank=rr)
        outs_d, outs_r = [], []
        # bound per-dispatch gather memory: the probe materializes a
        # (b, nprobe, cmax, D) block, so cap the sub-batch such that the
        # gather stays under ~4 GB (B=256/nprobe=32/cmax=752/768-d would
        # otherwise gather 18 GB)
        cmax = self.row_table.shape[1]
        d = self.centroids.shape[1]
        itemsize = self.cells.dtype.itemsize
        per_q = max(nprobe * cmax * d * itemsize, 1)
        safe_b = max(8, int((4 << 30) // per_q) // 8 * 8)
        max_query_batch = int(min(max_query_batch, safe_b))
        for s in range(0, q.shape[0], max_query_batch):
            sub = q[s: s + max_query_batch]
            real = sub.shape[0]
            pad = (-real) % min(max_query_batch, 8)
            if pad:
                sub = np.pad(sub, ((0, pad), (0, 0)))
            if self.quantizer is not None:
                vmin, scale = self.quantizer.vmin, self.quantizer.scale
                cnorms = self.cell_norms
            else:
                dd = self.centroids.shape[1]
                vmin = jnp.zeros((dd,), jnp.float32)
                scale = jnp.ones((dd,), jnp.float32)
                cnorms = jnp.zeros((1, 1), jnp.float32)
            d, r = _ivf_search_kernel(
                jnp.asarray(sub), self.centroids, self.cells, self.row_table,
                self.overflow_vecs, self.overflow_rows, okc, oko,
                vmin, scale, cnorms,
                store.vectors if rr > 0 else None,
                metric=cfg.metric, k=min(k, self.row_table.shape[1] * nprobe),
                nprobe=nprobe, compute_dtype=cfg.compute_dtype, rerank=rr)
            outs_d.append(np.asarray(d)[:real])
            outs_r.append(np.asarray(r)[:real])
        return np.concatenate(outs_d), np.concatenate(outs_r)

    # ------------------------------------------------------------------
    def mark_stale(self) -> None:
        self.stale = True

    def rebuilt(self) -> "IVFIndex":
        """A FRESH index built with this index's recipe over the
        collection's current rows: original build parameters, with
        runtime-tuned knobs (set_search_params nprobe / rerank) carried
        over.  Used by the stale path and by Collection's background
        rebuild — building reads the store lock-free (device buffers are
        immutable; rows appended mid-build serve through the tail merge)."""
        kw = dict(getattr(self, "_build_kwargs", {}))
        kw.setdefault("nlist", self.centroids.shape[0])
        kw["nprobe"] = self.nprobe
        if self.quantizer is not None:
            kw.setdefault("cell_dtype", "int8")
        new = IVFIndex.build(self._collection, **kw)
        new.rerank = self.rerank   # runtime-tuned knob survives
        return new

    def stats(self) -> dict:
        counts = getattr(self, "_cell_counts", None)
        return {
            "kind": "ivf",
            "cell_dtype": str(self.cells.dtype),
            "nlist": int(self.centroids.shape[0]),
            "cmax": int(self.row_table.shape[1]),
            "nprobe": self.nprobe,
            "built_count": self._built_count,
            "cells_bytes": int(self.cells.size * self.cells.dtype.itemsize),
            "overflow_rows": int((np.asarray(self.overflow_rows) >= 0).sum())
            if self.overflow_rows.size else 0,
            "cell_balance": (float(counts.std() / max(counts.mean(), 1e-9))
                             if counts is not None else None),
        }

    # -- persistence ---------------------------------------------------
    def export_sections(self) -> tuple:
        """(sections, meta) for the collection's FPVT container
        (parity: hnswlib's save_index, vectordb_optimized.py:306-331).
        The cell tensor is rebuilt from the row table on load."""
        sections = {"ann_centroids": np.asarray(self.centroids),
                    "ann_row_table": np.asarray(self.row_table),
                    "ann_overflow_rows": np.asarray(self.overflow_rows)}
        meta = {"kind": "ivf", "nprobe": self.nprobe,
                "rerank": self.rerank, "built_count": self._built_count}
        if self.quantizer is not None:
            sections["ann_sq_vmin"] = np.asarray(self.quantizer.vmin)
            sections["ann_sq_scale"] = np.asarray(self.quantizer.scale)
            meta["cell_dtype"] = "int8"
        return sections, meta

    @classmethod
    def from_sections(cls, collection, sections: dict, meta: dict
                      ) -> "IVFIndex":
        centroids = jnp.asarray(np.asarray(sections["ann_centroids"]))
        table = jnp.asarray(np.asarray(sections["ann_row_table"]))
        orows = jnp.asarray(np.asarray(sections.get(
            "ann_overflow_rows", np.zeros(0, np.int32))))
        store = collection._store
        dtype = (jnp.bfloat16 if collection.config.compute_dtype == "bfloat16"
                 else jnp.float32)
        safe = jnp.maximum(table, 0)
        quant = None
        cell_norms = None
        if meta.get("cell_dtype") == "int8":
            # re-encode through the persisted quantizer params (the code
            # tensor is deterministic given vmin/scale + the store rows)
            from ..quant.scalar import ScalarQuantizer, _encode
            quant = ScalarQuantizer()
            quant.vmin = jnp.asarray(np.asarray(sections["ann_sq_vmin"]))
            quant.scale = jnp.asarray(np.asarray(sections["ann_sq_scale"]))
            quant.dims = int(quant.vmin.shape[0])
            vec32 = store.vectors.astype(jnp.float32)
            codes = _encode(vec32, quant.vmin, quant.scale)
            cells = jnp.take(codes, safe.reshape(-1), axis=0).reshape(
                table.shape[0], table.shape[1], -1)
            row_norms, _ = quant.corpus_stats(codes)  # ||x_hat||^2
            cell_norms = jnp.where(
                table >= 0,
                jnp.take(row_norms, safe.reshape(-1), axis=0).reshape(
                    table.shape[0], table.shape[1]), 0.0)
        else:
            cells = jnp.take(store.vectors, safe.reshape(-1), axis=0).astype(
                dtype).reshape(table.shape[0], table.shape[1], -1)
        ovecs = jnp.take(store.vectors, jnp.maximum(orows, 0),
                         axis=0).astype(dtype) if orows.size else \
            jnp.zeros((0, store.vectors.shape[1]), dtype)
        idx = cls(centroids, cells, table, ovecs, orows, collection,
                  int(meta["nprobe"]))
        if quant is not None:
            idx.quantizer = quant
            idx.cell_norms = cell_norms
        # older containers predate the rerank knob: default to the build
        # default for their cell dtype (int8 -> 4, serving dtype -> 0)
        idx.rerank = int(meta.get("rerank", 4 if quant is not None else 0))
        idx._built_count = int(meta["built_count"])
        # growth past built_count is served by the collection's tail merge;
        # only an impossible shrink (container mismatch) forces a rebuild
        idx.stale = idx._built_count > collection._store.count
        return idx

    def tune_nprobe(self, queries: np.ndarray, target_recall: float = 0.95,
                    k: int = 10, max_nprobe: Optional[int] = None) -> int:
        """Find the smallest nprobe whose recall@k vs the exact path clears
        ``target_recall`` on the given query sample; sets and returns it."""
        store = self._collection._store
        cfg = self._collection.config
        exact_d, exact_r = store.search(queries, k, cfg.metric,
                                        compute_dtype=cfg.compute_dtype)
        limit = max_nprobe or self.centroids.shape[0]
        nprobe = max(1, self.nprobe // 4)
        while nprobe <= limit:
            _, r = self.search(queries, k, nprobe=nprobe)
            hits = np.mean([
                len(set(a.tolist()) & set(e.tolist())) / k
                for a, e in zip(r, exact_r)])
            if hits >= target_recall:
                self.nprobe = nprobe
                return nprobe
            nprobe *= 2
        self.nprobe = limit
        return limit


from ..utils import next_pow2 as _pow2_at_least  # shared helper
