"""Grouped (cell-major) batched IVF search — the large-batch dispatch.

The baseline IVF kernel (ivf.py:_ivf_search_kernel) gathers a
``(B, nprobe, cmax, D)`` per-query block: every query drags private
copies of its probed cells through device memory, so at B=1024/nprobe=16 the
gather alone moves ~50x the corpus and the batch has to be chopped into
memory-bounded sub-batches (reference analogue: the hnswlib per-query
walk, vectordb_optimized.py:598-610, which has no batch dimension at
all).

This module flips the dispatch to CELL-major, which is the natural matmul
shape: invert the (query -> probed cells) relation into a per-cell
query-slot table with one sort, then score every cell against the
queries probing it in ONE batched ``dot_general`` over the cell tensor:

    (nlist, qcap, D) x (nlist, cmax, D) -> (nlist, qcap, cmax)

Each cell's block is read from device memory exactly once per batch regardless of
how many queries probe it, total matmul work is proportional to the
probed fraction of the corpus, and every shape is static (qcap is a
capacity knob, not a data-dependent size).  The whole pipeline —
route -> invert (sort + segmented rank) -> gather query slots ->
batched matmul -> per-slot top-k -> regroup per query -> merge with the
overflow scan — is a single jitted dispatch with no host round-trips.

Probe-priority under saturation: pairs are sorted by (cell, probe-rank),
so when a popular cell overflows ``qcap`` it sheds its *spill* probes
(high probe-rank) first; a query's primary cells always land slots
before any query's secondary ones at equal load.  The kernel also
returns the number of dropped pairs so callers can observe saturation.

Candidate-set equivalence: with ``qcap`` large enough that nothing is
dropped, per-slot exact top-k(k) + per-query merge selects exactly the
same rows as the baseline kernel's flat top-k over all probed cells
(cells partition the corpus, so a row is scored by at most one probe of
a given query).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..core.types import DistanceMetric
from ..kernels.distances import MASKED, matmul_precision

__all__ = ["grouped_ivf_search_kernel", "grouped_cell_candidates",
           "grouped_qcap", "invert_pairs", "finish_grouped", "route_scores"]

_HIGHEST = jax.lax.Precision.HIGHEST


def grouped_qcap(b: int, nprobe: int, nlist: int, cmax: int,
                 headroom: int = 8, budget_bytes: int = 2 << 30) -> int:
    """Per-cell query-slot capacity for the grouped dispatch: pow2 (so it
    doesn't churn compiles), ``headroom``x the mean cell load (hot cells
    under clustered query skew), capped so the (nlist, qcap, cmax) f32
    score tensor stays under ``budget_bytes``.  Shared by the single-chip
    auto-dispatch, the sharded in-shard dispatch, and bench.py."""
    qcap_mem = max(8, int(budget_bytes // max(nlist * cmax * 4, 1))
                   // 8 * 8)
    qcap = 8
    while qcap < min(headroom * b * nprobe / max(nlist, 1), b, qcap_mem):
        qcap *= 2
    return int(min(qcap, qcap_mem))


def invert_pairs(probe: jnp.ndarray, nlist: int, qcap: int) -> dict:
    """Invert the (query -> probed cells) relation into cell-major
    query-slot tables — the shared stage 2 of every grouped dispatch
    (bf16/int8 cells here; PQ codes in ann/ivfpq.py).

    ``probe`` is (B, nprobe) int32 cell ids, probe-rank minor.  One sort
    orders the B*nprobe pairs cell-major; a segmented rank gives each
    pair its slot within its cell's run; ranks past ``qcap`` are shed
    (probe-priority: a cell over capacity drops its highest probe-ranks
    first, because the sort key is (cell, probe-rank)).

    Returns a dict with both layouts:
      flat_cell (M,)   pair cell ids in ORIGINAL (B-major) order
      flat_q    (M,)   pair query ids, original order
      pair_rank (M,)   pair's slot rank within its cell
      pair_keep (M,)   pair survived qcap saturation
      dropped   ()     int32 count of shed pairs
      qslot     (nlist, qcap) query id per slot, -1 = empty
      slot_q    (nlist, qcap) same, clamped to 0 for safe gathers
      compact   (U,)   the batch's probed cell ids, unique, ascending;
                       entries past the unique count alias cell 0
                       (U = min(nlist, M))
      slot_qc   (U, qcap) query id per compact slot, clamped to 0
      cid_pair  (M,)   pair -> compact row index, original order
    """
    b, nprobe = probe.shape
    m = b * nprobe
    flat_cell = probe.reshape(-1).astype(jnp.int32)     # (M,)
    flat_q = jnp.repeat(jnp.arange(b, dtype=jnp.int32), nprobe)
    prank = jnp.tile(jnp.arange(nprobe, dtype=jnp.int32), b)
    order = jnp.argsort(flat_cell * nprobe + prank)     # cell-major,
    scell = flat_cell[order]                            # rank-minor
    squery = flat_q[order]
    pos = jnp.arange(m, dtype=jnp.int32)
    # rank within each cell's run: position minus a cummax of run starts
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), scell[1:] != scell[:-1]])
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(is_start, pos, 0))
    rank = pos - run_start
    keep = rank < qcap
    dropped = jnp.sum(~keep).astype(jnp.int32)
    # (nlist, qcap) query index per slot, -1 = empty; out-of-capacity
    # ranks fall off the table via mode="drop"
    qslot = jnp.full((nlist, qcap), -1, jnp.int32)
    qslot = qslot.at[scell, rank].set(squery, mode="drop")
    # per original pair: where did it land (for the regroup stage)
    inv = jnp.zeros((m,), jnp.int32).at[order].set(pos)
    pair_rank = rank[inv]                               # (M,)
    pair_keep = keep[inv]
    # compact probed-cell list: u_idx ranks each sorted pair's cell among
    # the batch's unique cells
    u = min(nlist, m)
    u_idx = (jnp.cumsum(is_start) - 1).astype(jnp.int32)
    compact = jnp.zeros((u,), jnp.int32).at[u_idx].set(scell, mode="drop")
    qslot_c = jnp.full((u, qcap), -1, jnp.int32
                       ).at[u_idx, rank].set(squery, mode="drop")
    return {
        "flat_cell": flat_cell, "flat_q": flat_q,
        "pair_rank": pair_rank, "pair_keep": pair_keep,
        "dropped": dropped,
        "qslot": qslot, "slot_q": jnp.maximum(qslot, 0),
        "compact": compact, "slot_qc": jnp.maximum(qslot_c, 0),
        "cid_pair": u_idx[inv],
    }


def route_scores(qf: jnp.ndarray, centroids: jnp.ndarray,
                 metric: DistanceMetric) -> jnp.ndarray:
    """(B, nlist) f32 routing scores, lower = nearer cell.  Always in full
    float32: a TF32 product would reorder near-tied centroids."""
    if metric == DistanceMetric.COSINE:
        qn = qf / jnp.maximum(jnp.linalg.norm(qf, axis=1, keepdims=True),
                              1e-30)
        cn = centroids / jnp.maximum(
            jnp.linalg.norm(centroids, axis=1, keepdims=True), 1e-30)
        return -jnp.dot(qn, cn.T, preferred_element_type=jnp.float32,
                        precision=_HIGHEST)
    if metric == DistanceMetric.DOT:
        return -jnp.dot(qf, centroids.T, preferred_element_type=jnp.float32,
                        precision=_HIGHEST)
    csq = jnp.einsum("kd,kd->k", centroids, centroids,
                     preferred_element_type=jnp.float32, precision=_HIGHEST)
    return csq[None, :] - 2.0 * jnp.dot(
        qf, centroids.T, preferred_element_type=jnp.float32,
        precision=_HIGHEST)


def _xla_epilogue(cross, cell_norms, qstat_b, slot_q, metric):
    """Metric epilogue of the batched cell matmul: cross (nlist, qcap,
    cmax) f32 -> scores (lower = closer).  qstat_b is the per-QUERY stat
    (cosine 1/||q||, l2 ||q||^2) gathered per slot here."""
    qs = jnp.take(qstat_b, slot_q, axis=0)[:, :, None]
    if metric == DistanceMetric.COSINE:
        rinv = jax.lax.rsqrt(jnp.maximum(cell_norms, 1e-30))
        return 1.0 - cross * qs * rinv[:, None, :]
    if metric == DistanceMetric.L2:
        return jnp.maximum(qs + cell_norms[:, None, :] - 2.0 * cross, 0.0)
    return -cross


@functools.partial(jax.jit, static_argnames=(
    "metric", "k", "nprobe", "qcap", "compute_dtype", "rerank"))
def grouped_ivf_search_kernel(
    q: jnp.ndarray,            # (B, D) f32
    centroids: jnp.ndarray,    # (nlist, D) f32
    cells: jnp.ndarray,        # (nlist, cmax, D) serving dtype OR int8
    row_table: jnp.ndarray,    # (nlist, cmax) int32, -1 = padding
    overflow_vecs: jnp.ndarray,   # (O, D) serving dtype (O may be 0)
    overflow_rows: jnp.ndarray,   # (O,) int32, -1 = padding
    ok_cells: jnp.ndarray,     # (nlist, cmax) bool — slot live (padding
                               #   AND tombstones AND filter pre-applied)
    ok_overflow: jnp.ndarray,  # (O,) bool — same, for the overflow block
    vmin: jnp.ndarray,         # (D,) f32 — int8 cells only (else zeros)
    scale: jnp.ndarray,        # (D,) f32 — int8 cells only (else ones)
    cell_norms: jnp.ndarray,   # (nlist, cmax) f32 ||x||^2 (ALL cell dtypes)
    vectors: Optional[jnp.ndarray] = None,  # (cap, D) store rows — only
                               #   read when rerank > 0 (exact re-rank src)
    *,
    metric: DistanceMetric,
    k: int,
    nprobe: int,
    qcap: int,
    compute_dtype: str = "bfloat16",
    rerank: int = 0,           # re-rank the top rerank*k candidates
                               #   exactly against ``vectors`` (int8 cells
                               #   lose ~5-7 recall points to quantized
                               #   score ordering without this)
):
    """Returns (dists (B, k) f32, rows (B, k) int32, dropped () int32)."""
    qf = q.astype(jnp.float32)
    # ---- stage 1: route queries to their nprobe nearest cells ----------
    croute = route_scores(qf, centroids, metric)
    cand_vals, cand_rows, dropped = grouped_cell_candidates(
        qf, croute, cells, row_table, ok_cells, vmin, scale, cell_norms,
        metric=metric, nprobe=nprobe, qcap=qcap,
        compute_dtype=compute_dtype)
    vals, rows = finish_grouped(
        qf, cand_vals, cand_rows, overflow_vecs, overflow_rows,
        ok_overflow, vectors, metric=metric, k=k, rerank=rerank,
        compute_dtype=compute_dtype)
    return vals, rows, dropped


def finish_grouped(qf, cand_vals, cand_rows, overflow_vecs, overflow_rows,
                   ok_overflow, vectors, *, metric: DistanceMetric, k: int,
                   rerank: int, compute_dtype: str):
    """The grouped dispatch's shared tail: exact-score the overflow block
    (rows the balanced assignment could not place in any cell), merge it
    into the candidate set, then either exact-re-rank the top re-rank*k
    rows against ``vectors`` or take the final top-k directly.  L2
    candidates arrive in the SQUARED domain and leave sqrt'd.  Shared by
    the bf16/int8 grouped kernel above and the grouped IVF-PQ kernel
    (ann/ivfpq.py)."""
    b = qf.shape[0]
    prec = matmul_precision(compute_dtype)
    cd = jnp.dtype(compute_dtype)
    qsq = jnp.einsum("bd,bd->b", qf, qf, preferred_element_type=jnp.float32,
                     precision=_HIGHEST)
    qinv = 1.0 / jnp.maximum(jnp.sqrt(qsq), 1e-30)
    if overflow_rows.shape[0] > 0:
        ovsq = jnp.einsum("od,od->o", overflow_vecs, overflow_vecs,
                          preferred_element_type=jnp.float32,
                          precision=_HIGHEST)
        ocross = jax.lax.dot_general(
            qf.astype(cd), overflow_vecs.astype(cd),
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32, precision=prec)
        if metric == DistanceMetric.COSINE:
            orinv = jax.lax.rsqrt(jnp.maximum(ovsq, 1e-30))
            os_ = 1.0 - ocross * qinv[:, None] * orinv[None, :]
        elif metric == DistanceMetric.L2:
            os_ = jnp.maximum(
                qsq[:, None] + ovsq[None, :] - 2.0 * ocross, 0.0)
        else:
            os_ = -ocross
        os_ = jnp.where(ok_overflow[None, :], os_, MASKED)
        # pre-reduce the overflow block to k per query BEFORE the merge:
        # a big overflow (69k rows at 4M/factor 1.25) would otherwise
        # widen the final top-k's candidate axis ~8x (nprobe*cmax ~10k
        # -> ~79k), and the merge pays for every column
        o = overflow_rows.shape[0]
        if o > 4 * max(k, 1):
            oneg, opos = jax.lax.top_k(-os_, min(k, o))
            os_ = -oneg
            orows_b = jnp.take(overflow_rows, opos, axis=0)  # (B, k)
        else:
            orows_b = jnp.broadcast_to(overflow_rows[None], (b, o))
        cand_vals = jnp.concatenate([cand_vals, os_], axis=1)
        cand_rows = jnp.concatenate([cand_rows, orows_b], axis=1)

    if rerank > 0 and vectors is not None:
        # exact-metric re-rank of the quantized top-c: the candidate
        # gather is small ((B, rerank*k, D) bf16 ~ 63 MB at B=1024/c=40)
        # and recovers the ordering the int8 scores scramble near the
        # top-10 boundary (same stage as quant/scan's two-stage and
        # ann/ivfpq.py's do_rerank)
        c = int(min(max(k, k * rerank), cand_vals.shape[1]))
        cneg, cpos = jax.lax.top_k(-cand_vals, c)
        crows = jnp.take_along_axis(cand_rows, cpos, axis=1)
        cok = (-cneg < MASKED * 0.5) & (crows >= 0)
        cand_vecs = jnp.take(vectors, jnp.maximum(crows, 0), axis=0)
        from ..quant.scan import _rerank_body
        return _rerank_body(qf, cand_vecs, crows, cok, metric,
                            min(k, c), compute_dtype)
    kk = min(k, cand_vals.shape[1])
    neg, posk = jax.lax.top_k(-cand_vals, kk)
    vals = -neg
    rows = jnp.take_along_axis(cand_rows, posk, axis=1)
    if metric == DistanceMetric.L2:
        vals = jnp.where(vals >= MASKED * 0.5, vals,
                         jnp.sqrt(jnp.maximum(vals, 0.0)))
    return vals, rows


def grouped_cell_candidates(
    qf: jnp.ndarray,           # (B, D) f32
    croute: jnp.ndarray,       # (B, nlist) f32 routing scores, LOWER=better
                               #   (callers mask invalid cells to +MASKED)
    cells: jnp.ndarray,        # (nlist, cmax, D) serving dtype OR int8
    row_table: jnp.ndarray,    # (nlist, cmax) int32, -1 = padding
    ok_cells: jnp.ndarray,     # (nlist, cmax) bool, precomputed liveness
    vmin: jnp.ndarray,
    scale: jnp.ndarray,
    cell_norms: jnp.ndarray,   # (nlist, cmax) f32 ||x||^2
    *,
    metric: DistanceMetric,
    nprobe: int,
    qcap: int,
    compute_dtype: str,
):
    """Stages 2-5 of the grouped dispatch: probe -> invert -> one batched
    cell matmul -> regroup.  Returns ``(cand_vals (B, nprobe*cmax) f32
    lower=better (L2 in the SQUARED domain), cand_rows (B, nprobe*cmax)
    int32 from row_table, dropped () int32)``.

    Shared by the single-chip kernel above and the sharded grouped
    dispatch (dist/sharded_ann.py) — inside ``shard_map`` each shard runs
    this over its local cells with its local routing block."""
    b, d = qf.shape
    nlist, cmax = row_table.shape
    prec = matmul_precision(compute_dtype)
    cd = jnp.dtype(compute_dtype)
    int8_cells = cells.dtype == jnp.int8
    _, probe = jax.lax.top_k(-croute, nprobe)           # (B, nprobe) int32

    # ---- stage 2: invert (query -> cells) into (cell -> query slots) ---
    pairs = invert_pairs(probe, nlist, qcap)
    flat_cell = pairs["flat_cell"]
    dropped = pairs["dropped"]
    pair_rank = pairs["pair_rank"]
    pair_keep = pairs["pair_keep"]
    slot_q = pairs["slot_q"]                            # (nlist, qcap)

    qsq = jnp.einsum("bd,bd->b", qf, qf, preferred_element_type=jnp.float32,
                     precision=_HIGHEST)
    qinv = 1.0 / jnp.maximum(jnp.sqrt(qsq), 1e-30)
    # validity mask is per (cell, position), PRECOMPUTED by the caller
    # once per validity epoch: gathering it here from a (cap,) mask would
    # be a random element gather of every probed slot on every call
    okc = ok_cells

    # ---- stage 3+4: gather query slots, ONE batched cell matmul --------
    if metric == DistanceMetric.COSINE:
        qstat_b = qinv
    elif metric == DistanceMetric.L2:
        qstat_b = qsq
    else:
        qstat_b = jnp.zeros_like(qsq)
    if int8_cells:
        # query-side scale folding (quant/scalar.py:_distances_int8_matmul)
        # done ONCE per query before the slot gather; the gathered block
        # stays int8 so the batched matmul runs s8 x s8
        rs = scale / 255.0
        qs = qf * rs[None, :]
        const = jnp.dot(qf, 128.0 * rs + vmin,
                        preferred_element_type=jnp.float32,
                        precision=_HIGHEST)                      # (B,)
        qmax = jnp.max(jnp.abs(qs), axis=1, keepdims=True)
        qscale = jnp.maximum(qmax, 1e-30) / 127.0                # (B, 1)
        qi = jnp.clip(jnp.round(qs / qscale), -127, 127).astype(jnp.int8)
        qblk = jnp.take(qi, slot_q.reshape(-1), axis=0).reshape(
            nlist, qcap, d)
        cross_i = jax.lax.dot_general(
            qblk, cells, dimension_numbers=(((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.int32)           # (nlist, qcap, cmax)
        sscale = jnp.take(qscale[:, 0], slot_q, axis=0)  # (nlist, qcap)
        sconst = jnp.take(const, slot_q, axis=0)
        cross = (cross_i.astype(jnp.float32) * sscale[:, :, None]
                 + sconst[:, :, None])
        s = _xla_epilogue(cross, cell_norms, qstat_b, slot_q, metric)
        s = jnp.where(okc[:, None, :], s, MASKED)
    else:
        qblk = jnp.take(qf.astype(cd), slot_q.reshape(-1), axis=0).reshape(
            nlist, qcap, d)
        cross = jax.lax.dot_general(
            qblk, cells, dimension_numbers=(((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32, precision=prec)
        s = _xla_epilogue(cross, cell_norms, qstat_b, slot_q, metric)
        s = jnp.where(okc[:, None, :], s, MASKED)

    # ---- stage 5: regroup score rows per query, ONE top-k -------------
    # A per-slot top-k over (nlist*qcap, cmax) would pay for every slot
    # including empty headroom.  Gathering each pair's own score row back
    # instead is a small copy, and the per-query exact top-k over
    # nprobe*cmax candidates is the same reduction the baseline kernel
    # uses.
    flat_slot = flat_cell * qcap + jnp.minimum(pair_rank, qcap - 1)
    pv = jnp.take(s.reshape(nlist * qcap, cmax), flat_slot, axis=0)
    pr = jnp.take(row_table, flat_cell, axis=0)         # (M, cmax)
    pv = jnp.where(pair_keep[:, None], pv, MASKED)
    cand_vals = pv.reshape(b, nprobe * cmax)
    cand_rows = pr.reshape(b, nprobe * cmax)
    return cand_vals, cand_rows, dropped
