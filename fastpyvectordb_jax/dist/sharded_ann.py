"""Multi-chip ANN and quantized search (SURVEY §7.6).

The exact sharded scan (dist/sharded.py) row-shards the raw corpus; this
module shards the *index structures* themselves so multi-chip deployments
are not forced back to exact scans:

  * **ShardedIVF** — the IVF cell tensor (nlist, cmax, D), row table and
    centroids are sharded along the cell axis.  Every device routes each
    query within its local centroid shard (probing ``ceil(nprobe/ndev)``
    cells, doubled for recall headroom since the global best cells may
    cluster on one shard), scores its probed cells exactly, and the
    per-shard top-k partials are ``all_gather``-ed across devices and
    merged —
    the row table stores *global* row ids, so no re-indexing is needed.
  * **ShardedInt8** — the int8 (or packed-int4) code matrix, dequantized
    row stats and the
    re-rank corpus are row-sharded.  Coarse s8 x s8 scan, candidate
    selection, gather and exact re-rank all happen shard-locally (the
    candidates of a shard are rows of that shard); only the final (B, k)
    partials cross between devices.

Both reuse the single-chip kernels' math and the exact path's distributed
top-k merge.  Reference analog: none — the reference's only parallelism is
a thread pool over chunks (parallel_search.py:313-368).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.types import DistanceMetric
from ..kernels.distances import MASKED, matmul_precision
from .mesh import DATA_AXIS


def _merge_over_data_axis(vals, gidx, k, *, sqrt_l2=False):
    """all_gather per-shard (B, kk) partials and take the global top-k."""
    vals_g = jax.lax.all_gather(vals, DATA_AXIS)   # (ndev, B, kk)
    idx_g = jax.lax.all_gather(gidx, DATA_AXIS)
    ndev, b, kk = vals_g.shape
    vals_f = jnp.moveaxis(vals_g, 0, 1).reshape(b, ndev * kk)
    idx_f = jnp.moveaxis(idx_g, 0, 1).reshape(b, ndev * kk)
    neg, pos = jax.lax.top_k(-vals_f, min(k, ndev * kk))
    out_vals = -neg
    if sqrt_l2:
        out_vals = jnp.where(out_vals >= MASKED, out_vals,
                             jnp.sqrt(jnp.maximum(out_vals, 0.0)))
    return out_vals, jnp.take_along_axis(idx_f, pos, axis=1)


# ---------------------------------------------------------------------------
# Sharded IVF
# ---------------------------------------------------------------------------

def build_sharded_ivf_search(mesh: Mesh, *, metric: DistanceMetric, k: int,
                             nprobe_local: int,
                             compute_dtype: str = "bfloat16",
                             allow_grouped: bool = True,
                             has_overflow: bool = False,
                             rerank: int = 0,
                             shard_rows: int = 1):
    """Compile the sharded IVF search.

    Expects (queries replicated, centroids/cells/row_table/cent_valid
    sharded on DATA along the cell axis, the overflow block and vectors
    row-sharded).  Each shard scans its slice of the overflow block
    exactly for every query, as the single-device index scans its whole
    overflow block (``has_overflow=False`` skips it).  With
    ``rerank > 0`` the merged quantized top-``rerank*k`` is re-scored
    exactly against the row-sharded store (the ShardedIVFPQ phase-2
    pattern): each shard scores the candidates it owns, everyone else
    reports MASKED, and a ``pmin`` assembles the exact score matrix —
    int8 cell scores scramble top-k ordering without this (~5-7 recall
    points on clustered corpora, same as the single-chip index).
    """
    metric = DistanceMetric.parse(metric)
    cd = jnp.dtype(compute_dtype)
    prec = matmul_precision(compute_dtype)
    # local candidates kept per shard before the merge
    c_sel = k if rerank <= 0 else max(k, k * rerank)

    def finish(vals, rows, dropped, qf, vectors):
        """Merge per-shard candidates; optionally re-rank exactly."""
        if rerank <= 0:
            dv, dr = _merge_over_data_axis(vals, rows, k)
            return dv, dr, dropped
        gv, grows = _merge_over_data_axis(vals, rows, c_sel)  # (B, cg)
        b2 = qf.shape[0]
        lo = jax.lax.axis_index(DATA_AXIS) * shard_rows
        own = (grows >= lo) & (grows < lo + shard_rows)
        lrow = jnp.clip(grows - lo, 0, shard_rows - 1)
        cv = jnp.take(vectors, lrow, axis=0)              # (B, cg, D)
        vsq2 = jnp.einsum("bcd,bcd->bc", cv, cv,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
        cross2 = jnp.einsum("bd,bcd->bc", qf.astype(cd), cv.astype(cd),
                            preferred_element_type=jnp.float32,
                            precision=prec)
        qsq2 = jnp.einsum("bd,bd->b", qf, qf,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
        if metric == DistanceMetric.COSINE:
            qinv2 = 1.0 / jnp.maximum(jnp.sqrt(qsq2[:, None]), 1e-30)
            es = 1.0 - cross2 * qinv2 * jax.lax.rsqrt(
                jnp.maximum(vsq2, 1e-30))
        elif metric == DistanceMetric.L2:
            es = jnp.sqrt(jnp.maximum(
                qsq2[:, None] + vsq2 - 2.0 * cross2, 0.0))
        else:
            es = -cross2
        es = jnp.where(own & (grows >= 0) & (gv < MASKED * 0.5), es,
                       MASKED)
        es = jax.lax.pmin(es, DATA_AXIS)                  # assemble exact
        kk = min(k, grows.shape[1])
        neg, pos = jax.lax.top_k(-es, kk)
        return -neg, jnp.take_along_axis(grows, pos, axis=1), dropped

    def overflow_scores(qf, ovecs, onorms, ook, vmin, scale):
        """(B, O_local) scores of this shard's overflow rows (squared for
        L2, like the grouped candidates); dead slots are MASKED."""
        if ovecs.dtype == jnp.int8:
            rs = scale / 255.0
            const = jnp.dot(qf, 128.0 * rs + vmin,
                            preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)
            cross = jnp.einsum(
                "bd,od->bo", (qf * rs).astype(cd), ovecs.astype(cd),
                preferred_element_type=jnp.float32,
                precision=prec) + const[:, None]
        else:
            cross = jnp.einsum("bd,od->bo", qf.astype(cd), ovecs,
                               preferred_element_type=jnp.float32,
                               precision=prec)
        qsq = jnp.einsum("bd,bd->b", qf, qf,
                         preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        if metric == DistanceMetric.COSINE:
            qinv = 1.0 / jnp.maximum(jnp.sqrt(qsq), 1e-30)
            s = 1.0 - cross * qinv[:, None] * jax.lax.rsqrt(
                jnp.maximum(onorms, 1e-30))[None, :]
        elif metric == DistanceMetric.L2:
            s = jnp.maximum(qsq[:, None] + onorms[None, :] - 2.0 * cross,
                            0.0)
        else:
            s = -cross
        return jnp.where(ook[None, :], s, MASKED)

    def local(q, centroids, cells, row_table, cent_valid, ok_cells, vmin,
              scale, cell_norms, ovecs, onorms, ook, orows, vectors):
        b, d = q.shape
        cmax = cells.shape[1]
        qf = q.astype(jnp.float32)
        # route within the local centroid shard
        from ..ann.ivf_grouped import route_scores
        croute = route_scores(qf, centroids, metric)
        croute = jnp.where(cent_valid[None, :], croute, MASKED)
        nlist_l = centroids.shape[0]
        npl = min(nprobe_local, nlist_l)

        # large batches go cell-major within the shard, mirroring the
        # single-chip auto-dispatch (ann/ivf.py search): each local cell
        # block is read once per batch instead of once per probing query
        if allow_grouped and b * npl >= nlist_l:
            from ..ann.ivf_grouped import (grouped_cell_candidates,
                                           grouped_qcap)
            qcap = grouped_qcap(b, npl, nlist_l, cmax)
            vals, cand, dropped = grouped_cell_candidates(
                qf, croute, cells, row_table, ok_cells, vmin, scale,
                cell_norms, metric=metric, nprobe=npl, qcap=int(qcap),
                compute_dtype=compute_dtype)       # L2 squared
            dropped = jax.lax.psum(dropped, DATA_AXIS)
        else:
            _, probe = jax.lax.top_k(-croute, npl)     # (B, npl) local cells
            vecs = jnp.take(cells, probe, axis=0).reshape(b, npl * cmax, d)
            cand = jnp.take(row_table, probe, axis=0).reshape(b, -1)
            # per-slot liveness precomputed at construction (no per-call
            # validmask[row_table] element gather); rides the same
            # cell-row gather
            ok = jnp.take(ok_cells, probe, axis=0).reshape(b, -1)
            qsq = jnp.einsum("bd,bd->b", qf, qf,
                             preferred_element_type=jnp.float32,
                             precision=jax.lax.Precision.HIGHEST)
            qinv = 1.0 / jnp.maximum(jnp.sqrt(qsq[:, None]), 1e-30)
            if cells.dtype == jnp.int8:
                # quantized cells (ann/ivf.py cell_dtype="int8"): int8
                # block stream + dequantized norms, same math as the
                # single chip
                rs = scale / 255.0
                const = jnp.dot(qf, 128.0 * rs + vmin,
                                preferred_element_type=jnp.float32,
                                precision=jax.lax.Precision.HIGHEST)
                cross = jnp.einsum("bd,bcd->bc", (qf * rs).astype(cd), vecs,
                                   preferred_element_type=jnp.float32,
                                   precision=prec) + const[:, None]
                vsq = jnp.take(cell_norms, probe, axis=0).reshape(b, -1)
            else:
                vsq = jnp.einsum("bcd,bcd->bc", vecs, vecs,
                                 preferred_element_type=jnp.float32,
                                 precision=jax.lax.Precision.HIGHEST)
                cross = jnp.einsum("bd,bcd->bc", qf.astype(cd), vecs,
                                   preferred_element_type=jnp.float32,
                                   precision=prec)
            if metric == DistanceMetric.COSINE:
                vals = 1.0 - cross * qinv * jax.lax.rsqrt(
                    jnp.maximum(vsq, 1e-30))
            elif metric == DistanceMetric.L2:
                vals = jnp.maximum(qsq[:, None] + vsq - 2.0 * cross, 0.0)
            else:
                vals = -cross
            vals = jnp.where(ok, vals, MASKED)
            dropped = jnp.zeros((), jnp.int32)
        if has_overflow:
            vals = jnp.concatenate(
                [vals, overflow_scores(qf, ovecs, onorms, ook, vmin, scale)],
                axis=1)
            cand = jnp.concatenate(
                [cand, jnp.broadcast_to(orows[None], (b, orows.shape[0]))],
                axis=1)
        kk = min(c_sel, vals.shape[1])
        neg, pos = jax.lax.top_k(-vals, kk)
        vals = -neg
        if metric == DistanceMetric.L2:  # candidates are squared
            vals = jnp.where(vals >= MASKED * 0.5, vals,
                             jnp.sqrt(jnp.maximum(vals, 0.0)))
        return finish(vals, jnp.take_along_axis(cand, pos, axis=1),
                      dropped, qf, vectors)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, None), P(DATA_AXIS, None),
                  P(DATA_AXIS, None, None), P(DATA_AXIS, None),
                  P(DATA_AXIS), P(DATA_AXIS, None), P(None), P(None),
                  P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS),
                  P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS, None)),
        out_specs=(P(None, None), P(None, None), P()),
        check_vma=False,
    )
    return jax.jit(fn)


_OVERFLOW_ALIGN = 128


def _pad_overflow_shards(ovecs, onorms, orows, ndev: int):
    """Pad each shard's slice of the overflow block to a multiple of
    ``_OVERFLOW_ALIGN`` rows (dead slots: row -1, norm 0, zero vector).

    On the H100 (jax 0.9.0) XLA's GEMM for an int8 operand converted to
    bf16 returned NaN and garbage when that operand had an odd row count:
    4M rows split four ways left 13,591 overflow rows per shard, and every
    query's top-k filled with overflow rows scored near -3e34.  An aligned
    length avoids that and gives the GEMM whole tiles."""
    if orows.shape[0] % ndev:
        raise ValueError(f"overflow length {orows.shape[0]} is not a "
                         f"multiple of the {ndev} shards")
    per = orows.shape[0] // ndev
    grow = (-per) % _OVERFLOW_ALIGN
    if not grow:
        return ovecs, onorms, orows

    def pad(a, value=0):
        a = a.reshape(ndev, per, *a.shape[1:])
        widths = [(0, 0), (0, grow)] + [(0, 0)] * (a.ndim - 2)
        a = np.pad(a, widths, constant_values=value)
        return a.reshape(ndev * (per + grow), *a.shape[2:])

    return pad(ovecs), pad(onorms), pad(orows, -1)


class ShardedIVF:
    """A single-chip IVFIndex re-laid-out across a device mesh."""

    def __init__(self, mesh: Mesh, centroids, cells, row_table, cent_valid,
                 validmask, vmin=None, scale=None, cell_norms=None,
                 overflow=None, vectors=None, *,
                 metric: DistanceMetric, nprobe: int,
                 compute_dtype: str = "bfloat16", rerank: int = 0):
        """``overflow``: ``(vecs, norms, rows)`` of the rows that fit none
        of their cells, ``ndev * per`` long (rows == -1 pad), in the cells'
        dtype; shard i scans rows ``[i*per, (i+1)*per)`` exactly."""
        self.mesh = mesh
        self.metric = DistanceMetric.parse(metric)
        self.nprobe = nprobe
        self.compute_dtype = compute_dtype
        ndev = mesh.shape[DATA_AXIS]
        local_cells = centroids.shape[0] // ndev
        # 2x headroom: the global best-nprobe cells may cluster on one shard
        self.nprobe_local = max(1, min(-(-nprobe // ndev) * 2, local_cells))
        self._allow_grouped = True
        shard = lambda a, nd: jax.device_put(
            a, NamedSharding(mesh, P(DATA_AXIS, *([None] * (nd - 1)))))
        self.centroids = shard(centroids, 2)
        self.cells = shard(cells, 3)
        self.row_table = shard(row_table, 2)
        self.cent_valid = shard(cent_valid, 1)
        # per-slot liveness, precomputed once: the layout is an immutable
        # snapshot (validity changes require re-sharding), so the
        # validmask[row_table] gather never belongs in the search dispatch
        tbl = np.asarray(row_table)
        vm_h = np.asarray(validmask)
        self.ok_cells = shard(
            (tbl >= 0) & vm_h[np.maximum(tbl, 0)], 2)
        self.has_overflow = overflow is not None
        if overflow is None:   # one dead slot per shard, never scanned
            ovecs, onorms, orows = (
                np.zeros((ndev, cells.shape[2]), cells.dtype),
                np.zeros((ndev,), np.float32), np.full((ndev,), -1, np.int32))
        else:
            ovecs, onorms, orows = _pad_overflow_shards(
                *(np.asarray(a) for a in overflow), ndev)
        self.overflow_vecs = shard(ovecs, 2)
        self.overflow_norms = shard(onorms.astype(np.float32), 1)
        self.overflow_rows = shard(orows.astype(np.int32), 1)
        self.ok_overflow = shard((orows >= 0) & vm_h[np.maximum(orows, 0)], 1)
        rep = lambda a: jax.device_put(np.asarray(a),
                                       NamedSharding(mesh, P()))
        d = centroids.shape[1]
        self.vmin = rep(vmin if vmin is not None
                        else np.zeros((d,), np.float32))
        self.scale = rep(scale if scale is not None
                         else np.ones((d,), np.float32))
        if cell_norms is None:
            if np.asarray(cells).dtype == np.int8:
                # norms of raw codes would silently skew every distance
                raise ValueError(
                    "int8 cells require the dequantized cell_norms")
            # per-slot squared norms (once, blockwise to bound the f32
            # transient): the grouped dispatch's metric epilogue needs
            # them for every cell dtype
            tbl_h = np.asarray(row_table)
            cell_norms = np.zeros(tbl_h.shape, np.float32)
            blk = max(1, int((256 << 20) // max(
                cells.shape[1] * cells.shape[2] * 4, 1)))
            for i in range(0, cells.shape[0], blk):
                cf = np.asarray(cells[i:i + blk], dtype=np.float32)
                cell_norms[i:i + blk] = np.einsum("ncd,ncd->nc", cf, cf)
            cell_norms = np.where(tbl_h >= 0, cell_norms, 0.0)
        self.cell_norms = shard(np.asarray(cell_norms, np.float32), 2)
        # exact re-rank corpus, row-sharded (int8 cells: quantized scores
        # scramble top-k ordering without it).  rerank > 0 requires it.
        if rerank > 0 and vectors is None:
            raise ValueError("rerank > 0 requires the re-rank corpus")
        self.rerank = int(rerank)
        if vectors is not None:
            vectors = np.asarray(vectors)
            pad = (-vectors.shape[0]) % ndev
            if pad:
                vectors = np.pad(vectors, ((0, pad), (0, 0)))
            self.shard_rows = vectors.shape[0] // ndev
            self.vectors = shard(vectors, 2)
        else:
            self.shard_rows = 1
            # unused placeholder (rerank == 0 never reads it)
            self.vectors = shard(
                np.zeros((ndev, centroids.shape[1]), np.float32), 2)
        self._fns = {}

    @classmethod
    def from_index(cls, mesh: Mesh, ivf, validmask=None) -> "ShardedIVF":
        """Shard an ann.ivf.IVFIndex's tables across ``mesh``.

        The cell axis is padded to a multiple of the data-axis size; padded
        centroids are masked out of routing via ``cent_valid``.  Overflow
        rows (rows that fit none of their candidate cells) are split evenly
        over the shards, and each shard scans its part exactly for every
        query: the single-device index's exact-scan-of-overflow contract.
        The overflow block never widens the cells.
        """
        ndev = mesh.shape[DATA_AXIS]
        centroids = np.asarray(ivf.centroids, dtype=np.float32)
        cells = np.asarray(ivf.cells)
        table = np.asarray(ivf.row_table)
        quantized = ivf.quantizer is not None
        # reuse the index's device-computed per-slot norms for every cell
        # dtype (the grouped in-shard dispatch needs them; recomputing
        # host-side would copy the full cell tensor to f32)
        norms = np.asarray(ivf._cell_norms_cached())
        nlist, cmax, d = cells.shape
        pad = (-nlist) % ndev
        if pad:
            centroids = np.pad(centroids, ((0, pad), (0, 0)))
            cells = np.pad(cells, ((0, pad), (0, 0), (0, 0)))
            norms = np.pad(norms, ((0, pad), (0, 0)))
            table = np.pad(table, ((0, pad), (0, 0)), constant_values=-1)
        cent_valid = np.ones((centroids.shape[0],), dtype=bool)
        if pad:
            cent_valid[-pad:] = False
        orows_all = np.asarray(ivf.overflow_rows)
        keep = orows_all >= 0
        overflow = None
        if keep.any():
            orows = orows_all[keep]
            per = -(-orows.size // ndev)
            ovecs = np.asarray(ivf.overflow_vecs, dtype=np.float32)[keep]
            if quantized:
                # int8 cells: ENCODE the f32 overflow rows (a raw-f32 write
                # into an int8 array would silently truncate to garbage)
                from ..quant.scalar import _dequant_row_stats, _encode
                codes = _encode(jnp.asarray(ovecs), ivf.quantizer.vmin,
                                ivf.quantizer.scale)
                onorms = np.asarray(_dequant_row_stats(
                    codes, ivf.quantizer.vmin, ivf.quantizer.scale)[0])
                ovecs = np.asarray(codes)
            else:
                onorms = np.einsum("od,od->o", ovecs, ovecs)
                ovecs = ovecs.astype(cells.dtype)
            grow = ndev * per - orows.size
            overflow = (np.pad(ovecs, ((0, grow), (0, 0))),
                        np.pad(onorms, (0, grow)),
                        np.pad(orows, (0, grow), constant_values=-1))
        store = ivf._collection._store
        vm = (np.asarray(store.valid) if validmask is None
              else np.asarray(validmask))
        cfg = ivf._collection.config
        rr = int(getattr(ivf, "rerank", 0))
        return cls(mesh, centroids, cells, table, cent_valid, vm,
                   vmin=(np.asarray(ivf.quantizer.vmin) if quantized
                         else None),
                   scale=(np.asarray(ivf.quantizer.scale) if quantized
                          else None),
                   cell_norms=norms,
                   overflow=overflow,
                   vectors=(np.asarray(store.vectors) if rr > 0 else None),
                   metric=cfg.metric, nprobe=ivf.nprobe,
                   compute_dtype=cfg.compute_dtype, rerank=rr)

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = jnp.asarray(np.ascontiguousarray(queries, dtype=np.float32))
        if k not in self._fns:
            self._fns[k] = build_sharded_ivf_search(
                self.mesh, metric=self.metric, k=k,
                nprobe_local=self.nprobe_local,
                compute_dtype=self.compute_dtype,
                allow_grouped=self._allow_grouped,
                has_overflow=self.has_overflow,
                rerank=self.rerank, shard_rows=self.shard_rows)
        d, r, dropped = self._fns[k](
            q, self.centroids, self.cells, self.row_table,
            self.cent_valid, self.ok_cells, self.vmin, self.scale,
            self.cell_norms, self.overflow_vecs, self.overflow_norms,
            self.ok_overflow, self.overflow_rows, self.vectors)
        # qcap saturation observability, matching the single-chip index
        self.last_dropped = int(dropped)
        return np.asarray(d), np.asarray(r)


# ---------------------------------------------------------------------------
# Sharded IVF-PQ
# ---------------------------------------------------------------------------

def build_sharded_ivfpq_search(mesh: Mesh, *, metric: DistanceMetric, k: int,
                               c: int, nprobe_local: int, shard_rows: int,
                               rerank_dtype: str = "bfloat16",
                               allow_grouped: bool = True):
    """Compile the sharded IVF-PQ search: cell-sharded ADC scoring, then a
    row-sharded exact re-rank.

    Phase 1 (cell axis): each device routes within its local centroid
    shard, ADC-scores its probed cells (cell-independent LUT, same math as
    ann/ivfpq.py), and contributes top-c candidates with *global* row ids.
    Phase 2 (row axis): the merged candidate list is re-scored exactly —
    each device scores the candidates whose rows it owns (the corpus is
    row-sharded, so no cross-device gather of vectors), everyone else
    reports MASKED, and an elementwise ``pmin`` assembles the full exact
    score matrix before the final top-k.  Only (B, c)-sized tensors ever
    cross between devices.
    """
    metric = DistanceMetric.parse(metric)

    def local(q, centroids, codebooks, codes, codes_t, norms, row_table,
              cent_valid, orow_ids, vectors, validmask, ok_cells):
        b, d = q.shape
        nlist_l, cmax, m = codes.shape
        kk_cb = codebooks.shape[1]
        qf = q.astype(jnp.float32)
        # ---- phase 1: route within the local centroid shard --------------
        qc = jnp.dot(qf, centroids.T, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
        if metric == DistanceMetric.COSINE:
            cn = jnp.maximum(jnp.linalg.norm(centroids, axis=1), 1e-30)
            route = qc / cn[None, :]
        elif metric == DistanceMetric.DOT:
            route = qc
        else:
            csq = jnp.einsum("kd,kd->k", centroids, centroids,
                             preferred_element_type=jnp.float32,
                             precision=jax.lax.Precision.HIGHEST)
            route = -(csq[None, :] - 2.0 * qc)
        route = jnp.where(cent_valid[None, :], route, -MASKED)
        npl = min(nprobe_local, nlist_l)
        _, probe = jax.lax.top_k(route, npl)
        qsq = jnp.einsum("bd,bd->b", qf, qf,
                         preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        qinv = 1.0 / jnp.maximum(jnp.sqrt(qsq[:, None]), 1e-30)

        dropped = jnp.zeros((), jnp.int32)
        if allow_grouped and b * npl >= nlist_l:
            # large batches go cell-major within the shard, mirroring the
            # single-chip auto-dispatch (ann/ivfpq.py search): each probed
            # cell's codes are one-hot-expanded ONCE per batch and
            # contracted against the ADC tables of every query probing it
            # — the per-query (B, npl, cmax, M, K) one-hot never streams.
            # Overflow rows ride the row-id side-channel below in both
            # branches.
            from ..ann.ivfpq import _grouped_pq_candidates
            from ..ann.ivf_grouped import grouped_qcap
            qcap = grouped_qcap(b, npl, nlist_l, cmax)
            s, cand, dropped = _grouped_pq_candidates(
                qf, qc, probe, codes_t, codebooks, norms, row_table,
                ok_cells, metric=metric, qcap=int(qcap))
            dropped = jax.lax.psum(dropped, DATA_AXIS)
            safe = jnp.maximum(cand, 0)
        else:
            from ..ann.ivfpq import _adc_sum
            qsub = qf.reshape(b, m, d // m)
            lut = jnp.einsum("bmd,mkd->bmk", qsub, codebooks,
                             preferred_element_type=jnp.float32,
                             precision=jax.lax.Precision.HIGHEST)
            codes_g = jnp.take(codes, probe, axis=0)
            norms_g = jnp.take(norms, probe, axis=0).reshape(b, -1)
            cand = jnp.take(row_table, probe, axis=0).reshape(b, -1)
            # per-slot liveness precomputed at construction (no per-call
            # validmask[row_table] element gather)
            ok = jnp.take(ok_cells, probe, axis=0).reshape(b, -1)
            adc = _adc_sum(lut, codes_g, m, kk_cb, b, npl, cmax)
            qc_g = jnp.take_along_axis(qc, probe, axis=1)[:, :, None]
            cross = (qc_g + adc.reshape(b, npl, cmax)).reshape(b, -1)

            if metric == DistanceMetric.COSINE:
                rinv = jax.lax.rsqrt(jnp.maximum(norms_g, 1e-30))
                s = 1.0 - cross * qinv * rinv
            elif metric == DistanceMetric.L2:
                s = jnp.maximum(qsq[:, None] + norms_g - 2.0 * cross, 0.0)
            else:
                s = -cross
            safe = jnp.maximum(cand, 0)
            s = jnp.where(ok, s, MASKED)
        cc = min(c, s.shape[1])
        negc, cpos = jax.lax.top_k(-s, cc)
        crows = jnp.take_along_axis(safe, cpos, axis=1)
        crows = jnp.where(-negc < MASKED * 0.5, crows, -1)

        # merge candidates across the cell shards (cells are disjoint)
        rows_g = jax.lax.all_gather(crows, DATA_AXIS)      # (ndev, B, cc)
        vals_g = jax.lax.all_gather(-negc, DATA_AXIS)
        ndev = rows_g.shape[0]
        rows_f = jnp.moveaxis(rows_g, 0, 1).reshape(b, ndev * cc)
        vals_f = jnp.moveaxis(vals_g, 0, 1).reshape(b, ndev * cc)
        cg = min(c, ndev * cc)
        _, sel = jax.lax.top_k(-vals_f, cg)
        grows = jnp.take_along_axis(rows_f, sel, axis=1)   # (B, cg) global

        # overflow rows bypass ADC entirely: the single-chip index scores
        # them EXACTLY on every query (ann/ivfpq.py overflow scan), and PQ
        # codebooks trained on in-cell residuals can encode far-out rows
        # to garbage — so their global ids ride a side-channel straight
        # into the exact re-rank below (-1 padded, masked there).
        of_g = jax.lax.all_gather(orow_ids, DATA_AXIS).reshape(-1)
        grows = jnp.concatenate(
            [grows, jnp.broadcast_to(of_g[None, :], (b, of_g.shape[0]))],
            axis=1)

        # ---- phase 2: row-sharded exact re-rank --------------------------
        lo = jax.lax.axis_index(DATA_AXIS) * shard_rows
        own = (grows >= lo) & (grows < lo + shard_rows)
        lrow = jnp.clip(grows - lo, 0, shard_rows - 1)
        cv = jnp.take(vectors, lrow, axis=0)               # (B, cg, D)
        vsq = jnp.einsum("bcd,bcd->bc", cv, cv,
                         preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        cd2 = jnp.dtype(rerank_dtype)
        cross2 = jnp.einsum("bd,bcd->bc", qf.astype(cd2), cv.astype(cd2),
                            preferred_element_type=jnp.float32,
                            precision=matmul_precision(rerank_dtype))
        if metric == DistanceMetric.COSINE:
            rinv2 = jax.lax.rsqrt(jnp.maximum(vsq, 1e-30))
            es = 1.0 - cross2 * qinv * rinv2
        elif metric == DistanceMetric.L2:
            es = jnp.sqrt(jnp.maximum(qsq[:, None] + vsq - 2.0 * cross2,
                                      0.0))
        else:
            es = -cross2
        # validmask re-checked here: ADC candidates were filtered in phase
        # 1, but side-channel overflow rows were not
        vok = jnp.take(validmask, jnp.maximum(grows, 0), axis=0)
        es = jnp.where(own & (grows >= 0) & vok, es, MASKED)
        es = jax.lax.pmin(es, DATA_AXIS)                   # assemble exact
        kk = min(k, grows.shape[1])
        neg, pos = jax.lax.top_k(-es, kk)
        return -neg, jnp.take_along_axis(grows, pos, axis=1), dropped

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, None), P(DATA_AXIS, None), P(None, None, None),
                  P(DATA_AXIS, None, None), P(DATA_AXIS, None, None),
                  P(DATA_AXIS, None),
                  P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS),
                  P(DATA_AXIS, None), P(None), P(DATA_AXIS, None)),
        out_specs=(P(None, None), P(None, None), P()),
        check_vma=False,
    )
    return jax.jit(fn)


class ShardedIVFPQ:
    """An ann.ivfpq.IVFPQIndex re-laid-out across a device mesh: cells on
    the cell axis, the exact-re-rank corpus on the row axis."""

    def __init__(self, mesh: Mesh, centroids, codebooks, codes, norms,
                 row_table, cent_valid, vectors, validmask,
                 orow_ids=None, *,
                 metric: DistanceMetric, nprobe: int, rerank: int,
                 rerank_dtype: str = "bfloat16"):
        self.mesh = mesh
        self.metric = DistanceMetric.parse(metric)
        self.nprobe = nprobe
        self.rerank = rerank
        self.rerank_dtype = rerank_dtype
        ndev = mesh.shape[DATA_AXIS]
        self.shard_rows = vectors.shape[0] // ndev
        local_cells = centroids.shape[0] // ndev
        self.nprobe_local = max(1, min(-(-nprobe // ndev) * 2, local_cells))
        shard = lambda a, nd: jax.device_put(
            a, NamedSharding(mesh, P(DATA_AXIS, *([None] * (nd - 1)))))
        rep = lambda a: jax.device_put(a, NamedSharding(mesh, P()))
        self.centroids = shard(centroids, 2)
        self.codebooks = rep(codebooks)
        self.codes = shard(codes, 3)
        # (nlist, M, cmax) transposed codes for the grouped (cell-major)
        # large-batch dispatch — PQ codes are ~D/M-fold compressed, so the
        # second copy costs far less than the bf16 re-rank corpus shard
        codes_np = np.asarray(codes)
        self.codes_t = shard(
            np.ascontiguousarray(codes_np.transpose(0, 2, 1)), 3)
        self._allow_grouped = True  # clear _fns when toggling (cache key)
        self.norms = shard(norms, 2)
        self.row_table = shard(row_table, 2)
        self.cent_valid = shard(cent_valid, 1)
        if orow_ids is None:
            orow_ids = np.full((ndev,), -1, np.int32)
        self.orow_ids = shard(np.asarray(orow_ids, np.int32), 1)
        self.vectors = shard(vectors, 2)
        self.validmask = rep(validmask)
        # per-slot liveness, precomputed once over the immutable layout
        # (see ShardedIVF.__init__): phase-1 candidate masking never pays
        # the per-call validmask[row_table] element gather
        tbl = np.asarray(row_table)
        vm_h = np.asarray(validmask)
        self.ok_cells = shard((tbl >= 0) & vm_h[np.maximum(tbl, 0)], 2)
        self._fns = {}

    @classmethod
    def from_index(cls, mesh: Mesh, idx, validmask=None) -> "ShardedIVFPQ":
        """Shard an ann.ivfpq.IVFPQIndex across ``mesh``.  Overflow rows
        (which the single-chip index scores exactly on every query) ride a
        row-id side-channel into the exact re-rank phase — re-encoding
        them through PQ codebooks trained on in-cell residuals can place
        far-out rows arbitrarily badly in ADC space."""
        ndev = mesh.shape[DATA_AXIS]
        centroids = np.asarray(idx.centroids, dtype=np.float32)
        codes = np.asarray(idx.codes)
        norms = np.asarray(idx.norms)
        table = np.asarray(idx.row_table)
        nlist, cmax, m = codes.shape
        orows_all = np.asarray(idx.overflow_rows)
        orows = orows_all[orows_all >= 0]
        per = max(1, -(-int(orows.size) // ndev))
        orow_ids = np.full((ndev * per,), -1, np.int32)
        orow_ids[:orows.size] = orows
        pad = (-nlist) % ndev
        if pad:
            centroids = np.pad(centroids, ((0, pad), (0, 0)))
            codes = np.pad(codes, ((0, pad), (0, 0), (0, 0)))
            norms = np.pad(norms, ((0, pad), (0, 0)))
            table = np.pad(table, ((0, pad), (0, 0)), constant_values=-1)
        cent_valid = np.ones((centroids.shape[0],), dtype=bool)
        if pad:
            cent_valid[-pad:] = False
        store = idx._collection._store
        cfg = idx._collection.config
        n = store.count
        vecs = np.asarray(store.vectors[:n], dtype=np.float32)
        vm = (np.asarray(store.valid[:n]) if validmask is None
              else np.asarray(validmask)[:n])
        rpad = (-n) % ndev
        if rpad:
            vecs = np.pad(vecs, ((0, rpad), (0, 0)))
        vmask = np.zeros((store.capacity,), dtype=bool)
        vmask[:n] = vm
        dtype_name = ("bfloat16" if cfg.compute_dtype == "bfloat16"
                      else "float32")
        return cls(mesh, centroids, np.asarray(idx.codebooks), codes, norms,
                   table, cent_valid, vecs.astype(jnp.dtype(dtype_name)),
                   vmask, orow_ids, metric=cfg.metric, nprobe=idx.nprobe,
                   rerank=idx.rerank, rerank_dtype=dtype_name)

    def search(self, queries, k: int, rerank: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        q = jnp.asarray(np.ascontiguousarray(queries, dtype=np.float32))
        rr = rerank if rerank is not None else self.rerank
        c = max(k * max(rr, 1), k)
        key = (k, c)
        if key not in self._fns:
            self._fns[key] = build_sharded_ivfpq_search(
                self.mesh, metric=self.metric, k=k, c=c,
                nprobe_local=self.nprobe_local, shard_rows=self.shard_rows,
                rerank_dtype=self.rerank_dtype,
                allow_grouped=self._allow_grouped)
        d, r, dropped = self._fns[key](
            q, self.centroids, self.codebooks, self.codes, self.codes_t,
            self.norms, self.row_table, self.cent_valid,
            self.orow_ids, self.vectors, self.validmask,
            self.ok_cells)
        self.last_dropped = int(dropped)
        return np.asarray(d), np.asarray(r)


# ---------------------------------------------------------------------------
# Sharded int8 two-stage scan
# ---------------------------------------------------------------------------

def build_sharded_int8_search(mesh: Mesh, *, metric: DistanceMetric, k: int,
                              c: int, rerank_dtype: str = "bfloat16",
                              codec: str = "int8"):
    """Compile the sharded scalar-quantized coarse scan + shard-local
    exact re-rank (codec = int8 or int4 packed nibbles).

    Expects (queries replicated; codes/vsq/rinv/vectors/valid row-sharded
    on DATA; vmin/scale replicated).  Candidate rows of a shard are rows of
    that shard, so the gather + re-rank never leave the device; only the
    (B, k) partials are all_gather-ed.
    """
    metric = DistanceMetric.parse(metric)

    def local(q, codes, vmin, scale, vsq, rinv, vectors, valid):
        from ..quant.scan import _rerank_body
        if codec == "int4":
            from ..quant.int4 import _distances_int4_matmul as _dist
        else:
            from ..quant.scalar import _distances_int8_matmul as _dist
        shard_rows = codes.shape[0]
        s = _dist(q, codes, vmin, scale, vsq, rinv, metric=metric)
        s = jnp.where(valid[None, :], s, MASKED)
        cc = min(c, shard_rows)
        negc, crows = jax.lax.top_k(-s, cc)             # shard-local rows
        cand_vecs = jnp.take(vectors, crows, axis=0)
        kk = min(k, cc)
        vals, rows = _rerank_body(q, cand_vecs, crows, -negc < MASKED * 0.5,
                                  metric, kk, rerank_dtype)
        gidx = rows + jax.lax.axis_index(DATA_AXIS) * shard_rows
        return _merge_over_data_axis(vals, gidx, k)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, None), P(DATA_AXIS, None), P(None), P(None),
                  P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS, None),
                  P(DATA_AXIS)),
        out_specs=(P(None, None), P(None, None)),
        check_vma=False,
    )
    return jax.jit(fn)


class ShardedInt8:
    """A quant.scan int8/int4 snapshot re-laid-out across a device mesh."""

    def __init__(self, mesh: Mesh, codes, vmin, scale, vsq, rinv, vectors,
                 valid, *, metric: DistanceMetric,
                 rerank_dtype: str = "bfloat16", codec: str = "int8"):
        self.mesh = mesh
        self.metric = DistanceMetric.parse(metric)
        self.rerank_dtype = rerank_dtype
        self.codec = codec
        ndev = mesh.shape[DATA_AXIS]
        n = codes.shape[0]
        if n % ndev:
            raise ValueError(f"rows {n} not divisible by data axis {ndev}; "
                             "pad to a power-of-two bucket first")
        shard = lambda a, nd: jax.device_put(
            a, NamedSharding(mesh, P(DATA_AXIS, *([None] * (nd - 1)))))
        rep = lambda a: jax.device_put(a, NamedSharding(mesh, P()))
        self.codes = shard(codes, 2)
        self.vsq, self.rinv = shard(vsq, 1), shard(rinv, 1)
        self.vectors = shard(vectors, 2)
        self.valid = shard(valid, 1)
        self.vmin, self.scale = rep(vmin), rep(scale)
        self._fns = {}

    @classmethod
    def from_scan(cls, mesh: Mesh, scan) -> "ShardedInt8":
        """Shard a quant.scan.QuantizedScan (kind in int8/int4) across
        ``mesh``: the int4 rows move half the per-shard coarse bytes."""
        if scan.kind not in ("int8", "int4"):
            raise ValueError(f"ShardedInt8 requires an int8/int4 scan, "
                             f"got {scan.kind!r}")
        if not hasattr(scan, "_sq_stats"):
            scan._sq_stats = scan.quantizer.corpus_stats(scan.codes)
        vsq, rinv = scan._sq_stats
        n = scan.codes.shape[0]
        store = scan._store
        ndev = mesh.shape[DATA_AXIS]
        pad = (-n) % ndev
        codes = np.asarray(scan.codes)
        vecs = np.asarray(store.vectors[:n])
        valid = np.asarray(store.valid[:n])
        # rows appended AFTER the snapshot build carry garbage codes
        # (QuantizedScan.search guards with arange < built_count); mask
        # them here too or the sharded coarse scan ranks them by bogus
        # distances
        if scan.built_count < n:
            valid = valid.copy()
            valid[scan.built_count:] = False
        vsq, rinv = np.asarray(vsq), np.asarray(rinv)
        if pad:
            codes = np.pad(codes, ((0, pad), (0, 0)))
            vecs = np.pad(vecs, ((0, pad), (0, 0)))
            valid = np.pad(valid, (0, pad))
            vsq = np.pad(vsq, (0, pad))
            rinv = np.pad(rinv, (0, pad))
        dtype_name = ("bfloat16"
                      if getattr(scan, "compute_dtype", "float32")
                      == "bfloat16" else "float32")
        return cls(mesh, codes, np.asarray(scan.quantizer.vmin),
                   np.asarray(scan.quantizer.scale), vsq, rinv,
                   vecs.astype(jnp.dtype(dtype_name)), valid,
                   metric=scan.metric, rerank_dtype=dtype_name,
                   codec=scan.kind)

    def search(self, queries, k: int, rerank: int = 4
               ) -> Tuple[np.ndarray, np.ndarray]:
        q = jnp.asarray(np.ascontiguousarray(queries, dtype=np.float32))
        c = max(k * max(rerank, 1), k)
        key = (k, c)
        if key not in self._fns:
            self._fns[key] = build_sharded_int8_search(
                self.mesh, metric=self.metric, k=k, c=c,
                rerank_dtype=self.rerank_dtype, codec=self.codec)
        d, r = self._fns[key](q, self.codes, self.vmin, self.scale,
                              self.vsq, self.rinv, self.vectors, self.valid)
        return np.asarray(d), np.asarray(r)
