"""IVF-PQ — coarse inverted file over product-quantized residual codes.

Composes the two structures the reference keeps separate (hnswlib ANN,
vectordb_optimized.py:271-280, and ProductQuantizer, quantization.py:
414-615) into the classic IVF-PQ layout, redesigned for the device:

  * the coarse router is the same balanced k-means + cell-major layout as
    ann/ivf.py, but cells hold **PQ codes of residuals** (one uint8 per
    subspace: M bytes a row instead of 2·D for bf16 cells) — a 1M x 768
    corpus's cell table drops from 1.5 GB to 192 MB at the 4-bit default
    (M=D/4; codes are stored unpacked) or 96 MB at 8-bit M=D/8, so 10M+
    corpora serve entirely from device memory;
  * scoring avoids per-(query, cell) lookup tables: with residual
    decomposition  q·x̂ = q·centroid + Σ_m q_m·codebook[m, code_m],
    the ADC table is **cell-independent** — one (B, M, K) einsum per
    batch (a matmul), the routing matmul already supplies q·centroid,
    and per-row reconstruction norms are precomputed at build time, so
    cosine / L2 / dot all reduce to the same three tensors;
  * the only gather is the LUT ADC sum over probed candidates, flattened
    to a single take_along_axis on a (B, M·K) table;
  * an optional exact re-rank stage (same _rerank_body as quant/scan.py)
    restores recall lost to PQ approximation, fused into the one dispatch.

Memory per row: M bytes (codes, unpacked) + 4 (norm) + 4 (row id) —
200 B at the 4-bit default (M=192, d=768) vs 3072 B f32 / 1536 B bf16:
~8-15x compression on the scanned axis (~15-30x with 8-bit M=D/8 codes,
which score via the slower gather path).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import DistanceMetric
from ..kernels.distances import MASKED
from ..quant.kmeans import kmeans_fit
from ..quant.product import _encode as _pq_encode
from .ivf import _assign_topm, _balanced_assignment, _pow2_at_least


@functools.partial(jax.jit, static_argnames=("chunk",))
def _recon_norms(codes: jnp.ndarray, codebooks: jnp.ndarray,
                 base: jnp.ndarray, *, chunk: int = 16384) -> jnp.ndarray:
    """||base + decode(codes)||^2 per row, chunked.  codes (N, M) uint8,
    codebooks (M, K, ds), base (N, D) f32 (the assigned centroids)."""
    n, m = codes.shape
    d = base.shape[1]
    pad = (-n) % chunk
    codes_p = jnp.pad(codes, ((0, pad), (0, 0))) if pad else codes
    base_p = jnp.pad(base, ((0, pad), (0, 0))) if pad else base

    def body(_, xs):
        c, b = xs  # (chunk, M) uint8, (chunk, D)
        dec = jax.vmap(
            lambda cb, col: jnp.take(cb, col.astype(jnp.int32), axis=0),
            in_axes=(0, 1))(codebooks, c)          # (M, chunk, ds)
        xhat = b + jnp.moveaxis(dec, 0, 1).reshape(-1, d)
        return None, jnp.einsum("nd,nd->n", xhat, xhat,
                                preferred_element_type=jnp.float32,
                                precision=jax.lax.Precision.HIGHEST)

    _, out = jax.lax.scan(body, None,
                          (codes_p.reshape(-1, chunk, m),
                           base_p.reshape(-1, chunk, d)))
    return out.reshape(-1)[:n]


def _adc_sum(lut, codes_g, m, kk, b, nprobe, cmax):
    """ADC cross-products for the probed blocks: adc[b, p, c] =
    Σₘ lut[b, m, codes_g[b, p, c, m]].

    Two lowerings:
      * ``kk <= 32`` (the 4-bit default): expand codes to a one-hot and
        contract with a bf16 matmul — ``einsum('bpcmk,bmk->bpc')``.  The
        one-hot is (B·P·cmax·M·kk) bf16, streamed once, and avoids a
        per-element gather.
      * ``kk > 32``: the flat take_along_axis gather (one-hot memory
        would blow up at K=256).
    """
    if kk <= 32:
        iota = jnp.arange(kk, dtype=codes_g.dtype)
        onehot = (codes_g[..., None] == iota).astype(jnp.bfloat16)
        return jnp.einsum("bpcmk,bmk->bpc", onehot,
                          lut.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)
    lut_flat = lut.reshape(b, m * kk)
    offs = (jnp.arange(m, dtype=jnp.int32) * kk)
    idx = codes_g.astype(jnp.int32) + offs[None, None, None, :]
    return jnp.sum(jnp.take_along_axis(
        lut_flat, idx.reshape(b, -1), axis=1
    ).reshape(b, nprobe * cmax, m), axis=2).reshape(b, nprobe, cmax)


def _pq_route(qf, centroids, metric):
    """Shared stage 1: route queries to cells, keeping the raw q-centroid
    cross-products (they are half of every candidate's score under the
    residual decomposition)."""
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
    return qc, route


def _grouped_pq_candidates(qf, qc, probe, codes_t, codebooks, norms,
                           row_table, ok_cells, *, metric, qcap: int):
    """Cell-major ADC scoring for the grouped IVF-PQ dispatch.

    The per-query kernel's stage 3 (`_adc_sum`) expands a one-hot of every
    PROBED COPY of a cell's codes — (B, nprobe, cmax, M, K) bf16, ~37 MB
    per query at the 1M defaults, which caps sub-batches at ~56 queries.
    Cell-major, each probed cell's codes are expanded ONCE per batch and
    contracted against the flattened ADC tables of all queries probing it:

        cross[u, s, c] = lutq[u, s, :] . onehot(codes[cell_u])[:, c]

    one (qcap, M*K) x (M*K, cmax) bf16 matmul per probed cell, with the
    one-hot materialized for a small chunk of cells at a time.
    The q-centroid term, reconstruction norms, and validity are applied at
    the regroup stage over per-pair rows (row gathers, not element
    gathers).  Returns (cand_vals (B, nprobe*cmax) f32 lower=better — L2
    in the SQUARED domain — cand_rows, dropped).
    """
    from .ivf_grouped import invert_pairs
    b, d = qf.shape
    nlist, m, cmax = codes_t.shape
    kk = codebooks.shape[1]
    mk = m * kk
    nprobe = probe.shape[1]
    pairs = invert_pairs(probe, nlist, qcap)

    # cell-independent ADC tables, flattened per query: (B, M*K)
    qsub = qf.reshape(b, m, d // m)
    lut = jnp.einsum("bmd,mkd->bmk", qsub, codebooks,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    lut_flat = lut.reshape(b, mk).astype(jnp.bfloat16)
    u = pairs["slot_qc"].shape[0]
    lutq = jnp.take(lut_flat, pairs["slot_qc"].reshape(-1),
                    axis=0).reshape(u, qcap, mk)

    # one-hot materialized per small chunk of compact cells
    cu = 8
    upad = (-u) % cu
    compact_p = jnp.pad(pairs["compact"], (0, upad))
    lutq_p = jnp.pad(lutq, ((0, upad), (0, 0), (0, 0)))
    iota_k = jnp.arange(kk, dtype=jnp.int32)

    def blk(xs):
        cc, lq = xs                       # (cu,) int32, (cu, qcap, mk)
        cod = jnp.take(codes_t, cc, axis=0).astype(jnp.int32)
        oh = (cod[:, :, None, :] == iota_k[None, None, :, None]
              ).astype(jnp.bfloat16)      # (cu, M, K, cmax)
        return jax.lax.dot_general(
            lq, oh.reshape(cu, mk, cmax),
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST)

    s = jax.lax.map(blk, (compact_p.reshape(-1, cu),
                          lutq_p.reshape(-1, cu, qcap, mk)))
    s = s.reshape(-1, qcap, cmax)[:u]

    # ---- regroup + metric epilogue over per-pair rows -------------------
    flat_cell = pairs["flat_cell"]
    flat_slot = (pairs["cid_pair"] * qcap
                 + jnp.minimum(pairs["pair_rank"], qcap - 1))
    pv = jnp.take(s.reshape(u * qcap, cmax), flat_slot, axis=0)  # (Mp, cmax)
    qc_pair = jnp.take_along_axis(qc, probe, axis=1).reshape(-1)
    cross = pv + qc_pair[:, None]
    rn = jnp.take(norms, flat_cell, axis=0)                      # (Mp, cmax)
    rok = jnp.take(ok_cells, flat_cell, axis=0)
    qsq = jnp.einsum("bd,bd->b", qf, qf, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    if metric == DistanceMetric.COSINE:
        qinv_pair = jnp.take(1.0 / jnp.maximum(jnp.sqrt(qsq), 1e-30),
                             pairs["flat_q"])
        sc = 1.0 - cross * qinv_pair[:, None] * jax.lax.rsqrt(
            jnp.maximum(rn, 1e-30))
    elif metric == DistanceMetric.L2:
        qsq_pair = jnp.take(qsq, pairs["flat_q"])
        sc = jnp.maximum(qsq_pair[:, None] + rn - 2.0 * cross, 0.0)
    else:
        sc = -cross
    sc = jnp.where(pairs["pair_keep"][:, None] & rok, sc, MASKED)
    cand_vals = sc.reshape(b, nprobe * cmax)
    cand_rows = jnp.take(row_table, flat_cell,
                         axis=0).reshape(b, nprobe * cmax)
    return cand_vals, cand_rows, pairs["dropped"]


@functools.partial(jax.jit, static_argnames=(
    "metric", "k", "nprobe", "qcap", "rerank", "compute_dtype"))
def _grouped_ivfpq_search_kernel(
    q: jnp.ndarray,            # (B, D) f32
    centroids: jnp.ndarray,    # (nlist, D) f32
    codebooks: jnp.ndarray,    # (M, K, ds) f32
    codes_t: jnp.ndarray,      # (nlist, M, cmax) uint8 TRANSPOSED codes
    norms: jnp.ndarray,        # (nlist, cmax) f32 reconstruction sq-norms
    row_table: jnp.ndarray,    # (nlist, cmax) int32, -1 = padding
    overflow_vecs: jnp.ndarray,
    overflow_rows: jnp.ndarray,
    ok_cells: jnp.ndarray,     # (nlist, cmax) bool
    ok_overflow: jnp.ndarray,  # (O,) bool
    vectors: Optional[jnp.ndarray],  # (cap, D) — rerank source
    *,
    metric: DistanceMetric,
    k: int,
    nprobe: int,
    qcap: int,
    rerank: int,
    compute_dtype: str = "bfloat16",
):
    """Grouped (cell-major) IVF-PQ search: returns (dists (B, k) f32,
    rows (B, k) int32, dropped () int32).  Same candidate set as
    _ivfpq_search_kernel when qcap sheds nothing (cells partition the
    corpus, so per-cell scoring + per-query merge is a reordering of the
    flat per-query scan)."""
    from .ivf_grouped import finish_grouped
    qf = q.astype(jnp.float32)
    qc, route = _pq_route(qf, centroids, metric)
    _, probe = jax.lax.top_k(route, nprobe)
    cand_vals, cand_rows, dropped = _grouped_pq_candidates(
        qf, qc, probe, codes_t, codebooks, norms, row_table, ok_cells,
        metric=metric, qcap=qcap)
    vals, rows = finish_grouped(
        qf, cand_vals, cand_rows, overflow_vecs, overflow_rows,
        ok_overflow, vectors, metric=metric, k=k, rerank=rerank,
        compute_dtype=compute_dtype)
    return vals, rows, dropped


@functools.partial(jax.jit, static_argnames=(
    "metric", "k", "c", "nprobe", "rerank_dtype", "do_rerank"))
def _ivfpq_search_kernel(
    q: jnp.ndarray,            # (B, D) f32
    centroids: jnp.ndarray,    # (nlist, D) f32
    codebooks: jnp.ndarray,    # (M, K, ds) f32 residual codebooks
    codes: jnp.ndarray,        # (nlist, cmax, M) uint8 cell-major PQ codes
    norms: jnp.ndarray,        # (nlist, cmax) f32 reconstruction sq-norms
    row_table: jnp.ndarray,    # (nlist, cmax) int32, -1 = padding
    overflow_vecs: jnp.ndarray,  # (O, D) f32 (O may be 0)
    overflow_rows: jnp.ndarray,  # (O,) int32
    ok_cells: jnp.ndarray,     # (nlist, cmax) bool — slot live (padding AND
                               #   tombstones AND filter pre-applied)
    ok_overflow: jnp.ndarray,  # (O,) bool — same, for the overflow block
    vectors: jnp.ndarray,      # (cap, D) store vectors (re-rank source)
    *,
    metric: DistanceMetric,
    k: int,
    c: int,                    # candidates kept before re-rank
    nprobe: int,
    rerank_dtype: str = "bfloat16",
    do_rerank: bool = True,
):
    b, d = q.shape
    nlist, cmax, m = codes.shape
    kk = codebooks.shape[1]
    qf = q.astype(jnp.float32)

    # ---- stage 1: route (and keep q·centroid — it is half the score) ----
    qc, route = _pq_route(qf, centroids, metric)
    _, probe = jax.lax.top_k(route, nprobe)            # (B, nprobe)

    # ---- stage 2: cell-independent ADC table (one einsum) ---------------
    qsub = qf.reshape(b, m, d // m)
    lut = jnp.einsum("bmd,mkd->bmk", qsub, codebooks,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)  # (B, M, K)

    # ---- stage 3: gather probed code blocks, ADC-sum the cross products -
    codes_g = jnp.take(codes, probe, axis=0)           # (B, P, cmax, M) u8
    norms_g = jnp.take(norms, probe, axis=0).reshape(b, -1)
    cand = jnp.take(row_table, probe, axis=0).reshape(b, -1)
    # per-slot validity rides the same contiguous cell-row gather; the
    # caller precomputes ok_cells once per validity epoch instead of an
    # element gather from a (cap,) mask per call
    ok = jnp.take(ok_cells, probe, axis=0).reshape(b, -1)
    adc = _adc_sum(lut, codes_g, m, kk, b, nprobe, cmax)
    qc_g = jnp.take_along_axis(
        qc, probe, axis=1)[:, :, None]                 # (B, P, 1) q·centroid
    cross = (qc_g + adc.reshape(b, nprobe, cmax)).reshape(b, -1)

    qsq = jnp.einsum("bd,bd->b", qf, qf, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    qinv = 1.0 / jnp.maximum(jnp.sqrt(qsq[:, None]), 1e-30)

    def metric_scores(vsq, xr):
        if metric == DistanceMetric.COSINE:
            rinv = jax.lax.rsqrt(jnp.maximum(vsq, 1e-30))
            return 1.0 - xr * qinv * rinv
        if metric == DistanceMetric.L2:
            return jnp.sqrt(jnp.maximum(qsq[:, None] + vsq - 2.0 * xr, 0.0))
        return -xr

    s = metric_scores(norms_g, cross)

    if overflow_rows.shape[0] > 0:
        ovsq = jnp.einsum("od,od->o", overflow_vecs, overflow_vecs,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
        ocross = jax.lax.dot_general(
            qf, overflow_vecs, dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST)
        s = jnp.concatenate([s, metric_scores(ovsq[None, :], ocross)], axis=1)
        cand = jnp.concatenate(
            [cand, jnp.broadcast_to(overflow_rows[None],
                                    (b, overflow_rows.shape[0]))], axis=1)
        ok = jnp.concatenate(
            [ok, jnp.broadcast_to(ok_overflow[None],
                                  (b, overflow_rows.shape[0]))], axis=1)

    safe = jnp.maximum(cand, 0)
    s = jnp.where(ok, s, MASKED)

    if not do_rerank:
        neg, pos = jax.lax.top_k(-s, k)
        return -neg, jnp.take_along_axis(cand, pos, axis=1)

    # ---- stage 4: exact re-rank of the PQ top-c against store rows ------
    from ..quant.scan import _rerank_body
    cneg, cpos = jax.lax.top_k(-s, c)
    crows = jnp.take_along_axis(safe, cpos, axis=1)
    cok = -cneg < MASKED * 0.5
    cand_vecs = jnp.take(vectors, crows, axis=0)       # (B, c, D)
    return _rerank_body(qf, cand_vecs, crows, cok, metric, k, rerank_dtype)


class IVFPQIndex:
    """Inverted-file product-quantized index over a collection's store.

    Same serving contract as ann/ivf.py's IVFIndex (search / mark_stale /
    export_sections), at ~1/16th the device memory of the bf16 cell table.
    """

    def __init__(self, centroids, codebooks, codes, norms, row_table,
                 overflow_vecs, overflow_rows, collection, nprobe: int,
                 rerank: int = 8):
        self.centroids = centroids
        self.codebooks = codebooks          # (M, K, ds)
        self.codes = codes                  # (nlist, cmax, M) uint8
        self.norms = norms                  # (nlist, cmax) f32
        self.row_table = row_table
        self.overflow_vecs = overflow_vecs
        self.overflow_rows = overflow_rows
        self._collection = collection
        self.nprobe = nprobe
        self.rerank = rerank                # candidate factor c = rerank*k
        self.stale = False
        self._built_count = collection._store.count
        self._built_n_valid = collection._store.n_valid

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, collection, nlist: Optional[int] = None,
              nprobe: Optional[int] = None, m: Optional[int] = None,
              pq_k: int = 256,
              iters: int = 10, pq_iters: int = 12, seed: int = 0,
              max_cell_factor: float = 1.5, spill_choices: int = 8,
              train_sample: int = 200_000, rerank: int = 16) -> "IVFPQIndex":
        """Defaults are classic 8-bit PQ: K=256 centroids per subspace
        with M = D/8 subspaces (96 bytes/row at 768-d — 32x vs f32).

        A codebook-quality comparison (50k clustered rows, routing
        factored out): at EQUAL bits the K=256
        codebooks order candidates ~2x better than the K=16 4-bit layout
        the earlier rounds shipped — quantization-error/residual-variance
        0.295 (m=D/8, K=256) vs 0.366 (m=D/4, K=16) at HALF the bytes,
        and 0.099 for m=D/4 K=256 at equal bytes (rr3 recall 0.988 vs
        0.927).  More Lloyd iterations do NOT help (iters=30 ≈ iters=12):
        the 4-bit layout's low recall without re-rank is a
        bits-per-codeword floor, not a convergence artifact.  The reference's 90-95% recall@10 claim
        (/root/reference/README.md:508, quantization.py:414-615) is for
        exactly this K=256 geometry.

        Both K regimes score with a matmul: the grouped dispatch
        one-hot-expands each probed cell's codes once per batch — the
        contraction width is M*K (24,576 at the default; _search_grouped bounds the
        per-sub-batch slot-LUT tensor so large M*K cannot OOM).  Pass
        pq_k=16, m=D/4 for the legacy 4-bit layout (lowest ADC FLOPs,
        needs a deep exact rerank to serve >=0.95 recall)."""
        store = collection._store
        n = store.count
        if n == 0:
            raise ValueError("cannot build IVF-PQ over an empty collection")
        d = store.vectors.shape[1]
        if m is None:
            m = max(1, d // 4) if pq_k <= 32 else max(1, d // 8)
        if d % m != 0:
            # snap M down to the nearest divisor of D
            while d % m:
                m -= 1
        vectors = store.vectors[:n].astype(jnp.float32)
        if nlist is None:
            nlist = int(min(max(int(math.sqrt(n)) * 2, 8), 8192,
                            max(n // 4, 1)))
        nlist = max(1, min(nlist, n))
        if nprobe is None:
            nprobe = max(1, min(nlist, collection.config.ivf_nprobe))
        centroids = kmeans_fit(vectors, jax.random.PRNGKey(seed), k=nlist,
                               iters=iters,
                               chunk=int(min(16384, _pow2_at_least(n))))
        topm = np.asarray(_assign_topm(vectors, centroids,
                                       m=min(spill_choices, nlist)))
        # capacity rounds to a 128 multiple when the corpus fills it (a
        # matmul-friendly width); tiny test builds keep the 8-multiple
        # floor so cells don't dwarf the corpus
        raw_cap = int(max_cell_factor * n / nlist)
        if raw_cap >= 128:
            cap = -(-raw_cap // 128) * 128
        else:
            cap = int(max(8, (raw_cap + 7) // 8 * 8))
        table, counts, overflow = _balanced_assignment(topm, nlist, cap)

        # assigned centroid per row (for residuals); overflow rows excluded
        cell_of = np.full(n, -1, np.int64)
        flat = table.reshape(-1)
        owner = np.repeat(np.arange(nlist, dtype=np.int64), cap)
        live = flat >= 0
        cell_of[flat[live]] = owner[live]
        assigned = np.nonzero(cell_of >= 0)[0]

        # shared residual codebooks (M x K x ds) — a single vmapped k-means
        # over a training-sample residual block only
        t = min(train_sample, assigned.size)
        base_t = jnp.take(centroids, jnp.asarray(cell_of[assigned[:t]]),
                          axis=0)
        rs = np.asarray(jnp.take(vectors, jnp.asarray(assigned[:t]),
                                 axis=0) - base_t)
        del base_t
        sub = jnp.moveaxis(jnp.asarray(rs).reshape(-1, m, d // m), 1, 0)
        keys = jax.random.split(jax.random.PRNGKey(seed + 1), m)
        codebooks = jax.vmap(
            lambda x, key: kmeans_fit(x, key, k=pq_k, iters=pq_iters,
                                      chunk=min(16384, max(256,
                                                           sub.shape[1]))))(
            sub, keys)
        del sub

        # encode + reconstruction norms in HOST-chunked passes: a single
        # full-corpus pass would hold base+resid+pad copies (3 x N x D f32
        # = ~9 GB at 1Mx768) on top of the corpus.  Chunking at the host
        # level bounds the peak to one block.
        enc_chunk = 131_072
        rcodes = np.empty((assigned.size, m), np.uint8)
        rnorms = np.empty((assigned.size,), np.float32)
        for s in range(0, assigned.size, enc_chunk):
            sl = assigned[s:s + enc_chunk]
            b = jnp.take(centroids, jnp.asarray(cell_of[sl]), axis=0)
            r = jnp.take(vectors, jnp.asarray(sl), axis=0) - b
            cc = _pq_encode(r, codebooks)
            rcodes[s:s + enc_chunk] = np.asarray(cc)
            rnorms[s:s + enc_chunk] = np.asarray(
                _recon_norms(cc, codebooks, b))
            del b, r, cc

        # scatter row-major codes/norms into the cell-major layout
        codes_t = np.zeros((nlist * cap, m), np.uint8)
        norms_t = np.zeros((nlist * cap,), np.float32)
        pos_of = np.full(n, -1, np.int64)              # row -> flat slot
        pos_of[flat[live]] = np.nonzero(live)[0]
        slots = pos_of[assigned]
        codes_t[slots] = np.asarray(rcodes)
        norms_t[slots] = np.asarray(rnorms)

        opad = (-overflow.size) % 8
        orows = np.concatenate([overflow, np.full(opad, -1, np.int32)]) \
            if (overflow.size or opad) else overflow
        # overflow is scanned exactly in f32; cells live as uint8 codes
        ovecs = (jnp.take(vectors, jnp.maximum(jnp.asarray(orows), 0),
                          axis=0).astype(jnp.float32)
                 if orows.size else jnp.zeros((0, d), jnp.float32))
        idx = cls(centroids, codebooks,
                  jnp.asarray(codes_t).reshape(nlist, cap, m),
                  jnp.asarray(norms_t).reshape(nlist, cap),
                  jnp.asarray(table), ovecs, jnp.asarray(orows),
                  collection, nprobe, rerank=rerank)
        idx._cell_counts = counts
        return idx

    # ------------------------------------------------------------------
    def _codes_t_cached(self) -> jnp.ndarray:
        """(nlist, M, cmax) transposed codes for the grouped dispatch.
        Lazily built and cached on the identity of ``self.codes`` (+1x
        codes bytes while the grouped path is in use)."""
        memo = getattr(self, "_codes_t_memo", None)
        if memo is None or memo[0] is not self.codes:
            memo = (self.codes, jnp.swapaxes(self.codes, 1, 2))
            self._codes_t_memo = memo
        return memo[1]

    def _search_grouped(self, q: np.ndarray, k: int, okc, oko, nprobe: int,
                        rerank: int, qcap: Optional[int] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Cell-major batched dispatch: each probed cell's PQ codes are
        one-hot-expanded ONCE per batch and contracted against the
        ADC tables of every query probing the cell (see
        _grouped_pq_candidates)."""
        store = self._collection._store
        cfg = self._collection.config
        nlist, cmax = self.row_table.shape
        m = self.codes.shape[2]
        kk = self.codebooks.shape[1]
        codes_t = self._codes_t_cached()
        from .ivf_grouped import grouped_qcap
        # sub-batch bound: the (U, qcap, cmax) f32 score tensor and the
        # (U, qcap, M*K) bf16 slot-LUT tensor both scale with U <= b*nprobe
        qcap_mem = max(8, int((2 << 30) // max(nlist * cmax * 4, 1)))
        sub_score = max(8, (qcap_mem * nlist) // (4 * nprobe) // 8 * 8)
        sub_lut = max(8, int((2 << 30) // max(nprobe * 32 * m * kk * 2, 1))
                      // 8 * 8)
        sub_max = min(sub_score, sub_lut)
        outs_d, outs_r = [], []
        self.last_dropped = 0
        for s in range(0, q.shape[0], sub_max):
            subq = q[s: s + sub_max]
            real = subq.shape[0]
            pad = (-real) % 8
            if pad:
                subq = np.pad(subq, ((0, pad), (0, 0)))
            sub_qcap = (min(qcap, qcap_mem) if qcap is not None else
                        grouped_qcap(subq.shape[0], nprobe, nlist, cmax))
            ncand = nprobe * cmax + int(self.overflow_rows.shape[0])
            dd, rr_, dropped = _grouped_ivfpq_search_kernel(
                jnp.asarray(subq), self.centroids, self.codebooks, codes_t,
                self.norms, self.row_table, self.overflow_vecs,
                self.overflow_rows, okc, oko,
                store.vectors if rerank > 0 else None,
                metric=cfg.metric, k=min(k, ncand), nprobe=nprobe,
                qcap=int(sub_qcap), rerank=rerank,
                compute_dtype=cfg.compute_dtype)
            self.last_dropped += int(dropped)
            outs_d.append(np.asarray(dd)[:real])
            outs_r.append(np.asarray(rr_)[:real])
        return np.concatenate(outs_d), np.concatenate(outs_r)

    def search(self, queries: np.ndarray, k: int,
               mask: Optional[np.ndarray] = None, overfetch: int = 1,
               nprobe: Optional[int] = None, rerank: Optional[int] = None,
               max_query_batch: int = 256,
               grouped: Optional[bool] = None,
               qcap: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        if self.stale:
            self.__dict__.update(self.rebuilt().__dict__)
        store = self._collection._store
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        nprobe = int(min(nprobe or self.nprobe, self.centroids.shape[0]))
        if mask is not None and overfetch > 1:
            nprobe = int(min(self.centroids.shape[0], nprobe * overfetch))
        from .ivf import ok_slot_masks
        # host mask passes straight through: the filtered slot gather is
        # memoized per (mask identity, store version) in ok_slot_masks
        okc, oko = ok_slot_masks(
            self, np.ascontiguousarray(mask, dtype=bool)
            if mask is not None and not isinstance(mask, np.ndarray)
            else mask)
        cfg = self._collection.config
        rr = rerank if rerank is not None else self.rerank
        # large batches go cell-major (same crossover as ann/ivf.py): once
        # b*nprobe rivals nlist, reading each probed cell once and
        # batching its queries beats per-query code gathers — and the PQ
        # one-hot is built per cell instead of streaming (B, P, cmax, M, K)
        if grouped is None:
            grouped = q.shape[0] * nprobe >= self.centroids.shape[0]
        if grouped:
            return self._search_grouped(q, k, okc, oko, nprobe,
                                        rerank=int(rr), qcap=qcap)
        ncand = nprobe * self.row_table.shape[1] + \
            int(self.overflow_rows.shape[0])
        c = int(min(max(k, k * rr), ncand))
        # bound per-dispatch memory: stage 3 materializes an int32 index
        # tensor and an f32 ADC gather of shape (b, nprobe*cmax*M) — cap
        # the sub-batch so those two stay under ~2 GB (same guard as
        # ann/ivf.py; a filtered overfetch multiplies nprobe and would
        # otherwise run out of device memory at large batch)
        cmax = self.row_table.shape[1]
        m = self.codes.shape[2]
        kk = self.codebooks.shape[1]
        # one-hot path streams a (b, nprobe, cmax, m, kk) bf16 tensor;
        # gather path materializes int32 idx + f32 gathered values
        per_q = max(nprobe * cmax * m * (2 * kk if kk <= 32 else 8), 1)
        safe_b = max(8, int((2 << 30) // per_q) // 8 * 8)
        max_query_batch = int(min(max_query_batch, safe_b))
        outs_d, outs_r = [], []
        for s in range(0, q.shape[0], max_query_batch):
            sub = q[s: s + max_query_batch]
            real = sub.shape[0]
            pad = (-real) % min(max_query_batch, 8)
            if pad:
                sub = np.pad(sub, ((0, pad), (0, 0)))
            dd, r = _ivfpq_search_kernel(
                jnp.asarray(sub), self.centroids, self.codebooks, self.codes,
                self.norms, self.row_table, self.overflow_vecs,
                self.overflow_rows, okc, oko, store.vectors,
                metric=cfg.metric, k=min(k, ncand), c=c, nprobe=nprobe,
                rerank_dtype=cfg.compute_dtype, do_rerank=rr > 0)
            outs_d.append(np.asarray(dd)[:real])
            outs_r.append(np.asarray(r)[:real])
        return np.concatenate(outs_d), np.concatenate(outs_r)

    # ------------------------------------------------------------------
    def mark_stale(self) -> None:
        self.stale = True

    def rebuilt(self) -> "IVFPQIndex":
        """A fresh index built with this index's recipe (build kwargs +
        runtime-tuned nprobe/rerank) over the collection's current rows;
        shared by the stale path and Collection's background rebuild."""
        kw = dict(getattr(self, "_build_kwargs", {}))
        kw.setdefault("nlist", self.centroids.shape[0])
        kw.setdefault("m", self.codes.shape[2])
        kw.setdefault("pq_k", self.codebooks.shape[1])
        kw["nprobe"] = self.nprobe
        kw["rerank"] = self.rerank
        return IVFPQIndex.build(self._collection, **kw)

    def stats(self) -> dict:
        counts = getattr(self, "_cell_counts", None)
        return {
            "kind": "ivfpq",
            "nlist": int(self.centroids.shape[0]),
            "cmax": int(self.row_table.shape[1]),
            "m": int(self.codes.shape[2]),
            "pq_k": int(self.codebooks.shape[1]),
            "nprobe": self.nprobe,
            "rerank": self.rerank,
            "built_count": self._built_count,
            "codes_bytes": int(self.codes.size),
            "overflow_rows": int((np.asarray(self.overflow_rows) >= 0).sum())
            if self.overflow_rows.size else 0,
            "cell_balance": (float(counts.std() / max(counts.mean(), 1e-9))
                             if counts is not None else None),
        }

    def memory_usage(self) -> dict:
        n = self._built_count
        d = self.centroids.shape[1]
        orig = n * d * 4
        quant = (self.codes.size + self.norms.size * 4
                 + self.row_table.size * 4 + self.codebooks.size * 4
                 + self.centroids.size * 4)
        return {"original_bytes": orig, "index_bytes": int(quant),
                "compression_ratio": orig / max(quant, 1)}

    # -- persistence ---------------------------------------------------
    def export_sections(self) -> tuple:
        """(sections, meta) for the collection's FPVT container.  Codes,
        norms and tables persist verbatim (they cannot be rebuilt from the
        store without re-running k-means)."""
        return ({"ann_centroids": np.asarray(self.centroids),
                 "ann_codebooks": np.asarray(self.codebooks),
                 "ann_pq_codes": np.asarray(self.codes).reshape(
                     -1, self.codes.shape[2]),
                 "ann_pq_norms": np.asarray(self.norms).reshape(-1, 1),
                 "ann_row_table": np.asarray(self.row_table),
                 "ann_overflow_rows": np.asarray(self.overflow_rows)},
                {"kind": "ivfpq", "nprobe": self.nprobe,
                 "rerank": self.rerank, "built_count": self._built_count,
                 "nlist": int(self.centroids.shape[0]),
                 "cmax": int(self.row_table.shape[1])})

    @classmethod
    def from_sections(cls, collection, sections: dict, meta: dict
                      ) -> "IVFPQIndex":
        nlist, cmax = int(meta["nlist"]), int(meta["cmax"])
        centroids = jnp.asarray(np.asarray(sections["ann_centroids"]))
        codebooks = jnp.asarray(np.asarray(sections["ann_codebooks"]))
        codes = jnp.asarray(np.asarray(
            sections["ann_pq_codes"]).reshape(nlist, cmax, -1))
        norms = jnp.asarray(np.asarray(
            sections["ann_pq_norms"]).reshape(nlist, cmax))
        table = jnp.asarray(np.asarray(sections["ann_row_table"]))
        orows = jnp.asarray(np.asarray(sections.get(
            "ann_overflow_rows", np.zeros(0, np.int32))))
        store = collection._store
        ovecs = (jnp.take(store.vectors, jnp.maximum(orows, 0),
                          axis=0).astype(jnp.float32)
                 if orows.size else
                 jnp.zeros((0, store.vectors.shape[1]), jnp.float32))
        idx = cls(centroids, codebooks, codes, norms, table, ovecs, orows,
                  collection, int(meta["nprobe"]),
                  rerank=int(meta.get("rerank", 8)))
        idx._built_count = int(meta["built_count"])
        idx.stale = idx._built_count > collection._store.count
        return idx

    def tune(self, queries: np.ndarray, target_recall: float = 0.95,
             k: int = 10, max_nprobe: Optional[int] = None,
             max_rerank: int = 64) -> Tuple[int, int, float]:
        """Jointly tune (nprobe, rerank) against exact ground truth.

        Escalates the cheaper knob first (nprobe doubles — more cells
        probed), then deepens the re-rank candidate pool when routing
        alone saturates (the usual PQ limiter: the true neighbor is in a
        probed cell but its approximate ADC rank falls outside the
        candidate cut).  Installs and returns the chosen settings plus the
        achieved recall."""
        store = self._collection._store
        cfg = self._collection.config
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        _, exact_r = store.search(q, k, cfg.metric,
                                  compute_dtype=cfg.compute_dtype)
        limit = max_nprobe or self.centroids.shape[0]
        npb = max(1, self.nprobe)
        rr = max(4, self.rerank)
        while True:
            _, rows = self.search(q, k, nprobe=npb, rerank=rr)
            rec = float(np.mean(
                [len(set(a.tolist()) & set(e.tolist())) / k
                 for a, e in zip(rows, exact_r)]))
            if rec >= target_recall or (npb >= limit and rr >= max_rerank):
                self.nprobe, self.rerank = int(npb), int(rr)
                return int(npb), int(rr), rec
            if npb < limit:
                npb = min(limit, npb * 2)
            else:
                rr = min(max_rerank, rr * 2)

    def tune_nprobe(self, queries: np.ndarray, target_recall: float = 0.95,
                    k: int = 10, max_nprobe: Optional[int] = None) -> int:
        store = self._collection._store
        cfg = self._collection.config
        _, exact_r = store.search(queries, k, cfg.metric,
                                  compute_dtype=cfg.compute_dtype)
        limit = max_nprobe or self.centroids.shape[0]
        nprobe = max(1, self.nprobe // 4)
        while nprobe <= limit:
            _, r = self.search(queries, k, nprobe=nprobe)
            hits = np.mean([len(set(a.tolist()) & set(e.tolist())) / k
                            for a, e in zip(r, exact_r)])
            if hits >= target_recall:
                self.nprobe = nprobe
                return nprobe
            nprobe *= 2
        self.nprobe = limit
        return limit
