"""Two-stage quantized scan: compressed first pass -> exact f32 re-rank.

This is the device rendition of the reference's hybrid pipelines — BQ/SQ
pre-filter followed by exact re-ranking (parallel_search.py:895-947,
examples/benchmark_quantization.py:321-362) — with both stages on device:

  stage 1: quantized distances over all rows (int8 dequant-matmul, packed
           Hamming, or PQ ADC) + masked top-(k*rerank) candidate selection;
  stage 2: gather the candidates' f32 rows and apply the exact metric,
           then final top-k.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import DistanceMetric
from ..kernels.distances import MASKED
from ..kernels.topk import masked_top_k
from .binary import BinaryQuantizer
from .int4 import Int4Quantizer
from .product import ProductQuantizer
from .scalar import ScalarQuantizer


from ..utils import next_pow2 as _pow2ge  # shared helper


def _coarse_topk(s, mask, k: int):
    """Masked exact top-k (smallest) of a (B, N) coarse score block."""
    if mask is not None:
        s = jnp.where(mask[None, :], s, MASKED)
    neg, rows = jax.lax.top_k(-s, k)
    return -neg, rows


@functools.partial(jax.jit, static_argnames=("metric", "k"))
def _int8_coarse_topk(q, codes, vmin, scale, vsq, rinv, mask, *,
                      metric: DistanceMetric, k: int):
    """Fused int8 scan + masked top-k (the rerank<=1 path)."""
    from .scalar import _distances_int8_matmul
    s = _distances_int8_matmul(q, codes, vmin, scale, vsq, rinv,
                               metric=metric)
    return _coarse_topk(s, mask, k)


@functools.partial(jax.jit, static_argnames=("metric", "k"))
def _int4_coarse_topk(q, codes, vmin, scale, vsq, rinv, mask, *,
                      metric: DistanceMetric, k: int):
    """Fused int4 scan + masked top-k (the BigCollection coarse stage)."""
    from .int4 import _distances_int4_matmul
    s = _distances_int4_matmul(q, codes, vmin, scale, vsq, rinv,
                               metric=metric)
    return _coarse_topk(s, mask, k)


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def _hamming_coarse_topk(qcodes_t, codes_t, mask, *, k: int,
                         chunk: int = 262_144):
    """Packed-Hamming scan + masked top-k, chunked over N with per-chunk
    local top-k and a final merge — bounded memory at any corpus size."""
    w, b = qcodes_t.shape
    n = codes_t.shape[1]
    pad = (-n) % chunk
    codes_p = jnp.pad(codes_t, ((0, 0), (0, pad))) if pad else codes_t
    if mask is None:
        mask = jnp.ones((n,), dtype=bool)
    mask_p = jnp.pad(mask, (0, pad)) if pad else mask
    tiles = codes_p.reshape(w, -1, chunk)
    mtiles = mask_p.reshape(-1, chunk)
    kk = min(k, chunk)

    def body(_, tm):
        tile, m = tm  # (W, chunk), (chunk,)
        # word-by-word accumulation: keeps every intermediate at (B, chunk)
        # so XLA fuses the chain instead of materializing a (W, B, chunk)
        # broadcast in HBM
        acc = jnp.zeros((b, tile.shape[1]), jnp.int32)
        for i in range(w):
            x = jnp.bitwise_xor(qcodes_t[i, :][:, None], tile[i, :][None, :])
            acc = acc + jax.lax.population_count(x.astype(jnp.int32))
        s = jnp.where(m[None, :], acc.astype(jnp.float32), MASKED)
        neg, idx = jax.lax.top_k(-s, kk)
        return None, (-neg, idx)

    _, (vals, idx) = jax.lax.scan(body, None,
                                  (jnp.moveaxis(tiles, 1, 0), mtiles))
    t = vals.shape[0]
    offs = (jnp.arange(t, dtype=jnp.int32) * chunk)[:, None, None]
    vals_f = jnp.moveaxis(vals, 0, 1).reshape(b, t * kk)
    idx_f = jnp.moveaxis(idx + offs, 0, 1).reshape(b, t * kk)
    neg, pos = jax.lax.top_k(-vals_f, min(k, t * kk))
    return -neg, jnp.take_along_axis(idx_f, pos, axis=1)


def _rerank_body(queries, cand_vecs, cand_rows, cand_ok, metric, k,
                 compute_dtype="float32"):
    """Exact-metric re-rank over gathered candidates (trace-level body).

    queries (B, D); cand_vecs (B, C, D); cand_rows (B, C); cand_ok (B, C).
    Returns (dists (B, k), rows (B, k)).  Norm-expansion form — no
    elementwise (B, C, D) temporaries (normalizing or differencing the
    gathered block would materialize a full copy).
    """
    from ..kernels.distances import matmul_precision
    prec = matmul_precision(compute_dtype)
    cd = jnp.dtype(compute_dtype)
    q = queries.astype(jnp.float32)
    vsq = jnp.einsum("bcd,bcd->bc", cand_vecs, cand_vecs,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    cross = jnp.einsum("bd,bcd->bc", q.astype(cd), cand_vecs.astype(cd),
                       preferred_element_type=jnp.float32, precision=prec)
    if metric == DistanceMetric.COSINE:
        qinv = 1.0 / jnp.maximum(jnp.linalg.norm(q, axis=1, keepdims=True),
                                 1e-30)
        rinv = jax.lax.rsqrt(jnp.maximum(vsq, 1e-30))
        s = 1.0 - cross * qinv * rinv
    elif metric == DistanceMetric.L2:
        qsq = jnp.einsum("bd,bd->b", q, q, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        s = jnp.sqrt(jnp.maximum(qsq[:, None] + vsq - 2.0 * cross, 0.0))
    else:
        s = -cross
    s = jnp.where(cand_ok, s, MASKED)
    neg, pos = jax.lax.top_k(-s, k)
    return -neg, jnp.take_along_axis(cand_rows, pos, axis=1)


@functools.partial(jax.jit, static_argnames=("metric", "k"))
def _rerank(queries: jnp.ndarray, cand_vecs: jnp.ndarray,
            cand_rows: jnp.ndarray, cand_ok: jnp.ndarray, *,
            metric: DistanceMetric, k: int):
    """Standalone exact f32 re-rank (HIGHEST precision)."""
    return _rerank_body(queries, cand_vecs, cand_rows, cand_ok, metric, k,
                        compute_dtype="float32")


@functools.partial(jax.jit, static_argnames=(
    "metric", "k", "c", "rerank_dtype"))
def _int8_two_stage(q, codes, vmin, scale, vsq, rinv, vectors, mask, *,
                    metric: DistanceMetric, k: int, c: int,
                    rerank_dtype: str):
    """The ENTIRE int8 two-stage search as one dispatch: s8 x s8 coarse
    scan -> candidate selection -> gather -> exact re-rank -> final
    top-k."""
    from .scalar import _distances_int8_matmul
    s = _distances_int8_matmul(q, codes, vmin, scale, vsq, rinv,
                               metric=metric)
    cvals, crows = _coarse_topk(s, mask, c)
    cand_vecs = jnp.take(vectors, crows, axis=0)  # native storage dtype
    return _rerank_body(q, cand_vecs, crows, cvals < MASKED * 0.5, metric,
                        k, rerank_dtype)


@functools.partial(jax.jit, static_argnames=(
    "metric", "k", "c", "rerank_dtype"))
def _int4_two_stage(q, codes, vmin, scale, vsq, rinv, vectors, mask, *,
                    metric: DistanceMetric, k: int, c: int,
                    rerank_dtype: str):
    """The ENTIRE int4 two-stage search as one dispatch (same stages as
    ``_int8_two_stage`` over the unpacked nibble codes)."""
    from .int4 import _distances_int4_matmul
    s = _distances_int4_matmul(q, codes, vmin, scale, vsq, rinv,
                               metric=metric)
    cvals, crows = _coarse_topk(s, mask, c)
    safe = jnp.minimum(crows, vectors.shape[0] - 1)  # padded rows clip
    cand_vecs = jnp.take(vectors, safe, axis=0)
    return _rerank_body(q, cand_vecs, safe, cvals < MASKED * 0.5, metric,
                        k, rerank_dtype)


class QuantizedScan:
    """Compressed snapshot of a collection's live rows + 2-stage search."""

    # per-dispatch budget for the coarse (B, N) f32 score block.  On the
    # GPU every codec materialises that block as the input of the top-k
    # custom call, so a 4M x B=1024 dispatch would allocate 16 GiB; 4 GiB
    # keeps a 1M x B=1024 batch in one dispatch.
    _score_hbm_budget = 4 << 30

    def __init__(self, kind: str, quantizer, codes: jnp.ndarray,
                 store, metric: DistanceMetric):
        self.kind = kind
        self.quantizer = quantizer
        self.codes = codes
        self._store = store
        self.metric = metric
        # candidate-depth default per codec: int8 ordering is tight (c=4k
        # suffices everywhere measured); 1-bit Hamming needs ~32x deeper
        # pools on clustered corpora (a sweep at 1M x 768 gave recall@10
        # 0.50 at rr16, 0.92 at rr64, 0.97 at rr128).  tune_rerank
        # overrides per corpus.
        # int4's 16-level ordering sits between int8's (tight, rr=4) and
        # binary's (collapses on clusters, rr=128); rr=8 is the default
        # and tune_rerank overrides per corpus
        self.default_rerank = {"int8": 4, "int4": 8,
                               "binary": 128}.get(kind, 16)
        # rows covered by this snapshot; rows appended later are served by
        # the collection's exact tail merge (collection.search_quantized)
        self.built_count = int(codes.shape[0])
        self.built_n_valid = int(codes.shape[0])

    @classmethod
    def build(cls, collection, kind: str = "int8", **kwargs) -> "QuantizedScan":
        store = collection._store
        n = store.count
        # train/encode on the FULL capacity buffer: a [:n] slice of a big
        # bf16 store materializes a multi-GB copy on top of the resident
        # corpus (6+ GB at 4M x 768 — an HBM OOM class, same as the IVF
        # build).  Padding rows encode to garbage codes but never rank:
        # built_count stays at the build-time row count and the search
        # mask excludes every row beyond it.
        dev = store.vectors
        # train on a bounded strided sample of the LIVE rows only: the
        # capacity buffer tail is all-zero padding (up to ~33% of a ladder
        # bucket) which would drag int8 vmin / binary medians toward zero
        # and waste PQ centroids on a phantom cluster.  A strided take of
        # row indices < n is a small device gather — no [:n] slice copy.
        t_cap = 262_144
        t_step = max(1, -(-max(n, 1) // t_cap))
        t_idx = jnp.asarray(np.arange(0, max(n, 1), t_step,
                                      dtype=np.int64)[:t_cap])
        if kind in ("int8", "sq", "scalar"):
            qz = ScalarQuantizer().train(
                jnp.take(dev, t_idx, axis=0).astype(jnp.float32))
            codes = qz.encode(dev)
            kind = "int8"
        elif kind in ("int4", "sq4"):
            qz = Int4Quantizer().train(
                jnp.take(dev, t_idx, axis=0).astype(jnp.float32))
            codes = qz.encode(dev)
            kind = "int4"
        elif kind in ("binary", "bq", "hamming"):
            # thresholds are per-dim medians (host numpy)
            sample = np.asarray(jnp.take(dev, t_idx, axis=0),
                                dtype=np.float32)
            qz = BinaryQuantizer().train(sample, **kwargs)
            codes = qz.encode(dev)
            kind = "binary"
        elif kind in ("pq", "product"):
            # PQ ADC distances are squared-L2 only.  For cosine, encode
            # the NORMALIZED corpus (L2 ordering over unit vectors ==
            # cosine ordering; the exact re-rank restores true scores);
            # dot products have no such reduction — reject loudly rather
            # than rank by the wrong quantity.
            metric = collection.config.metric
            from ..core.types import DistanceMetric as _DM
            if metric == _DM.DOT:
                raise ValueError(
                    "kind='pq' supports cosine/l2 collections only; the "
                    "squared-L2 ADC ordering is wrong for dot — use "
                    "kind='int8' for dot-metric collections")
            vecs = np.asarray(dev, dtype=np.float32)
            if metric == _DM.COSINE:
                vecs = vecs / np.maximum(
                    np.linalg.norm(vecs, axis=1, keepdims=True), 1e-30)
            qz = ProductQuantizer(m=kwargs.pop("m", 8),
                                  k=kwargs.pop("k", 256))
            qz.train(vecs[np.asarray(t_idx)], **kwargs)  # live rows only
            codes = qz.encode(vecs)
            kind = "pq"
        else:
            raise ValueError(f"unknown quantized scan kind {kind!r}")
        scan = cls(kind, qz, codes, store, collection.config.metric)
        scan.built_count = n  # NOT codes.shape[0]: codes cover the whole
        # capacity buffer, but only the first n rows were real at build
        # (later appends overwrite padding rows with vectors the stale
        # codes do not represent — the exact tail merge serves those)
        scan.built_n_valid = collection._store.n_valid
        # re-rank in the collection's serving dtype
        scan.compute_dtype = collection.config.compute_dtype
        return scan

    def coarse_distances(self, q: np.ndarray) -> jnp.ndarray:
        if self.kind in ("int8", "int4"):
            if not hasattr(self, "_sq_stats"):
                # one-time dequantized row stats for the folded matmul
                self._sq_stats = self.quantizer.corpus_stats(self.codes)
            mode = "int8mm" if self.kind == "int8" else "int4mm"
            return self.quantizer.distances(q, self.codes, metric=self.metric,
                                            mode=mode, stats=self._sq_stats)
        if self.kind == "binary":
            return self.quantizer.hamming_distances(q, self.codes
                                                    ).astype(jnp.float32)
        if self.metric == DistanceMetric.COSINE:
            # the PQ codes were built over the normalized corpus; the
            # query must be normalized the same way for L2==cosine
            qn = np.linalg.norm(np.asarray(q), axis=-1, keepdims=True)
            q = np.asarray(q) / np.maximum(qn, 1e-30)
        return self.quantizer.distances(q, self.codes)

    def search(self, queries: np.ndarray, k: int,
               rerank: Optional[int] = None,
               mask: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        if rerank is None:
            rerank = self.default_rerank
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        b = q.shape[0]
        # cap the coarse (B, N) f32 score block: split the batch into pow2
        # sub-batches that keep it under the budget; each sub-batch still
        # runs the fused single-dispatch pipeline and shares its compile
        n_rows = max(int(self.codes.shape[0]), 1)
        cap = max(8, int(self._score_hbm_budget // (n_rows * 4)))
        sub = 8
        while sub * 2 <= cap:
            sub *= 2
        if b > sub:
            parts = [self.search(q[s:s + sub], k, rerank, mask)
                     for s in range(0, b, sub)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        # pad the batch to a power-of-two bucket (>=8) so repeated serving
        # batch sizes share one compile (mirrors DeviceVectorStore.search)
        bp = max(8, 1 << (b - 1).bit_length())
        if bp != b:
            q = np.pad(q, ((0, bp - b), (0, 0)))
        n = self.codes.shape[0]
        # combine the caller's filter mask with store validity (tombstones).
        # The sliced validity view is cached per store buffer: jnp arrays
        # are immutable and the store REPLACES .valid on mutation, so
        # identity is the correct cache key — re-slicing per call would
        # issue an extra device dispatch per search.
        src = self._store.valid
        if getattr(self, "_valid_src", None) is not src:
            self._valid_src = src
            self._valid_sliced = src[:n]
            if self.built_count < n:
                # rows past the build-time count hold vectors the codes
                # were never trained on (appends into old padding slots)
                self._valid_sliced = self._valid_sliced & (
                    jnp.arange(n) < self.built_count)
        valid = self._valid_sliced
        if mask is not None:
            # caller masks are count-sized; codes span the capacity
            # buffer, so pad with False (padding rows never rank)
            mk = np.asarray(mask[:n], dtype=bool)
            if mk.shape[0] < n:
                mk = np.pad(mk, (0, n - mk.shape[0]))
            m = jnp.asarray(mk) & valid
        else:
            m = valid
        c = min(max(k * max(rerank, 1), k), n)
        rerank_dtype = getattr(self, "compute_dtype", "float32")
        kk = min(k, c)

        # single-dispatch full pipelines (coarse scan -> candidates ->
        # gather -> exact re-rank)
        if self.kind in ("int8", "int4") and rerank > 1:
            if not hasattr(self, "_sq_stats"):
                self._sq_stats = self.quantizer.corpus_stats(self.codes)
            vsq, rinv = self._sq_stats
            qz = self.quantizer
            two_stage = (_int8_two_stage if self.kind == "int8"
                         else _int4_two_stage)
            dists, rows = two_stage(
                jnp.asarray(q), jnp.asarray(self.codes), qz.vmin, qz.scale,
                vsq, rinv, self._store.vectors, m, metric=self.metric,
                k=kk, c=c, rerank_dtype=rerank_dtype)
            dists, rows = jax.device_get((dists, rows))  # one host sync
            return dists[:b], rows[:b]

        # general path (PQ, binary, rerank<=1)
        if self.kind == "int8":
            if not hasattr(self, "_sq_stats"):
                self._sq_stats = self.quantizer.corpus_stats(self.codes)
            vsq, rinv = self._sq_stats
            qz = self.quantizer
            cvals, crows = _int8_coarse_topk(
                jnp.asarray(q), jnp.asarray(self.codes), qz.vmin, qz.scale,
                vsq, rinv, m, metric=self.metric, k=c)
        elif self.kind == "binary":
            if not hasattr(self, "_codes_t"):
                self._codes_t = jnp.asarray(self.codes).T
            qcodes = self.quantizer.encode(q)
            cvals, crows = _hamming_coarse_topk(
                qcodes.T, self._codes_t, m, k=c,
                chunk=int(min(262_144, _pow2ge(n))))
        else:
            coarse = self.coarse_distances(q)
            cvals, crows = masked_top_k(coarse, c, m)
        if rerank <= 1:
            cvals, crows = jax.device_get((cvals, crows))  # one host sync
            return cvals[:b, :k], crows[:b, :k]
        cand_ok = cvals < MASKED * 0.5
        # native-dtype gather: _rerank's body casts in-graph (fused), so a
        # host-level .astype here would only materialize an extra full
        # (B, C, D) f32 copy of the gathered block
        cand_vecs = jnp.take(self._store.vectors, crows, axis=0)
        dists, rows = _rerank(jnp.asarray(q), cand_vecs,
                              crows, jnp.asarray(cand_ok),
                              metric=self.metric, k=kk)
        dists, rows = jax.device_get((dists, rows))  # one host sync
        return dists[:b], rows[:b]

    def tune_rerank(self, queries: np.ndarray, target_recall: float = 0.95,
                    k: int = 10, max_rerank: int = 256) -> int:
        """Smallest re-rank candidate factor whose recall@k vs the exact
        scan clears ``target_recall`` on the given query sample.

        The right factor is data-dependent: ~4 suffices for int8 anywhere,
        but 1-bit Hamming ordering degrades sharply on *clustered* corpora
        (intra-cluster sign patterns collide), where binary needs 32-128.
        Mirrors IVFIndex.tune_nprobe; returns the chosen factor (also used
        as the default by subsequent ``search`` calls via
        ``self.default_rerank``)."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        # oracle scope must match the snapshot's: rows appended after the
        # build are masked out of self.search, so an oracle ranking over
        # them caps recall below any reachable value and the loop would
        # pin default_rerank at max_rerank for zero gain
        tail_mask = None
        if self.built_count < self._store.count:
            tail_mask = np.zeros((self._store.count,), dtype=bool)
            tail_mask[: self.built_count] = True
        exact_d, exact_r = self._store.search(
            q, k, self.metric, extra_mask=tail_mask,
            compute_dtype=getattr(self, "compute_dtype", "float32"))
        rerank = 4
        while rerank <= max_rerank:
            _, rows = self.search(q, k, rerank=rerank)
            hits = np.mean([len(set(a.tolist()) & set(e.tolist())) / k
                            for a, e in zip(rows, exact_r)])
            if hits >= target_recall:
                self.default_rerank = rerank
                return rerank
            rerank *= 2
        self.default_rerank = max_rerank
        return max_rerank

    def memory_usage(self) -> dict:
        # built_count, not codes.shape[0]: the codes may span the store's
        # whole pow2 capacity buffer — the padding tail is not corpus
        return self.quantizer.memory_usage(self.built_count)

    # -- persistence (sections inside the collection's FPVT container) ----
    def export_sections(self) -> Tuple[dict, dict]:
        """Codes + quantizer params + tuned serving defaults, as container
        sections/meta — so a reloaded collection serves ``search_quantized``
        without minutes of re-train/re-encode (the reference persists
        quantizer state too, quantization.py:196-213)."""
        # persist only the real rows: codes may span the store's whole
        # capacity buffer (padding rows carry garbage codes)
        sections = {"quant_codes": np.asarray(self.codes[:self.built_count])}
        meta = {"kind": self.kind,
                "default_rerank": int(self.default_rerank),
                "built_count": int(self.built_count),
                # without this a reload reports tombstones as live-at-build
                # and _index_rebuild_due re-triggers the full re-encode the
                # snapshot exists to avoid
                "built_n_valid": int(self.built_n_valid),
                "compute_dtype": getattr(self, "compute_dtype", "float32")}
        qz = self.quantizer
        if self.kind in ("int8", "int4"):
            sections["quant_vmin"] = np.asarray(qz.vmin)
            sections["quant_scale"] = np.asarray(qz.scale)
            meta["dims"] = qz.dims
        elif self.kind == "binary":
            sections["quant_thresholds"] = np.asarray(qz.thresholds)
            meta["dims"] = qz.dims
        elif self.kind == "pq":
            sections["quant_codebooks"] = np.asarray(qz.codebooks)
            meta.update(dims=qz.dims, m=qz.m, k=qz.k)
        return sections, meta

    @classmethod
    def from_sections(cls, collection, sections: dict, meta: dict
                      ) -> "QuantizedScan":
        kind = meta["kind"]
        if kind == "int8":
            qz = ScalarQuantizer(dims=meta["dims"])
            qz.vmin = jnp.asarray(np.asarray(sections["quant_vmin"]))
            qz.scale = jnp.asarray(np.asarray(sections["quant_scale"]))
        elif kind == "int4":
            qz = Int4Quantizer(dims=meta["dims"])
            qz.vmin = jnp.asarray(np.asarray(sections["quant_vmin"]))
            qz.scale = jnp.asarray(np.asarray(sections["quant_scale"]))
        elif kind == "binary":
            qz = BinaryQuantizer(dims=meta["dims"])
            qz.thresholds = jnp.asarray(
                np.asarray(sections["quant_thresholds"]))
        elif kind == "pq":
            qz = ProductQuantizer(dims=meta["dims"], m=meta["m"],
                                  k=meta["k"])
            qz.codebooks = jnp.asarray(np.asarray(sections["quant_codebooks"]))
        else:
            raise ValueError(f"unknown quantized snapshot kind {kind!r}")
        codes = jnp.asarray(np.asarray(sections["quant_codes"]))
        scan = cls(kind, qz, codes, collection._store,
                   collection.config.metric)
        scan.default_rerank = int(meta.get("default_rerank",
                                           scan.default_rerank))
        scan.built_count = int(meta.get("built_count", codes.shape[0]))
        # pre-built_n_valid snapshots: current n_valid is the closest
        # honest estimate and never triggers a spurious rebuild
        scan.built_n_valid = int(meta.get(
            "built_n_valid", collection._store.n_valid))
        scan.compute_dtype = meta.get("compute_dtype", "float32")
        return scan
