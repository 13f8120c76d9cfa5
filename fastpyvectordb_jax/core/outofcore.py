"""Out-of-core search: corpora larger than device memory, streamed by tile.

The reference's answer to big corpora is an np.memmap file scanned in
100k-row chunks with host-side merge (parallel_search.py:427-750).  The
device rendition keeps the corpus on host RAM/disk (any array-like, including a
memmap or a persist.format.StreamingVectorReader) and pipelines fixed-size
tiles into device memory, maintaining a running top-k on device:

    for each tile: host -> device copy | distance kernel | merge top-k

Tiles are power-of-two row counts so one kernel compile serves every tile;
the final ragged tile is zero-padded and masked.  Transfers overlap compute
naturally through JAX's async dispatch (tile t+1's host->device copy is
issued while tile t computes).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import DistanceMetric
from ..kernels.distances import MASKED, host_exact_scores, matmul_precision


@functools.partial(jax.jit,
                   static_argnames=("metric", "k", "compute_dtype"))
def _tile_step(queries, tile, tile_mask, row_offset, best_vals, best_rows, *,
               metric: DistanceMetric, k: int, compute_dtype: str):
    """Score one tile and fold it into the running top-k."""
    prec = matmul_precision(compute_dtype)
    cd = jnp.dtype(compute_dtype)
    q = queries.astype(jnp.float32)
    v = tile.astype(jnp.float32)

    def mm(a, bmat):
        return jnp.dot(a.astype(cd), bmat.astype(cd).T,
                       preferred_element_type=jnp.float32, precision=prec)

    if metric == DistanceMetric.COSINE:
        qn = q / jnp.maximum(jnp.linalg.norm(q, axis=1, keepdims=True), 1e-30)
        vsq = jnp.einsum("nd,nd->n", v, v, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        rinv = jnp.where(vsq > 0, jax.lax.rsqrt(jnp.maximum(vsq, 1e-30)), 0.0)
        s = 1.0 - mm(qn, v) * rinv[None, :]
    elif metric == DistanceMetric.L2:
        vsq = jnp.einsum("nd,nd->n", v, v, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        qsq = jnp.einsum("bd,bd->b", q, q, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        s = jnp.maximum(qsq[:, None] + vsq[None, :] - 2.0 * mm(q, v), 0.0)
    else:
        s = -mm(q, v)
    s = jnp.where(tile_mask[None, :], s, MASKED)
    neg, idx = jax.lax.top_k(-s, min(k, s.shape[1]))
    tile_vals = -neg
    tile_rows = idx + row_offset
    # merge with running best
    all_vals = jnp.concatenate([best_vals, tile_vals], axis=1)
    all_rows = jnp.concatenate([best_rows, tile_rows], axis=1)
    neg, pos = jax.lax.top_k(-all_vals, k)
    return -neg, jnp.take_along_axis(all_rows, pos, axis=1)


class OutOfCoreSearcher:
    """Streamed exact search over a host-resident (N, D) array-like."""

    def __init__(self, corpus, metric: "DistanceMetric | str" = "cosine",
                 tile_rows: int = 262_144, compute_dtype: str = "float32"):
        self.corpus = corpus
        self.n = corpus.shape[0]
        self.dims = corpus.shape[1]
        self.metric = DistanceMetric.parse(metric)
        self.tile_rows = tile_rows
        self.compute_dtype = compute_dtype

    def search(self, queries: np.ndarray, k: int = 10,
               mask: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (dists (B, k), rows (B, k)) over the full corpus."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        b = q.shape[0]
        qd = jnp.asarray(q)
        kk = min(k, self.n)
        best_vals = jnp.full((b, kk), MASKED, dtype=jnp.float32)
        best_rows = jnp.zeros((b, kk), dtype=jnp.int32)
        t = self.tile_rows
        # bf16 serving: demote tiles on the HOST so each host->device copy
        # moves half the bytes — the transfer, not the matmul, bounds
        # streamed search
        wire_dtype = (jnp.bfloat16 if jnp.dtype(self.compute_dtype)
                      == jnp.bfloat16 else np.float32)
        pending = []
        for ti, start in enumerate(range(0, self.n, t)):
            stop = min(start + t, self.n)
            rows = stop - start
            # cast to the wire dtype FIRST, pad after: padding the f32
            # intermediate doubles the host bytes touched per tile
            tile_np = np.asarray(self.corpus[start:stop],
                                 dtype=np.float32).astype(wire_dtype)
            tile_mask = np.zeros((t,), dtype=bool)
            if mask is not None:
                tile_mask[:rows] = mask[start:stop]
            else:
                tile_mask[:rows] = True
            if rows < t:
                tile_np = np.pad(tile_np, ((0, t - rows), (0, 0)))
            tile_dev = jnp.asarray(tile_np)
            pending.append(tile_dev)
            best_vals, best_rows = _tile_step(
                qd, tile_dev, jnp.asarray(tile_mask),
                jnp.int32(start), best_vals, best_rows,
                metric=self.metric, k=kk, compute_dtype=self.compute_dtype)
            if ti % 2 == 1:
                # double-buffer, not unbounded: JAX's async dispatch lets
                # Python race ahead of the transfers, pinning every queued
                # tile's host staging at once, which can exhaust host
                # memory on a large corpus.  Blocking every other tile
                # keeps copy/compute overlap while bounding in-flight
                # memory to ~2 tiles; deleting the consumed tile buffers
                # explicitly releases any transfer-runtime retention.
                jax.block_until_ready(best_vals)
                for td in pending:
                    try:
                        td.delete()
                    except Exception:
                        pass
                pending = []
        vals = np.asarray(best_vals)
        if self.metric == DistanceMetric.L2:
            good = vals < MASKED / 2
            vals = np.where(good, np.sqrt(np.maximum(vals, 0.0)), vals)
        return vals, np.asarray(best_rows)


@functools.partial(jax.jit, static_argnames=("metric", "c"))
def _int8_tile_step(q, tile_codes, vmin, scale, tile_vsq, tile_rinv,
                    tile_mask, row_offset, best_vals, best_rows, *,
                    metric: DistanceMetric, c: int):
    """Int8 coarse scores for one streamed tile, folded into running top-c."""
    from ..quant.scalar import _distances_int8_matmul
    s = _distances_int8_matmul(q, tile_codes, vmin, scale, tile_vsq,
                               tile_rinv, metric=metric)
    s = jnp.where(tile_mask[None, :], s, MASKED)
    neg, idx = jax.lax.top_k(-s, min(c, s.shape[1]))
    all_vals = jnp.concatenate([best_vals, -neg], axis=1)
    all_rows = jnp.concatenate([best_rows, idx + row_offset], axis=1)
    neg, pos = jax.lax.top_k(-all_vals, c)
    return -neg, jnp.take_along_axis(all_rows, pos, axis=1)


@functools.partial(jax.jit, static_argnames=("metric", "c"))
def _int4_tile_step(q, tile_codes, vmin, scale, tile_vsq, tile_rinv,
                    tile_mask, row_offset, best_vals, best_rows, *,
                    metric: DistanceMetric, c: int):
    """Int4 coarse scores for one streamed tile, folded into running top-c.

    The streamed regime is TRANSFER-bound (host->device bytes are the
    QPS), so the packed nibbles halve int8's per-tile traffic; on device
    the XLA unpack+s8-matmul path suffices (quant/int4.py)."""
    from ..quant.int4 import _distances_int4_matmul
    s = _distances_int4_matmul(q, tile_codes, vmin, scale, tile_vsq,
                               tile_rinv, metric=metric)
    s = jnp.where(tile_mask[None, :], s, MASKED)
    neg, idx = jax.lax.top_k(-s, min(c, s.shape[1]))
    all_vals = jnp.concatenate([best_vals, -neg], axis=1)
    all_rows = jnp.concatenate([best_rows, idx + row_offset], axis=1)
    neg, pos = jax.lax.top_k(-all_vals, c)
    return -neg, jnp.take_along_axis(all_rows, pos, axis=1)


@functools.partial(jax.jit, static_argnames=("c",))
def _binary_tile_step(qcodes, tile_codes, tile_mask, row_offset,
                      best_vals, best_rows, *, c: int):
    """Hamming coarse scores for one streamed tile + running top-c merge."""
    from ..quant.binary import _hamming
    s = _hamming(qcodes, tile_codes, chunk=min(32768, tile_codes.shape[0]))
    s = jnp.where(tile_mask[None, :], s.astype(jnp.float32), MASKED)
    neg, idx = jax.lax.top_k(-s, min(c, s.shape[1]))
    all_vals = jnp.concatenate([best_vals, -neg], axis=1)
    all_rows = jnp.concatenate([best_rows, idx + row_offset], axis=1)
    neg, pos = jax.lax.top_k(-all_vals, c)
    return -neg, jnp.take_along_axis(all_rows, pos, axis=1)


@functools.partial(jax.jit, static_argnames=("c", "kk"))
def _pq_tile_step(lut, tile_codes, tile_mask, row_offset,
                  best_vals, best_rows, *, c: int, kk: int):
    """PQ ADC coarse scores for one streamed tile + running top-c merge.

    For kk <= 32 (the 4-bit serving default) the LUT sum contracts as a
    one-hot bf16 matmul instead of a per-element gather
    (ann/ivfpq.py:_adc_sum note).
    """
    t, m = tile_codes.shape
    b = lut.shape[0]
    if kk <= 32:
        iota = jnp.arange(kk, dtype=tile_codes.dtype)
        onehot = (tile_codes[..., None] == iota).astype(
            jnp.bfloat16).reshape(t, m * kk)
        s = jnp.dot(lut.astype(jnp.bfloat16).reshape(b, m * kk), onehot.T,
                    preferred_element_type=jnp.float32)
    else:
        from ..quant.product import _adc
        s = _adc(lut, tile_codes, chunk=min(16384, t))
    s = jnp.where(tile_mask[None, :], s, MASKED)
    neg, idx = jax.lax.top_k(-s, min(c, s.shape[1]))
    all_vals = jnp.concatenate([best_vals, -neg], axis=1)
    all_rows = jnp.concatenate([best_rows, idx + row_offset], axis=1)
    neg, pos = jax.lax.top_k(-all_vals, c)
    return -neg, jnp.take_along_axis(all_rows, pos, axis=1)


def block_sample(corpus, n: int, train_rows: int) -> np.ndarray:
    """Deterministic quantizer-training sample: contiguous blocks spread
    over the file — memmap-friendly (16 sequential reads) yet covering
    the corpus distribution (a single head slice would mis-train on
    row-ordered corpora).  Every caller that trains or re-uses on-disk
    codes must draw this same sample, or codes written by one session
    silently diverge from another's."""
    blocks = min(16, max(1, n // max(train_rows, 1)))
    per = max(1, train_rows // blocks)
    starts = np.linspace(0, max(n - per, 0), blocks).astype(np.int64)
    return np.concatenate([
        np.asarray(corpus[int(s):int(s) + per], dtype=np.float32)
        for s in starts], axis=0)


def _host_encode_tile(codec: str, qz, tile_np: np.ndarray) -> np.ndarray:
    """Numpy mirror of the scalar codecs' device encoders.

    Bit-compatible with quant/scalar.py:_encode, quant/int4.py:_encode and
    quant/binary.py:_encode (same f32 arithmetic, numpy and XLA both round
    half-to-even); used at build time so encoding never ships the full
    f32 corpus across the host<->device link.
    """
    if codec == "int8":
        vmin = np.asarray(qz.vmin, np.float32)
        scale = np.asarray(qz.scale, np.float32)
        q = np.clip(np.round((tile_np - vmin) / scale * np.float32(255.0)),
                    0.0, 255.0)
        return (q - np.float32(128.0)).astype(np.int8)
    if codec == "int4":
        vmin = np.asarray(qz.vmin, np.float32)
        scale = np.asarray(qz.scale, np.float32)
        de = vmin.shape[0]
        if tile_np.shape[1] != de:  # odd-D phantom dim (halves layout)
            tile_np = np.pad(tile_np, ((0, 0), (0, de - tile_np.shape[1])))
        c = np.clip(np.round((tile_np - vmin) / scale * np.float32(15.0)),
                    0.0, 15.0).astype(np.uint8)
        w = de // 2
        return c[:, :w] | (c[:, w:] << 4)
    # binary: packed sign bits, 32 dims per uint32 word
    thr = np.asarray(qz.thresholds, np.float32)
    dims = int(thr.shape[0])
    w = (dims + 31) // 32
    bits = (tile_np[:, :dims] > thr).astype(np.uint32)
    pad = w * 32 - dims
    if pad:
        bits = np.pad(bits, ((0, 0), (0, pad)))
    shifts = np.arange(32, dtype=np.uint32)
    return (bits.reshape(-1, w, 32) << shifts).sum(
        axis=-1, dtype=np.uint32)


def _host_row_stats(codec: str, qz, enc_np: np.ndarray):
    """(vsq, rinv) of the dequantized tile — numpy mirror of the
    _dequant_row_stats helpers in quant/scalar.py and quant/int4.py."""
    vmin = np.asarray(qz.vmin, np.float32)
    scale = np.asarray(qz.scale, np.float32)
    if codec == "int8":
        v = ((enc_np.astype(np.float32) + np.float32(128.0))
             / np.float32(255.0) * scale + vmin)
    else:  # int4 halves layout: low nibbles | high nibbles
        c = np.concatenate([enc_np & 0xF, enc_np >> 4], axis=-1)
        v = c.astype(np.float32) / np.float32(15.0) * scale + vmin
    sq = np.einsum("nd,nd->n", v, v, dtype=np.float32)
    rinv = np.where(sq > 0,
                    1.0 / np.sqrt(np.maximum(sq, np.float32(1e-30))),
                    0.0).astype(np.float32)
    return sq.astype(np.float32), rinv


class QuantizedOutOfCoreSearcher:
    """Streamed *quantized* coarse scan + exact re-rank over a host corpus.

    The tier above BigCollection on the reference's scale ladder
    (README.md:571-578 ">10M: mmap + binary codes + candidate re-rank",
    parallel_search.py:895-947 search_hybrid): BigCollection keeps the
    codes resident in HBM, which caps corpus size at HBM/codes-byte; here
    even the codes live on the host and stream tile-by-tile, so corpus
    size is bounded only by host storage.  Per search the link moves
    N x D bytes (int8, 4x less than the exact streamer), N x D/2 bytes
    (int4, 8x — two nibbles per byte, quant/int4.py), N x M bytes
    (pq, 16x at the m=D/4 default — ADC scored by a one-hot matmul,
    with cosine riding the normalized-L2 equivalence so the coarse order
    matches the metric exactly), or N x D/8 bytes (binary, 32x) for the
    coarse pass, plus B x C full-precision candidate rows for the exact
    re-rank — in the transfer-bound streamed regime the codec ratio is
    the speedup, and pq holds far more of binary's recall at comparable
    compression.

    One full-precision pass over the corpus at build time trains the
    quantizer (block-sampled) and encodes the host codes array; pass
    ``codes_path`` to memmap the codes to disk so repeated sessions (and
    corpora whose *codes* exceed host RAM) skip re-encoding via
    ``codes_reuse=True`` when the file already matches.
    """

    def __init__(self, corpus, metric: "DistanceMetric | str" = "cosine",
                 codec: str = "int8", tile_rows: int = 262_144,
                 train_rows: int = 262_144, rerank: int = 16,
                 codes_path: Optional[str] = None,
                 codes_reuse: bool = False,
                 pq_m: Optional[int] = None, pq_k: int = 16,
                 encode_on: str = "auto"):
        if codec not in ("int8", "int4", "binary", "pq"):
            raise ValueError(f"unknown codec {codec!r}")
        if encode_on not in ("auto", "host", "device"):
            raise ValueError(f"unknown encode_on {encode_on!r}")
        # Build-time encoding runs on the HOST by default for the scalar
        # codecs: their encode is a handful of numpy elementwise ops per
        # tile, while the device path must ship the FULL f32 corpus over
        # the host<->device link once just to quantize it (45.8 GB at
        # 16M x 768).  PQ stays on device (k-means assignment is a matmul
        # per tile, not elementwise).
        self._encode_on = ("device" if codec == "pq"
                           else "host" if encode_on == "auto" else encode_on)
        self.corpus = corpus
        self.n = int(corpus.shape[0])
        self.dims = int(corpus.shape[1])
        self.metric = DistanceMetric.parse(metric)
        self.codec = codec
        self.tile_rows = int(tile_rows)
        self.rerank = int(rerank)
        if codec == "pq":
            # 4 dims/subspace with 16 centroids by default: 4-bit-class
            # codes the one-hot matmul ADC handles (kk <= 32); uint8 storage
            # => dims/4 bytes/row (16x vs f32)
            if pq_m is None:
                pq_m = (self.dims // 4 if self.dims % 4 == 0
                        else self.dims // 2 if self.dims % 2 == 0
                        else self.dims)
            if self.dims % pq_m != 0:
                raise ValueError(f"dims {self.dims} not divisible by "
                                 f"pq_m={pq_m}")
            self._pq_m, self._pq_k = int(pq_m), int(pq_k)
            # cosine rides the normalized-L2 equivalence (1 - cos =
            # ||qn - vn||^2 / 2): train/encode/query all normalize, so the
            # ADC coarse ordering matches the metric exactly
            self._pq_normalize = self.metric == DistanceMetric.COSINE
        if codes_path is not None and codes_reuse \
                and self._try_reuse(codes_path):
            return  # codes + quantizer stats loaded; no corpus pass needed
        self._train(min(int(train_rows), self.n))
        self._encode_all(codes_path)

    # ------------------------------------------------------------------
    def _train(self, train_rows: int) -> None:
        sample = block_sample(self.corpus, self.n, train_rows)
        if self.codec == "int8":
            from ..quant.scalar import ScalarQuantizer
            self._qz = ScalarQuantizer().train(sample)
        elif self.codec == "int4":
            from ..quant.int4 import Int4Quantizer
            self._qz = Int4Quantizer().train(sample)
        elif self.codec == "pq":
            from ..quant.product import ProductQuantizer
            if self._pq_normalize:
                sample = sample / np.maximum(
                    np.linalg.norm(sample, axis=1, keepdims=True), 1e-30)
            self._qz = ProductQuantizer(m=self._pq_m, k=self._pq_k)
            self._qz.train(sample)
        else:
            from ..quant.binary import BinaryQuantizer
            self._qz = BinaryQuantizer().train(sample)

    def _try_reuse(self, codes_path: str) -> bool:
        """Adopt an on-disk codes file + quantizer stats written by an
        earlier session over the same corpus; True on success."""
        import os
        if not (os.path.exists(codes_path)
                and os.path.exists(self._stats_path(codes_path))):
            return False
        codes = np.lib.format.open_memmap(codes_path, mode="r")
        want_dtype = (np.int8 if self.codec == "int8"
                      else np.uint8 if self.codec in ("pq", "int4")
                      else np.uint32)
        if (codes.ndim != 2 or codes.shape[0] != self.n
                or codes.dtype != np.dtype(want_dtype)):
            return False
        if self.codec == "int8":
            from ..quant.scalar import ScalarQuantizer
            self._qz = ScalarQuantizer(self.dims)
            if codes.shape[1] != self.dims:
                return False
        elif self.codec == "int4":
            from ..quant.int4 import Int4Quantizer
            self._qz = Int4Quantizer(self.dims)
            if codes.shape[1] != self._qz.n_words:
                return False
        elif self.codec == "pq":
            from ..quant.product import ProductQuantizer
            if codes.shape[1] != self._pq_m:
                return False
            self._qz = ProductQuantizer(self.dims, m=self._pq_m,
                                        k=self._pq_k)
        else:
            from ..quant.binary import BinaryQuantizer
            self._qz = BinaryQuantizer(self.dims)
            if codes.shape[1] != self._qz.n_words:
                return False
        if not self._load_stats(codes_path):
            return False
        self._codes = codes
        return True

    def _encode_all(self, codes_path: Optional[str]) -> None:
        if self.codec == "int8":
            shape, dtype = (self.n, self.dims), np.int8
        elif self.codec == "int4":
            shape, dtype = (self.n, self._qz.n_words), np.uint8
        elif self.codec == "pq":
            shape, dtype = (self.n, self._pq_m), np.uint8
        else:
            shape, dtype = (self.n, self._qz.n_words), np.uint32
        if codes_path is not None:
            codes = np.lib.format.open_memmap(
                codes_path, mode="w+", dtype=dtype, shape=shape)
        else:
            codes = np.empty(shape, dtype=dtype)
        # int8/int4 re-rank stats: ||dequant(c)||^2 and 1/||.|| per row
        # (tiny: 8 host bytes/row) — required by the folded s8 matmuls
        needs_stats = self.codec in ("int8", "int4")
        self._vsq = (np.empty((self.n,), np.float32)
                     if needs_stats else None)
        self._rinv = (np.empty((self.n,), np.float32)
                      if needs_stats else None)
        t = self.tile_rows
        for start in range(0, self.n, t):
            stop = min(start + t, self.n)
            tile_np = np.asarray(self.corpus[start:stop], dtype=np.float32)
            if self.codec == "pq":
                if self._pq_normalize:
                    tile_np = tile_np / np.maximum(np.linalg.norm(
                        tile_np, axis=1, keepdims=True), 1e-30)
                enc = self._qz.encode(tile_np)
                codes[start:stop] = np.asarray(enc)
                enc.delete()
                continue
            if self._encode_on == "host":
                enc_np = _host_encode_tile(self.codec, self._qz, tile_np)
                codes[start:stop] = enc_np
                if needs_stats:
                    vsq, rinv = _host_row_stats(self.codec, self._qz, enc_np)
                    self._vsq[start:stop] = vsq
                    self._rinv[start:stop] = rinv
                continue
            tile = jnp.asarray(tile_np)
            enc = self._qz.encode(tile)
            codes[start:stop] = np.asarray(enc)
            if self.codec == "int8":
                from ..quant.scalar import _dequant_row_stats
                vsq, rinv = _dequant_row_stats(enc, self._qz.vmin,
                                               self._qz.scale)
                self._vsq[start:stop] = np.asarray(vsq)
                self._rinv[start:stop] = np.asarray(rinv)
            elif self.codec == "int4":
                from ..quant.int4 import _dequant_row_stats as _i4_stats
                vsq, rinv = _i4_stats(enc, self._qz.vmin, self._qz.scale)
                self._vsq[start:stop] = np.asarray(vsq)
                self._rinv[start:stop] = np.asarray(rinv)
            tile.delete()
            enc.delete()
        if codes_path is not None:
            if hasattr(codes, "flush"):
                codes.flush()
            self._save_stats(codes_path)
        self._codes = codes

    def _stats_path(self, codes_path: str) -> str:
        return codes_path + ".stats.npz"

    def _save_stats(self, codes_path: str) -> None:
        payload = {"codec": self.codec}
        if self.codec in ("int8", "int4"):
            payload.update(vmin=np.asarray(self._qz.vmin),
                           scale=np.asarray(self._qz.scale),
                           vsq=self._vsq, rinv=self._rinv)
        elif self.codec == "pq":
            payload.update(codebooks=np.asarray(self._qz.codebooks))
        else:
            payload.update(thresholds=np.asarray(self._qz.thresholds))
        np.savez(self._stats_path(codes_path), **payload)

    def _load_stats(self, codes_path: str) -> bool:
        self._vsq = self._rinv = None
        z = np.load(self._stats_path(codes_path))
        if str(z["codec"]) != self.codec:
            return False
        if self.codec in ("int8", "int4"):
            if z["vsq"].shape != (self.n,):
                return False
            self._qz.vmin = jnp.asarray(z["vmin"])
            self._qz.scale = jnp.asarray(z["scale"])
            self._qz.dims = self.dims
            self._vsq = np.ascontiguousarray(z["vsq"])
            self._rinv = np.ascontiguousarray(z["rinv"])
        elif self.codec == "pq":
            cb = z["codebooks"]
            if cb.shape != (self._pq_m, self._pq_k,
                            self.dims // self._pq_m):
                return False
            self._qz.codebooks = jnp.asarray(cb)
            self._qz.dims = self.dims
        else:
            if z["thresholds"].shape != (self.dims,):
                return False
            self._qz.thresholds = jnp.asarray(z["thresholds"])
            self._qz.dims = self.dims
        return True

    # ------------------------------------------------------------------
    def tune_rerank(self, queries: np.ndarray, k: int = 10,
                    target_recall: float = 0.95,
                    max_rerank: int = 512) -> int:
        """Find (and install) the smallest rerank factor whose recall@k
        against the exact streamed path clears ``target_recall``.

        Coarse code orderings collapse on tightly clustered corpora
        (intra-cluster codes collide — the quantized-scan story,
        QuantizedScan.tune_rerank), and the failure is silent: the
        re-rank stage repairs exactly the candidates the coarse stage
        surfaces.  Costs one exact streamed pass for ground truth plus
        one coarse pass per doubling.  Returns the installed factor;
        leaves ``max_rerank`` installed (and returns it) if even that
        misses the target — callers wanting a hard guarantee should
        check recall themselves or use the int8 codec (8 bits/dim does
        not collapse).
        """
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        exact = OutOfCoreSearcher(self.corpus, metric=self.metric,
                                  tile_rows=self.tile_rows)
        _, truth = exact.search(q, k=k)
        rr = max(self.rerank, 1)
        while True:
            _, rows = self.search(q, k=k, rerank=rr)
            rec = float(np.mean([
                len(set(a) & set(b)) / k
                for a, b in zip(rows.tolist(), truth.tolist())]))
            if rec >= target_recall or rr >= max_rerank:
                self.rerank = rr
                return rr
            rr = min(rr * 2, max_rerank)

    def search(self, queries: np.ndarray, k: int = 10,
               rerank: Optional[int] = None,
               mask: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (dists (B, k), rows (B, k)); exact re-ranked top-k."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        b = q.shape[0]
        kk = min(k, self.n)
        c = min(max(kk * (rerank or self.rerank), kk), self.n)
        qd = jnp.asarray(q)
        if self.codec == "binary":
            qcd = self._qz.encode(q)
        elif self.codec == "pq":
            from ..quant.product import _lut
            qn = q
            if self._pq_normalize:
                qn = q / np.maximum(
                    np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
            lut = _lut(jnp.asarray(qn), self._qz.codebooks)  # (B, M, K)
        best_vals = jnp.full((b, c), MASKED, dtype=jnp.float32)
        best_rows = jnp.zeros((b, c), dtype=jnp.int32)
        t = self.tile_rows
        pending = []
        for ti, start in enumerate(range(0, self.n, t)):
            stop = min(start + t, self.n)
            rows = stop - start
            tile_np = np.asarray(self._codes[start:stop])
            tile_mask = np.zeros((t,), dtype=bool)
            tile_mask[:rows] = (mask[start:stop] if mask is not None
                                else True)
            if rows < t:
                tile_np = np.pad(tile_np, ((0, t - rows), (0, 0)))
            tile_dev = jnp.asarray(tile_np)
            pending.append(tile_dev)
            if self.codec in ("int8", "int4"):
                vsq = np.zeros((t,), np.float32)
                rinv = np.zeros((t,), np.float32)
                vsq[:rows] = self._vsq[start:stop]
                rinv[:rows] = self._rinv[start:stop]
                step = (_int8_tile_step if self.codec == "int8"
                        else _int4_tile_step)
                best_vals, best_rows = step(
                    qd, tile_dev, self._qz.vmin, self._qz.scale,
                    jnp.asarray(vsq), jnp.asarray(rinv),
                    jnp.asarray(tile_mask), jnp.int32(start),
                    best_vals, best_rows, metric=self.metric, c=c)
            elif self.codec == "pq":
                best_vals, best_rows = _pq_tile_step(
                    lut, tile_dev, jnp.asarray(tile_mask), jnp.int32(start),
                    best_vals, best_rows, c=c, kk=self._pq_k)
            else:
                best_vals, best_rows = _binary_tile_step(
                    qcd, tile_dev, jnp.asarray(tile_mask), jnp.int32(start),
                    best_vals, best_rows, c=c)
            if ti % 2 == 1:  # bound in-flight tiles (see OutOfCoreSearcher)
                jax.block_until_ready(best_vals)
                for td in pending:
                    try:
                        td.delete()
                    except Exception:
                        pass
                pending = []
        cvals = np.asarray(best_vals)
        crows = np.asarray(best_rows)
        # exact re-rank: gather candidate f32 rows from the host corpus.
        # Rows are fetched in sorted order (one ascending pass — memmaps
        # reward locality) then scattered back per query.
        safe = np.clip(crows, 0, self.n - 1)
        flat = safe.reshape(-1)
        order = np.argsort(flat, kind="stable")
        gathered = np.asarray(self.corpus[flat[order]], dtype=np.float32)
        cand = np.empty_like(gathered)
        cand[order] = gathered
        cand = cand.reshape(b, c, self.dims)
        ok = cvals < MASKED * 0.5  # masked coarse picks: clipped rows lie
        if mask is not None:
            ok &= np.take(mask, safe)
        dists = host_exact_scores(q, cand, self.metric)
        dists = np.where(ok, dists, np.inf)
        top = np.argsort(dists, axis=1)[:, :kk]
        return (np.take_along_axis(dists, top, axis=1),
                np.take_along_axis(safe, top, axis=1))
