"""Int4 scalar quantization — 8x compression.

The codec BETWEEN int8 (4x, quant/scalar.py) and binary (32x,
quant/binary.py) on the compression ladder: per-dimension min/max training
like the reference's ScalarQuantizer (quantization.py:64-213) but 16-level
codes packed two-per-byte.  Positioning:

  * **bandwidth**: the stored codes are N x D/2 bytes — half of int8.  In
    the transfer-bound streamed out-of-core tier (core/outofcore.py, where
    the codec byte ratio is the QPS ratio) that is a direct ~2x.  On the
    device the XLA scan unpacks to int8 before its matmul, so it reads as
    many bytes as int8 does.
  * **capacity**: device-resident codes for 2x the corpus per unit of
    device memory (BigCollection-class deployments).
  * **recall**: 16 levels/dim is far coarser than int8's 256 — the coarse
    ordering loosens, and the exact re-rank (deeper default, tune_rerank)
    restores recall; on hard clustered corpora prefer int8 unless memory
    or bandwidth is the binding constraint.

Packing layout: dims are split in HALVES, not interleaved — the low
nibble of byte ``w`` holds dim ``w``, the high nibble holds dim ``w + W``
(W = ceil(D/2)).  Unpacking is then a contiguous
``concat(c & 0xF, c >> 4)`` with no shuffle.  Odd D pads one phantom dim
(vmin=0, scale=eps, query padded with 0 — contributes nothing to any
metric).
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import DistanceMetric
from ..kernels import select
from ..kernels.topk import masked_top_k
from ..persist.format import load_container, save_container

CHUNK = 16384
_HIGHEST = jax.lax.Precision.HIGHEST


def _padded_dims(d: int) -> int:
    return d + (d % 2)


@jax.jit
def _train(data: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    data = data.astype(jnp.float32)
    vmin = jnp.min(data, axis=0)
    vmax = jnp.max(data, axis=0)
    scale = jnp.maximum(vmax - vmin, 1e-8)
    return vmin, scale


@jax.jit
def _encode(data: jnp.ndarray, vmin: jnp.ndarray, scale: jnp.ndarray
            ) -> jnp.ndarray:
    """(N, De) f32 -> (N, De/2) packed uint8 (halves layout)."""
    data = data.astype(jnp.float32)
    c = jnp.clip(jnp.round((data - vmin[None, :]) / scale[None, :] * 15.0),
                 0.0, 15.0).astype(jnp.uint8)
    w = c.shape[1] // 2
    return c[:, :w] | (c[:, w:] << 4)


def _unpack(packed: jnp.ndarray) -> jnp.ndarray:
    """(N, W) packed uint8 -> (N, 2W) int8 codes in [0, 15]."""
    c = packed.astype(jnp.int32)
    return jnp.concatenate([c & 0xF, c >> 4], axis=-1).astype(jnp.int8)


@jax.jit
def _decode(packed: jnp.ndarray, vmin: jnp.ndarray, scale: jnp.ndarray
            ) -> jnp.ndarray:
    c = _unpack(packed).astype(jnp.float32)
    return c / 15.0 * scale[None, :] + vmin[None, :]


@functools.partial(jax.jit, static_argnames=("metric", "chunk"))
def _distances(queries: jnp.ndarray, packed: jnp.ndarray, vmin: jnp.ndarray,
               scale: jnp.ndarray, *, metric: DistanceMetric,
               chunk: int = CHUNK) -> jnp.ndarray:
    """Chunked scan: unpack + dequantize one tile at a time."""
    n, w = packed.shape
    de = 2 * w
    pad = (-n) % chunk
    codes_p = jnp.pad(packed, ((0, pad), (0, 0))) if pad else packed
    tiles = codes_p.reshape(-1, chunk, w)
    q = jnp.pad(queries.astype(jnp.float32),
                ((0, 0), (0, de - queries.shape[1])))

    if metric == DistanceMetric.COSINE:
        qn = q / jnp.maximum(
            jnp.linalg.norm(q, axis=1, keepdims=True), 1e-30)

    def body(_, tile):
        v = (_unpack(tile).astype(jnp.float32) / 15.0 * scale[None, :]
             + vmin[None, :])
        if metric == DistanceMetric.COSINE:
            vn = v / jnp.maximum(jnp.linalg.norm(v, axis=1, keepdims=True),
                                 1e-30)
            s = 1.0 - jnp.dot(qn, vn.T, preferred_element_type=jnp.float32,
                              precision=_HIGHEST)
        elif metric == DistanceMetric.L2:
            vsq = jnp.einsum("nd,nd->n", v, v,
                             preferred_element_type=jnp.float32,
                             precision=_HIGHEST)
            qsq = jnp.einsum("bd,bd->b", q, q,
                             preferred_element_type=jnp.float32,
                             precision=_HIGHEST)
            s = jnp.maximum(
                qsq[:, None] + vsq[None, :]
                - 2.0 * jnp.dot(q, v.T, preferred_element_type=jnp.float32,
                                precision=_HIGHEST),
                0.0)
        else:
            s = -jnp.dot(q, v.T, preferred_element_type=jnp.float32,
                         precision=_HIGHEST)
        return None, s

    _, parts = jax.lax.scan(body, None, tiles)
    return jnp.moveaxis(parts, 0, 1).reshape(q.shape[0], -1)[:, :n]


@functools.partial(jax.jit, static_argnames=("metric",))
def _distances_int4_matmul(queries: jnp.ndarray, packed: jnp.ndarray,
                           vmin: jnp.ndarray, scale: jnp.ndarray,
                           vsq: jnp.ndarray, rinv: jnp.ndarray, *,
                           metric: DistanceMetric) -> jnp.ndarray:
    """Folded int4 scan: unpack to int8 codes and run ONE s8 x s8
    matmul, with the dequantization folded into the query exactly like
    the int8 path (quant/scalar.py:_distances_int8_matmul):

        q . dequant(c) = (q * rs) . c + q . vmin,   rs = scale / 15

    The unpacked (N, De) int8 tensor may materialize transiently, so this
    path can read as many bytes as int8's.  Coarse stage only (re-rank
    restores exact ordering).
    """
    w = packed.shape[1]
    de = 2 * w
    q = jnp.pad(queries.astype(jnp.float32),
                ((0, 0), (0, de - queries.shape[1])))
    rs = (scale / 15.0).astype(jnp.float32)
    qs = q * rs[None, :]
    const = jnp.dot(q, vmin, precision=_HIGHEST)         # (B,)
    qmax = jnp.max(jnp.abs(qs), axis=1, keepdims=True)
    qscale = jnp.maximum(qmax, 1e-30) / 127.0
    qi = jnp.clip(jnp.round(qs / qscale), -127, 127).astype(jnp.int8)
    codes = _unpack(packed)                              # (N, De) int8 0..15
    cross_i = jax.lax.dot_general(
        qi, codes, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)
    cross = cross_i.astype(jnp.float32) * qscale + const[:, None]
    if metric == DistanceMetric.COSINE:
        qn = jnp.maximum(jnp.linalg.norm(q, axis=1, keepdims=True), 1e-30)
        return 1.0 - (cross / qn) * rinv[None, :]
    if metric == DistanceMetric.L2:
        qsq = jnp.einsum("bd,bd->b", q, q, preferred_element_type=jnp.float32,
                         precision=_HIGHEST)
        return jnp.maximum(qsq[:, None] + vsq[None, :] - 2.0 * cross, 0.0)
    return -cross


@functools.partial(jax.jit, static_argnames=("chunk",))
def _dequant_row_stats(packed: jnp.ndarray, vmin: jnp.ndarray,
                       scale: jnp.ndarray, chunk: int = 16384):
    """(vsq, rinv) of the dequantized corpus, tile-by-tile."""
    n, w = packed.shape
    pad = (-n) % chunk
    codes_p = jnp.pad(packed, ((0, pad), (0, 0))) if pad else packed

    def body(_, tile):
        v = (_unpack(tile).astype(jnp.float32) / 15.0 * scale[None, :]
             + vmin[None, :])
        return None, jnp.einsum("nd,nd->n", v, v,
                                preferred_element_type=jnp.float32,
                                precision=_HIGHEST)

    _, sq = jax.lax.scan(body, None, codes_p.reshape(-1, chunk, w))
    sq = sq.reshape(-1)[:n]
    rinv = jnp.where(sq > 0, jax.lax.rsqrt(jnp.maximum(sq, 1e-30)), 0.0)
    return sq, rinv


class Int4Quantizer:
    """Per-dimension min/max int4 quantizer (8x compression)."""

    def __init__(self, dims: Optional[int] = None):
        self.dims = dims            # true dims; internal arrays use _de
        self.vmin: Optional[jnp.ndarray] = None
        self.scale: Optional[jnp.ndarray] = None

    @property
    def _de(self) -> int:
        return _padded_dims(self.dims)

    @property
    def n_words(self) -> int:
        return self._de // 2

    @property
    def is_trained(self) -> bool:
        return self.vmin is not None

    def train(self, vectors) -> "Int4Quantizer":
        data = vectors if isinstance(vectors, jnp.ndarray) else \
            jnp.asarray(np.ascontiguousarray(vectors, dtype=np.float32))
        self.dims = int(data.shape[1])
        vmin, scale = _train(data)
        if self._de != self.dims:   # phantom pad dim: never contributes
            vmin = jnp.pad(vmin, (0, 1))
            scale = jnp.pad(scale, (0, 1), constant_values=1e-8)
        self.vmin, self.scale = vmin, scale
        return self

    def _pad_data(self, data: jnp.ndarray) -> jnp.ndarray:
        if data.shape[1] == self._de:
            return data
        return jnp.pad(data, ((0, 0), (0, self._de - data.shape[1])))

    def encode(self, vectors) -> jnp.ndarray:
        self._check()
        data = vectors if isinstance(vectors, jnp.ndarray) else \
            jnp.asarray(np.ascontiguousarray(vectors, dtype=np.float32))
        return _encode(self._pad_data(data), self.vmin, self.scale)

    def decode(self, packed) -> np.ndarray:
        self._check()
        out = np.asarray(_decode(jnp.asarray(packed), self.vmin, self.scale))
        return out[:, : self.dims]

    def corpus_stats(self, packed) -> tuple:
        """One-time (vsq, rinv) of the dequantized corpus."""
        self._check()
        return _dequant_row_stats(jnp.asarray(packed), self.vmin, self.scale)

    def distances(self, queries: np.ndarray, packed,
                  metric: DistanceMetric = DistanceMetric.L2,
                  mode: str = "auto",
                  stats: Optional[tuple] = None) -> jnp.ndarray:
        """Quantized-domain distances.  Modes: int4mm (unpack + one
        s8 x s8 matmul) | chunked (tile-by-tile unpack + dequantize) |
        auto (the platform's choice, kernels/select.py)."""
        self._check()
        metric = DistanceMetric.parse(metric)
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        packed = jnp.asarray(packed)
        if select.scan_mode("int4", mode) == "int4mm":
            vsq, rinv = stats if stats is not None \
                else self.corpus_stats(packed)
            return _distances_int4_matmul(jnp.asarray(q), packed, self.vmin,
                                          self.scale, vsq, rinv,
                                          metric=metric)
        return _distances(jnp.asarray(q), packed, self.vmin, self.scale,
                          metric=metric)

    def search(self, queries: np.ndarray, packed, k: int = 10,
               metric: DistanceMetric = DistanceMetric.L2,
               mask: Optional[np.ndarray] = None):
        d = self.distances(queries, packed, metric)
        m = jnp.asarray(mask) if mask is not None else None
        vals, idx = masked_top_k(d, min(k, d.shape[1]), m)
        return np.asarray(vals), np.asarray(idx)

    def memory_usage(self, n_vectors: int) -> dict:
        self._check()
        orig = n_vectors * self.dims * 4
        quant = n_vectors * self.n_words + self._de * 8
        return {"original_bytes": orig, "quantized_bytes": quant,
                "compression_ratio": orig / max(quant, 1)}

    def save(self, path) -> None:
        self._check()
        save_container(Path(path), {
            "vmin": np.asarray(self.vmin),
            "scale": np.asarray(self.scale),
        }, meta={"kind": "int4_quantizer", "dims": self.dims})

    @classmethod
    def load(cls, path) -> "Int4Quantizer":
        c = load_container(path)
        qz = cls(dims=c.meta["dims"])
        qz.vmin = jnp.asarray(np.asarray(c.read("vmin")))
        qz.scale = jnp.asarray(np.asarray(c.read("scale")))
        return qz

    def _check(self) -> None:
        if not self.is_trained:
            raise RuntimeError("Int4Quantizer is not trained")
