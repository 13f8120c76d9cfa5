"""Scalar (int8) quantization — 4x compression.

Parity with the reference's ScalarQuantizer (quantization.py:64-213):
per-dimension min/max training, 255-level codes, quantized-domain L2,
decoded cosine/dot, memory accounting, save/load.  Differences:

  * codes are stored *shifted to int8* (code - 128) so the quantized corpus
    feeds s8 x s8 -> s32 matmuls (the tensor cores' integer path) directly;
  * distances are computed either by that integer matmul or by a chunked
    scan that dequantizes one tile at a time and runs the metric matmul on
    it — the full-precision corpus is never materialized (the reference
    decodes whole arrays, quantization.py:154-174);
  * training/encode/decode/distances are all jitted device functions.
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


@jax.jit
def _train(data: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    data = data.astype(jnp.float32)  # fused under jit: bf16 stores train
    vmin = jnp.min(data, axis=0)     # without materializing an f32 copy
    vmax = jnp.max(data, axis=0)
    scale = jnp.maximum(vmax - vmin, 1e-8)
    return vmin, scale


@jax.jit
def _encode(data: jnp.ndarray, vmin: jnp.ndarray, scale: jnp.ndarray
            ) -> jnp.ndarray:
    data = data.astype(jnp.float32)  # fused under jit (see _train)
    q = jnp.clip(jnp.round((data - vmin[None, :]) / scale[None, :] * 255.0),
                 0.0, 255.0)
    return (q - 128.0).astype(jnp.int8)


@jax.jit
def _decode(codes: jnp.ndarray, vmin: jnp.ndarray, scale: jnp.ndarray
            ) -> jnp.ndarray:
    return ((codes.astype(jnp.float32) + 128.0) / 255.0 * scale[None, :]
            + vmin[None, :])


@functools.partial(jax.jit, static_argnames=("metric", "chunk"))
def _distances(queries: jnp.ndarray, codes: jnp.ndarray, vmin: jnp.ndarray,
               scale: jnp.ndarray, *, metric: DistanceMetric,
               chunk: int = CHUNK) -> jnp.ndarray:
    """(B, D) x int8 (N, D) -> (B, N) scores, dequantizing tile-by-tile."""
    n, d = codes.shape
    pad = (-n) % chunk
    codes_p = jnp.pad(codes, ((0, pad), (0, 0))) if pad else codes
    tiles = codes_p.reshape(-1, chunk, d)
    q = queries.astype(jnp.float32)

    if metric == DistanceMetric.COSINE:
        qn = q / jnp.maximum(
            jnp.linalg.norm(q, axis=1, keepdims=True), 1e-30)

    def body(_, tile):
        v = ((tile.astype(jnp.float32) + 128.0) / 255.0 * scale[None, :]
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

    _, parts = jax.lax.scan(body, None, tiles)  # (T, B, chunk)
    return jnp.moveaxis(parts, 0, 1).reshape(q.shape[0], -1)[:, :n]


@functools.partial(jax.jit, static_argnames=("metric",))
def _distances_int8_matmul(queries: jnp.ndarray, codes: jnp.ndarray,
                           vmin: jnp.ndarray, scale: jnp.ndarray,
                           vsq: jnp.ndarray, rinv: jnp.ndarray, *,
                           metric: DistanceMetric) -> jnp.ndarray:
    """Int8-native scan: ONE int8 x int8 matmul against the raw codes.

    The per-dimension dequantization folds into the *query*:
        q . dequant(c) = (q * rs) . c + q . (128*rs + vmin),  rs = scale/255
    so the corpus-side work is a pure int8 matmul (the BASELINE.json
    "SQ -> int8 matmul path").  The scaled query is itself symmetrically
    quantized to int8 (per-query scale), adding <0.5% relative error on top
    of the codes' own quantization — irrelevant for a coarse stage that is
    re-ranked exactly.  Corpus row stats (vsq = ||dequant(c)||^2,
    rinv = 1/||dequant(c)||) are precomputed once at build time.
    """
    q = queries.astype(jnp.float32)
    rs = (scale / 255.0).astype(jnp.float32)
    qs = q * rs[None, :]
    const = jnp.dot(q, 128.0 * rs + vmin, precision=_HIGHEST)   # (B,)
    qmax = jnp.max(jnp.abs(qs), axis=1, keepdims=True)
    qscale = jnp.maximum(qmax, 1e-30) / 127.0
    qi = jnp.clip(jnp.round(qs / qscale), -127, 127).astype(jnp.int8)
    cross_i = jax.lax.dot_general(
        qi, codes, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)                # (B, N) s32
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
def _dequant_row_stats(codes: jnp.ndarray, vmin: jnp.ndarray,
                       scale: jnp.ndarray, chunk: int = 16384):
    """(vsq, rinv) of the dequantized corpus, computed tile-by-tile."""
    n, d = codes.shape
    pad = (-n) % chunk
    codes_p = jnp.pad(codes, ((0, pad), (0, 0))) if pad else codes

    def body(_, tile):
        v = ((tile.astype(jnp.float32) + 128.0) / 255.0 * scale[None, :]
             + vmin[None, :])
        return None, jnp.einsum("nd,nd->n", v, v,
                                preferred_element_type=jnp.float32,
                                precision=_HIGHEST)

    _, sq = jax.lax.scan(body, None, codes_p.reshape(-1, chunk, d))
    sq = sq.reshape(-1)[:n]
    rinv = jnp.where(sq > 0, jax.lax.rsqrt(jnp.maximum(sq, 1e-30)), 0.0)
    return sq, rinv


class ScalarQuantizer:
    """Per-dimension min/max int8 quantizer (4x compression)."""

    def __init__(self, dims: Optional[int] = None):
        self.dims = dims
        self.vmin: Optional[jnp.ndarray] = None
        self.scale: Optional[jnp.ndarray] = None

    @property
    def is_trained(self) -> bool:
        return self.vmin is not None

    def train(self, vectors) -> "ScalarQuantizer":
        # device arrays pass straight through: no host round-trip of a
        # resident corpus
        data = vectors if isinstance(vectors, jnp.ndarray) else \
            jnp.asarray(np.ascontiguousarray(vectors, dtype=np.float32))
        self.dims = int(data.shape[1])
        self.vmin, self.scale = _train(data)
        return self

    def encode(self, vectors) -> jnp.ndarray:
        self._check()
        data = vectors if isinstance(vectors, jnp.ndarray) else \
            jnp.asarray(np.ascontiguousarray(vectors, dtype=np.float32))
        return _encode(data, self.vmin, self.scale)

    def decode(self, codes) -> np.ndarray:
        self._check()
        return np.asarray(_decode(jnp.asarray(codes), self.vmin, self.scale))

    def corpus_stats(self, codes) -> tuple:
        """One-time (vsq, rinv) of the dequantized corpus for the
        int8-matmul scan path."""
        self._check()
        return _dequant_row_stats(jnp.asarray(codes), self.vmin, self.scale)

    def distances(self, queries: np.ndarray, codes,
                  metric: DistanceMetric = DistanceMetric.L2,
                  mode: str = "auto",
                  stats: Optional[tuple] = None) -> jnp.ndarray:
        """Quantized-domain distances.  Modes:
          int8mm  — one s8 x s8 -> s32 matmul with query-side scale folding
          chunked — tile-by-tile dequantize + float32 matmul
          auto    — the platform's choice (kernels/select.py)
        """
        self._check()
        metric = DistanceMetric.parse(metric)
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        codes = jnp.asarray(codes)
        if select.scan_mode("int8", mode) == "int8mm":
            vsq, rinv = stats if stats is not None else self.corpus_stats(codes)
            return _distances_int8_matmul(jnp.asarray(q), codes, self.vmin,
                                          self.scale, vsq, rinv,
                                          metric=metric)
        return _distances(jnp.asarray(q), codes, self.vmin, self.scale,
                          metric=metric)

    def search(self, queries: np.ndarray, codes, k: int = 10,
               metric: DistanceMetric = DistanceMetric.L2,
               mask: Optional[np.ndarray] = None):
        d = self.distances(queries, codes, metric)
        m = jnp.asarray(mask) if mask is not None else None
        vals, idx = masked_top_k(d, min(k, d.shape[1]), m)
        return np.asarray(vals), np.asarray(idx)

    def memory_usage(self, n_vectors: int) -> dict:
        self._check()
        orig = n_vectors * self.dims * 4
        quant = n_vectors * self.dims * 1 + self.dims * 8
        return {"original_bytes": orig, "quantized_bytes": quant,
                "compression_ratio": orig / max(quant, 1)}

    def save(self, path) -> None:
        self._check()
        save_container(Path(path), {
            "vmin": np.asarray(self.vmin),
            "scale": np.asarray(self.scale),
        }, meta={"kind": "scalar_quantizer", "dims": self.dims})

    @classmethod
    def load(cls, path) -> "ScalarQuantizer":
        c = load_container(path)
        sq = cls(dims=c.meta["dims"])
        sq.vmin = jnp.asarray(np.asarray(c.read("vmin")))
        sq.scale = jnp.asarray(np.asarray(c.read("scale")))
        return sq

    def _check(self) -> None:
        if not self.is_trained:
            raise RuntimeError("ScalarQuantizer is not trained")
