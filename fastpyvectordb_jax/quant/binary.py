"""Binary (1-bit) quantization — 32x compression with Hamming distance.

Parity with the reference's BinaryQuantizer (quantization.py:282-407):
per-dimension median (or fixed) thresholds, bit-packed codes, Hamming
search.  Differences:

  * bits are packed into uint32 words (W = ceil(D/32) words per vector)
    instead of uint8 `np.packbits`, so Hamming distance is XOR +
    ``lax.population_count`` in one fused XLA loop with no unpacking
    (the reference unpacks to full bytes per query, quantization.py:356-374);
  * the whole scan is a chunked jitted kernel; padding bits are zero on both
    sides so they never contribute to the distance.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels.topk import masked_top_k
from ..persist.format import load_container, save_container

CHUNK = 32768


def _n_words(dims: int) -> int:
    return (dims + 31) // 32


@functools.partial(jax.jit, static_argnames=("dims",))
def _encode(data: jnp.ndarray, thresholds: jnp.ndarray, *, dims: int
            ) -> jnp.ndarray:
    """(N, D) float32 -> (N, W) uint32 packed sign bits."""
    n = data.shape[0]
    w = _n_words(dims)
    bits = (data > thresholds[None, :]).astype(jnp.uint32)
    pad = w * 32 - dims
    if pad:
        bits = jnp.pad(bits, ((0, 0), (0, pad)))
    bits = bits.reshape(n, w, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    return jnp.sum(bits << shifts, axis=-1, dtype=jnp.uint32)


@functools.partial(jax.jit, static_argnames=("chunk",))
def _hamming(qcodes: jnp.ndarray, codes: jnp.ndarray, *, chunk: int = CHUNK
             ) -> jnp.ndarray:
    """(B, W) x (N, W) -> (B, N) int32 Hamming distances, chunked over N."""
    n, w = codes.shape
    pad = (-n) % chunk
    codes_p = jnp.pad(codes, ((0, pad), (0, 0))) if pad else codes
    tiles = codes_p.reshape(-1, chunk, w)

    def body(_, tile):
        x = jnp.bitwise_xor(qcodes[:, None, :], tile[None, :, :])
        return None, jnp.sum(jax.lax.population_count(x), axis=-1,
                             dtype=jnp.int32)

    _, parts = jax.lax.scan(body, None, tiles)  # (T, B, chunk)
    return jnp.moveaxis(parts, 0, 1).reshape(qcodes.shape[0], -1)[:, :n]


class BinaryQuantizer:
    """1-bit-per-dimension quantizer with packed-uint32 Hamming search."""

    def __init__(self, dims: Optional[int] = None):
        self.dims = dims
        self.thresholds: Optional[jnp.ndarray] = None

    @property
    def is_trained(self) -> bool:
        return self.thresholds is not None

    @property
    def n_words(self) -> int:
        return _n_words(self.dims)

    def train(self, vectors: np.ndarray, method: str = "median",
              fixed_threshold: float = 0.0) -> "BinaryQuantizer":
        data = np.ascontiguousarray(vectors, dtype=np.float32)
        self.dims = int(data.shape[1])
        if method == "median":
            thr = np.median(data, axis=0)
        elif method == "mean":
            thr = data.mean(axis=0)
        elif method == "fixed":
            thr = np.full(self.dims, fixed_threshold, dtype=np.float32)
        else:
            raise ValueError(f"unknown threshold method {method!r}")
        self.thresholds = jnp.asarray(thr.astype(np.float32))
        return self

    def encode(self, vectors) -> jnp.ndarray:
        self._check()
        if isinstance(vectors, jnp.ndarray):  # device corpus: no host bounce
            v = vectors if vectors.ndim > 1 else vectors[None, :]
        else:
            v = np.ascontiguousarray(vectors, dtype=np.float32)
            if v.ndim == 1:
                v = v[None, :]
            v = jnp.asarray(v)
        return _encode(v, self.thresholds, dims=self.dims)

    def hamming_distances(self, queries: np.ndarray, codes) -> jnp.ndarray:
        return _hamming(self.encode(queries), jnp.asarray(codes))

    def search(self, queries: np.ndarray, codes, k: int = 10,
               mask: Optional[np.ndarray] = None):
        d = self.hamming_distances(queries, codes).astype(jnp.float32)
        m = jnp.asarray(mask) if mask is not None else None
        vals, idx = masked_top_k(d, min(k, d.shape[1]), m)
        return np.asarray(vals), np.asarray(idx)

    def memory_usage(self, n_vectors: int) -> dict:
        self._check()
        orig = n_vectors * self.dims * 4
        quant = n_vectors * self.n_words * 4 + self.dims * 4
        return {"original_bytes": orig, "quantized_bytes": quant,
                "compression_ratio": orig / max(quant, 1)}

    def save(self, path) -> None:
        self._check()
        save_container(Path(path), {"thresholds": np.asarray(self.thresholds)},
                       meta={"kind": "binary_quantizer", "dims": self.dims})

    @classmethod
    def load(cls, path) -> "BinaryQuantizer":
        c = load_container(path)
        bq = cls(dims=c.meta["dims"])
        bq.thresholds = jnp.asarray(np.asarray(c.read("thresholds")))
        return bq

    def _check(self) -> None:
        if not self.is_trained:
            raise RuntimeError("BinaryQuantizer is not trained")
