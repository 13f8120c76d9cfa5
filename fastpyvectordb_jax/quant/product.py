"""Product quantization (PQ) — 8-16x compression with LUT (ADC) distances.

Parity with the reference's ProductQuantizer (quantization.py:414-615):
M subspaces x K=256 centroids, per-subspace codebooks, uint8 codes,
asymmetric-distance (ADC) search via per-query lookup tables.  Differences:

  * codebooks for all M subspaces are trained *jointly* with a single
    vmapped device k-means (quant/kmeans.py) instead of an M-iteration host
    loop (quantization.py:444-478);
  * encoding is a batched matmul argmin per subspace;
  * the ADC scan gathers LUT entries tile-by-tile inside a jitted scan.
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
from .kmeans import kmeans_fit

CHUNK = 8192


@functools.partial(jax.jit, static_argnames=("chunk",))
def _encode(data: jnp.ndarray, codebooks: jnp.ndarray, *, chunk: int = 16384
            ) -> jnp.ndarray:
    """(N, D) x (M, K, ds) -> (N, M) uint8 codes."""
    n, d = data.shape
    m, k, ds = codebooks.shape
    pad = (-n) % chunk
    data_p = jnp.pad(data, ((0, pad), (0, 0))) if pad else data
    tiles = data_p.reshape(-1, chunk, m, ds)
    csq = jnp.einsum("mkd,mkd->mk", codebooks, codebooks,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)

    def body(_, x):  # x: (chunk, M, ds)
        cross = jnp.einsum("nmd,mkd->nmk", x, codebooks,
                           preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
        dist = csq[None, :, :] - 2.0 * cross
        return None, jnp.argmin(dist, axis=-1).astype(jnp.uint8)

    _, codes = jax.lax.scan(body, None, tiles)
    return codes.reshape(-1, m)[:n]


@jax.jit
def _lut(queries: jnp.ndarray, codebooks: jnp.ndarray) -> jnp.ndarray:
    """(B, D) x (M, K, ds) -> (B, M, K) squared-distance lookup tables."""
    b = queries.shape[0]
    m, k, ds = codebooks.shape
    q = queries.reshape(b, m, ds)
    qsq = jnp.einsum("bmd,bmd->bm", q, q, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    csq = jnp.einsum("mkd,mkd->mk", codebooks, codebooks,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    cross = jnp.einsum("bmd,mkd->bmk", q, codebooks,
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
    return qsq[:, :, None] + csq[None, :, :] - 2.0 * cross


@functools.partial(jax.jit, static_argnames=("chunk",))
def _adc(lut: jnp.ndarray, codes: jnp.ndarray, *, chunk: int = CHUNK
         ) -> jnp.ndarray:
    """(B, M, K) LUT x (N, M) codes -> (B, N) approximate squared L2."""
    n, m = codes.shape
    b = lut.shape[0]
    pad = (-n) % chunk
    codes_p = jnp.pad(codes, ((0, pad), (0, 0))) if pad else codes
    tiles = codes_p.reshape(-1, chunk, m)
    lut_t = jnp.transpose(lut, (1, 2, 0))  # (M, K, B) — gather rows along K

    def body(_, tile):  # tile: (chunk, M) uint8
        # vmap the gather over subspaces: for each m, LUT[m][codes[:, m]] (chunk, B)
        gathered = jax.vmap(
            lambda t, c: jnp.take(t, c.astype(jnp.int32), axis=0),
            in_axes=(0, 1))(lut_t, tile)  # (M, chunk, B)
        return None, jnp.sum(gathered, axis=0).T  # (B, chunk)

    _, parts = jax.lax.scan(body, None, tiles)
    return jnp.moveaxis(parts, 0, 1).reshape(b, -1)[:, :n]


class ProductQuantizer:
    """M-subspace / K-centroid product quantizer with ADC search."""

    def __init__(self, dims: Optional[int] = None, m: int = 8, k: int = 256):
        if k > 256:
            raise ValueError("k must be <= 256 for uint8 codes")
        self.dims = dims
        self.m = m
        self.k = k
        self.codebooks: Optional[jnp.ndarray] = None  # (M, K, ds)

    @property
    def is_trained(self) -> bool:
        return self.codebooks is not None

    @property
    def subdim(self) -> int:
        return self.dims // self.m

    def train(self, vectors: np.ndarray, iters: int = 12,
              sample: int = 100_000, seed: int = 0) -> "ProductQuantizer":
        data = np.ascontiguousarray(vectors, dtype=np.float32)
        n, d = data.shape
        if d % self.m != 0:
            raise ValueError(f"dims {d} not divisible by m={self.m}")
        self.dims = d
        if n > sample:
            idx = np.random.default_rng(seed).choice(n, sample, replace=False)
            data = data[idx]
        sub = jnp.asarray(data.reshape(-1, self.m, self.subdim))
        sub = jnp.moveaxis(sub, 1, 0)  # (M, N, ds)
        keys = jax.random.split(jax.random.PRNGKey(seed), self.m)
        fit = jax.vmap(lambda x, key: kmeans_fit(x, key, k=self.k, iters=iters,
                                                 chunk=min(16384, max(
                                                     256, sub.shape[1]))))
        self.codebooks = fit(sub, keys)
        return self

    def encode(self, vectors: np.ndarray) -> jnp.ndarray:
        self._check()
        v = np.ascontiguousarray(vectors, dtype=np.float32)
        if v.ndim == 1:
            v = v[None, :]
        return _encode(jnp.asarray(v), self.codebooks)

    def decode(self, codes) -> np.ndarray:
        self._check()
        codes = jnp.asarray(codes)
        out = jax.vmap(
            lambda cb, c: jnp.take(cb, c.astype(jnp.int32), axis=0),
            in_axes=(0, 1))(self.codebooks, codes)  # (M, N, ds)
        return np.asarray(jnp.moveaxis(out, 0, 1).reshape(codes.shape[0], -1))

    def distances(self, queries: np.ndarray, codes) -> jnp.ndarray:
        """Approximate squared-L2 ADC distances (B, N)."""
        self._check()
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        lut = _lut(jnp.asarray(q), self.codebooks)
        return _adc(lut, jnp.asarray(codes))

    def search(self, queries: np.ndarray, codes, k: int = 10,
               mask: Optional[np.ndarray] = None):
        d = self.distances(queries, codes)
        m = jnp.asarray(mask) if mask is not None else None
        vals, idx = masked_top_k(d, min(k, d.shape[1]), m)
        return np.asarray(vals), np.asarray(idx)

    def memory_usage(self, n_vectors: int) -> dict:
        self._check()
        orig = n_vectors * self.dims * 4
        quant = n_vectors * self.m + self.codebooks.size * 4
        return {"original_bytes": orig, "quantized_bytes": quant,
                "compression_ratio": orig / max(quant, 1)}

    def save(self, path) -> None:
        self._check()
        save_container(Path(path), {"codebooks": np.asarray(self.codebooks)},
                       meta={"kind": "product_quantizer", "dims": self.dims,
                             "m": self.m, "k": self.k})

    @classmethod
    def load(cls, path) -> "ProductQuantizer":
        c = load_container(path)
        pq = cls(dims=c.meta["dims"], m=c.meta["m"], k=c.meta["k"])
        pq.codebooks = jnp.asarray(np.asarray(c.read("codebooks")))
        return pq

    def _check(self) -> None:
        if not self.is_trained:
            raise RuntimeError("ProductQuantizer is not trained")
