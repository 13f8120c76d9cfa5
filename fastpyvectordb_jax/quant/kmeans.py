"""Device k-means (Lloyd's) — shared by PQ codebook training and IVF.

The reference trains PQ codebooks with a NumPy k-means++ / Lloyd loop on the
host (quantization.py:444-508).  Here assignment is a chunked matmul
(the ||a||²+||b||²-2ab expansion) and the centroid update is a one-hot
matmul segment-sum, all inside one jitted ``lax.scan`` — no host round-trips
per iteration.  k-means++ seeding is replaced by random-sample init plus a
dead-centroid re-seeding step (equivalent quality at large N, and
shape-static for XLA).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST


def _pad_to_multiple(x: jnp.ndarray, m: int) -> Tuple[jnp.ndarray, int]:
    n = x.shape[0]
    pad = (-n) % m
    if pad:
        x = jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))
    return x, n


@functools.partial(jax.jit, static_argnames=("chunk",))
def assign_chunked(data: jnp.ndarray, centroids: jnp.ndarray,
                   chunk: int = 65536) -> jnp.ndarray:
    """argmin_k ||x - c_k||² for every row, scanning N in fixed chunks."""
    padded, n = _pad_to_multiple(data, chunk)  # no-op when pre-aligned
    csq = jnp.einsum("kd,kd->k", centroids, centroids,
                     preferred_element_type=jnp.float32,
                     precision=_HIGHEST)

    def body(_, x):
        d = csq[None, :] - 2.0 * jnp.dot(x, centroids.T,
                                         preferred_element_type=jnp.float32,
                                         precision=_HIGHEST)
        return None, jnp.argmin(d, axis=1).astype(jnp.int32)

    _, assign = jax.lax.scan(body, None,
                             padded.reshape(-1, chunk, padded.shape[1]))
    return assign.reshape(-1)[:data.shape[0]]


@functools.partial(jax.jit, static_argnames=("k", "iters", "chunk", "n"))
def kmeans_fit(data: jnp.ndarray, key: jax.Array, *, k: int, iters: int = 10,
               chunk: int = 16384, n: int = None) -> jnp.ndarray:
    """Fit ``k`` centroids to the first ``n`` rows of ``data`` (N_buf, D).
    Returns (k, D) f32.

    ``n`` (default: all rows) lets callers pass a capacity-padded device
    buffer DIRECTLY — a `buf[:n]` slice or a `jnp.pad` to the chunk
    multiple each copies the full corpus (6+ GB at 4M x 768 bf16, on top
    of the resident store).  Padding rows beyond ``n`` carry
    zero weight; when the buffer length is already a chunk multiple
    (every store capacity bucket is, above 16k) nothing is copied."""
    n_buf, d = data.shape
    if n is None:
        n = n_buf
    init_idx = jax.random.choice(key, n, (k,), replace=n < k)
    # centroids carry must be f32 regardless of the data dtype (bf16
    # stores pass their buffer straight in — ann/ivf.py:build)
    centroids = data[init_idx].astype(jnp.float32)
    padded, _ = _pad_to_multiple(data, chunk)  # no-op when pre-aligned
    weights = (jnp.arange(padded.shape[0]) < n).astype(jnp.float32)
    chunks = padded.reshape(-1, chunk, d)
    wchunks = weights.reshape(-1, chunk)

    def lloyd(centroids, key):
        csq = jnp.einsum("kd,kd->k", centroids, centroids,
                         preferred_element_type=jnp.float32,
                         precision=_HIGHEST)

        def body(carry, xw):
            sums, counts = carry
            x, w = xw
            dist = csq[None, :] - 2.0 * jnp.dot(
                x, centroids.T, preferred_element_type=jnp.float32,
                                precision=_HIGHEST)
            a = jnp.argmin(dist, axis=1)
            onehot = (jax.nn.one_hot(a, k, dtype=jnp.float32) * w[:, None])
            sums = sums + jnp.dot(onehot.T, x,
                                  preferred_element_type=jnp.float32,
                                  precision=_HIGHEST)
            counts = counts + onehot.sum(axis=0)
            return (sums, counts), None

        (sums, counts), _ = jax.lax.scan(
            body, (jnp.zeros((k, d), jnp.float32), jnp.zeros((k,), jnp.float32)),
            (chunks, wchunks))
        alive = counts > 0
        new_c = jnp.where(alive[:, None], sums / jnp.maximum(counts, 1.0)[:, None],
                          centroids)
        # re-seed dead centroids from random data rows
        reseed_idx = jax.random.randint(key, (k,), 0, n)
        new_c = jnp.where(alive[:, None], new_c, data[reseed_idx])
        return new_c

    def step(c, key):
        return lloyd(c, key), None

    keys = jax.random.split(key, iters)
    centroids, _ = jax.lax.scan(step, centroids, keys)
    return centroids
