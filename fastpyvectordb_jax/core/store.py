"""Device-resident corpus buffer with power-of-two capacity bucketing.

The reference keeps vectors inside the hnswlib C++ index and lazily rebuilds
an (N, D) NumPy matrix for brute-force ops (vectordb_optimized.py:236-269).
Here the corpus *lives on the device* as a pre-allocated ``(cap, D)`` buffer
(the pre-allocation pattern of the reference's mmap store,
parallel_search.py:516-559) so that search is a zero-copy jitted dispatch:

  * ``cap`` is always a power of two (>= 1024) so XLA compiles one kernel per
    capacity bucket, not per insert.
  * inserts pad the incoming batch to a power-of-two block and write it with
    ``lax.dynamic_update_slice``; a row-validity vector distinguishes real
    rows from padding and tombstones.
  * deletes are tombstones in the validity mask (mark_deleted semantics,
    vectordb_optimized.py:474) — but unlike hnswlib, ``compact()`` can
    physically reclaim space.
  * per-row norm caches (squared norms + reciprocal norms) are maintained
    incrementally for the cosine / L2 kernels.

Donated jitted updaters keep inserts in-place on device (no host round-trip,
no buffer copy).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels import distances as K

MIN_CAPACITY = 1024


from ..utils import next_pow2 as _next_pow2  # shared helper


def _ladder(n: int) -> int:
    """Smallest value >= n from the {2^k, 3*2^(k-1)} ladder
    (..., 1024, 1536, 2048, 3072, ...)."""
    p = _next_pow2(n)
    h = 3 * p // 4
    return h if n <= h else p


def _next_bucket(n: int) -> int:
    """Capacity bucket for ``n`` rows.  Pure pow2 bucketing wastes up
    to 2x device memory at the worst point (a 5M x 768 bf16 corpus would
    land in an 8.4M-row 12.9 GB buffer); the half-step ladder caps waste
    at 33% for twice the compile-bucket count (cached across runs)."""
    return _ladder(max(n, MIN_CAPACITY))


def pad_rows(arr: np.ndarray, to: int) -> np.ndarray:
    """Pad the leading axis of ``arr`` with zeros up to ``to`` rows."""
    n = arr.shape[0]
    if n == to:
        return arr
    pad = [(0, to - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3))
def _write_block(
    vectors: jnp.ndarray,
    valid: jnp.ndarray,
    sq: jnp.ndarray,
    rinv: jnp.ndarray,
    block: jnp.ndarray,
    n_real: jnp.ndarray,
    start: jnp.ndarray,
):
    """Write a padded block of rows at ``start``; update caches in place."""
    p = block.shape[0]
    # norms of the rows as STORED (a bf16 store rounds them), so they agree
    # with what a reload recomputes from the persisted buffer
    block = block.astype(vectors.dtype)
    vectors = jax.lax.dynamic_update_slice(vectors, block,
                                           (start, jnp.int32(0)))
    row_ids = jax.lax.broadcasted_iota(jnp.int32, (p,), 0)
    new_valid = row_ids < n_real
    valid = jax.lax.dynamic_update_slice(valid, new_valid, (start,))
    bsq = jnp.einsum("nd,nd->n", block, block, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    brinv = _rinv(bsq)
    sq = jax.lax.dynamic_update_slice(sq, bsq, (start,))
    rinv = jax.lax.dynamic_update_slice(rinv, brinv, (start,))
    return vectors, valid, sq, rinv


def _rinv(sq: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(sq > 0, jax.lax.rsqrt(jnp.maximum(sq, 1e-30)), 0.0)


@jax.jit
def _set_norms(sq: jnp.ndarray, rows_sq: jnp.ndarray):
    """Overwrite the first rows' squared norms (and reciprocal norms)."""
    sq = jax.lax.dynamic_update_slice(sq, rows_sq, (0,))
    return sq, _rinv(sq)


@functools.partial(jax.jit, donate_argnums=(0,))
def _tombstone(valid: jnp.ndarray, rows: jnp.ndarray) -> jnp.ndarray:
    return valid.at[rows].set(False, mode="drop")


class DeviceVectorStore:
    """Append-only device buffer of float32 vectors with tombstone deletes."""

    def __init__(self, dims: int, capacity: int = MIN_CAPACITY,
                 storage_dtype: str = "float32"):
        self.dims = int(dims)
        self.storage_dtype = jnp.dtype(storage_dtype)
        cap = _next_bucket(max(capacity, MIN_CAPACITY))
        self.vectors = jnp.zeros((cap, self.dims), dtype=self.storage_dtype)
        self.valid = jnp.zeros((cap,), dtype=bool)
        self.sq = jnp.zeros((cap,), dtype=jnp.float32)
        self.rinv = jnp.zeros((cap,), dtype=jnp.float32)
        self.count = 0          # rows ever allocated (monotonic high-water mark)
        self.n_valid = 0        # live rows (count minus tombstones)
        self._mask_memo: dict = {}  # id(host mask) -> (mask, valid, device mask)

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    def _grow(self, needed: int) -> None:
        new_cap = _next_bucket(needed)
        pad = new_cap - self.capacity
        self.vectors = jnp.pad(self.vectors, ((0, pad), (0, 0)))
        self.valid = jnp.pad(self.valid, ((0, pad),))
        self._mask_memo.clear()  # capacity changed: cached masks are stale
        self.sq = jnp.pad(self.sq, ((0, pad),))
        self.rinv = jnp.pad(self.rinv, ((0, pad),))

    def append(self, vecs: np.ndarray) -> np.ndarray:
        """Append a (n, D) float32 batch; returns the assigned row indices."""
        n = vecs.shape[0]
        if n == 0:
            return np.empty((0,), dtype=np.int64)
        # The written block is padded to p rows, so the buffer must hold
        # count + p (not just count + n): dynamic_update_slice clamps the
        # start index, and a clamped write would silently overwrite earlier
        # live rows while marking the new rows invalid.
        p = _ladder(max(n, 8))
        if self.count + p > self.capacity:
            self._grow(self.count + p)
        block = pad_rows(np.ascontiguousarray(vecs, dtype=np.float32), p)
        self.vectors, self.valid, self.sq, self.rinv = _write_block(
            self.vectors, self.valid, self.sq, self.rinv,
            jnp.asarray(block), jnp.int32(n), jnp.int32(self.count),
        )
        rows = np.arange(self.count, self.count + n, dtype=np.int64)
        self.count += n
        self.n_valid += n
        return rows

    def delete_rows(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, dtype=np.int32)
        if rows.size == 0:
            return
        self.valid = _tombstone(self.valid, jnp.asarray(rows))
        self.n_valid -= int(rows.size)

    def get_rows(self, rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows, dtype=np.int32)
        if rows.size == 0:
            return np.empty((0, self.dims), dtype=np.float32)
        out = jnp.take(self.vectors, jnp.asarray(rows), axis=0)
        return np.asarray(out, dtype=np.float32)

    # -- search -----------------------------------------------------------
    def search(
        self,
        queries: np.ndarray,
        k: int,
        metric,
        extra_mask: Optional[np.ndarray] = None,
        compute_dtype: str = "float32",
        topk: str = "exact",
        return_device: bool = False,
        wire_dtype: Optional[str] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Masked top-k over the live rows.

        queries: (B, D) float32. extra_mask: optional host bool mask over
        rows [0, count) (a compiled Filter mask).  topk: "exact" | "approx"
        | "auto" (the platform's choice, kernels/select.py).
        wire_dtype: host->device query encoding — None picks bfloat16
        when compute is bfloat16 (half the upload bytes, free accuracy);
        "int8" ships 4x-compressed codes + a per-batch scale and dequants
        in-graph (a quarter of the upload bytes at a small recall cost;
        opt-in for throughput callers).
        Returns (dists (B, k'), rows (B, k')) with k' = min(k, capacity) —
        callers trim masked-out sentinel hits via kernels.topk.valid_hits.
        """
        b = queries.shape[0]
        bp = _next_pow2(max(b, 8))
        if isinstance(queries, jax.Array) and not isinstance(queries, np.ndarray):
            # device queries stay on device: no host bounce, pad in-graph
            q = queries.astype(jnp.float32)
            if b != bp:
                q = jnp.pad(q, ((0, bp - b), (0, 0)))
        else:
            qh = pad_rows(np.ascontiguousarray(queries, dtype=np.float32), bp)
            if wire_dtype == "int8":
                # symmetric per-batch scale: codes = round(q/s), s sized so
                # the max magnitude lands on ±127; dequant in-graph
                s = float(np.abs(qh).max()) / 127.0 or 1.0
                codes = np.clip(np.rint(qh / s), -127, 127).astype(np.int8)
                q = jnp.asarray(codes).astype(jnp.float32) * jnp.float32(s)
            elif compute_dtype == "bfloat16":
                # bf16 serving: demote the query block on the HOST so the
                # upload moves half the bytes.  The kernel computes in
                # bf16 either way.
                import ml_dtypes
                qh = qh.astype(ml_dtypes.bfloat16)
                q = jnp.asarray(qh)
            else:
                q = jnp.asarray(qh)
        mask = self._combined_mask(extra_mask)
        kk = min(k, self.capacity)
        approx = topk == "approx"   # "auto" and "exact" select exactly
        vals, rows = K.search_kernel(
            q, self.vectors, self.sq, self.rinv, mask,
            metric=metric, k=kk, compute_dtype=compute_dtype, approx=approx,
        )
        if return_device:
            return vals[:b], rows[:b]  # caller pipelines / syncs itself
        vals, rows = jax.device_get((vals, rows))  # one host sync, not two
        return vals[:b], rows[:b]

    def _combined_mask(self, extra_mask: Optional[np.ndarray]):
        """valid AND extra_mask as a device array, memoized.

        Keyed on the identity of BOTH the caller's host mask (stable: the
        Collection's filter-mask cache hands out the same array per
        (fingerprint, version)) and the current validity buffer (a new
        object after any mutation) — so repeated filtered searches reuse
        one device mask instead of shipping capacity bytes per call."""
        if extra_mask is None:
            return self.valid
        key = id(extra_mask)
        hit = self._mask_memo.get(key)
        if hit is not None and hit[0] is extra_mask and hit[1] is self.valid:
            return hit[2]
        m = np.zeros((self.capacity,), dtype=bool)
        m[: extra_mask.shape[0]] = extra_mask
        dm = jnp.logical_and(self.valid, jnp.asarray(m))
        if len(self._mask_memo) >= 8:  # bound pinned HBM to 8 masks
            self._mask_memo.clear()
        self._mask_memo[key] = (extra_mask, self.valid, dm)
        return dm

    # -- maintenance ------------------------------------------------------
    def live_rows_host(self) -> np.ndarray:
        """Row indices of live rows (host copy of the validity mask)."""
        v = np.asarray(self.valid[: max(self.count, 1)])
        return np.nonzero(v[: self.count])[0]

    def compact(self) -> np.ndarray:
        """Physically drop tombstoned rows.  Returns old-row -> position map
        (the caller must remap its id <-> row tables).  hnswlib can never do
        this (vectordb_optimized.py:474 keeps tombstones forever)."""
        live = self.live_rows_host()
        vecs = self.get_rows(live)
        cap = _next_bucket(max(live.size, MIN_CAPACITY))
        self.vectors = jnp.zeros((cap, self.dims), dtype=self.storage_dtype)
        self.valid = jnp.zeros((cap,), dtype=bool)
        self.sq = jnp.zeros((cap,), dtype=jnp.float32)
        self.rinv = jnp.zeros((cap,), dtype=jnp.float32)
        self.count = 0
        self.n_valid = 0
        self._mask_memo.clear()
        if live.size:
            self.append(vecs)
        return live

    # -- persistence helpers ---------------------------------------------
    def export_arrays(self) -> dict:
        n = self.count
        return {
            "vectors": np.asarray(self.vectors[:n], dtype=np.float32),
            "valid": np.asarray(self.valid[:n]),
            "sq": np.asarray(self.sq[:n]),
        }

    @classmethod
    def from_arrays(cls, vectors: np.ndarray, valid: np.ndarray,
                    storage_dtype: str = "float32",
                    sq: Optional[np.ndarray] = None) -> "DeviceVectorStore":
        """Rebuild a store from exported arrays.  ``sq`` restores the
        row norms bit for bit: recomputing them over one large block can
        round differently from the blocks they were first computed in,
        and a reloaded collection must answer exactly as it did."""
        n, d = vectors.shape
        store = cls(d, capacity=max(n, MIN_CAPACITY), storage_dtype=storage_dtype)
        if n:
            store.append(vectors)
            if sq is not None:
                store.sq, store.rinv = _set_norms(
                    store.sq, jnp.asarray(np.asarray(sq, np.float32)))
            dead = np.nonzero(~np.asarray(valid, dtype=bool))[0]
            if dead.size:
                store.delete_rows(dead)
        return store
