"""Top-k utilities: masked top-k and partial-result merging.

The reference merges per-chunk top-k lists host-side with vstack +
argpartition (parallel_search.py:137-156).  On the device the same merge is
a concatenate + ``lax.top_k``; the sharded variant in dist/sharded.py uses
the identical merge after an ``all_gather`` across the devices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .distances import MASKED


def masked_top_k(
    scores: jnp.ndarray,
    k: int,
    mask: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Smallest-k of a (B, N) score matrix with optional boolean mask.

    Returns (vals (B,k), idx (B,k)); disqualified rows surface with score
    >= MASKED so callers can trim them.
    """
    if mask is not None:
        if mask.ndim == 1:
            mask = mask[None, :]
        scores = jnp.where(mask, scores, MASKED)
    neg, idx = jax.lax.top_k(-scores, k)
    return -neg, idx


def merge_top_k(
    vals_parts: jnp.ndarray,
    idx_parts: jnp.ndarray,
    k: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Merge P partial top-k lists per query.

    vals_parts: (P, B, k_p) partial scores (lower = better)
    idx_parts:  (P, B, k_p) global row indices
    Returns (vals (B,k), idx (B,k)).
    """
    p, b, kp = vals_parts.shape
    vals = jnp.moveaxis(vals_parts, 0, 1).reshape(b, p * kp)
    idxs = jnp.moveaxis(idx_parts, 0, 1).reshape(b, p * kp)
    top_vals, pos = jax.lax.top_k(-vals, k)
    return -top_vals, jnp.take_along_axis(idxs, pos, axis=1)


def merge_topk_host(d1, r1, d2, r2, k: int):
    """Host-side merge of two per-query top-k lists (e.g. an ANN or
    quantized snapshot's hits over the indexed prefix plus the exact scan
    over the appended tail).  The two row spaces must be disjoint — the
    indexed prefix yields rows < built_count, the tail rows >= built_count —
    so no dedup is needed.  MASKED sentinels sort last naturally.
    """
    import numpy as np
    d = np.concatenate([np.asarray(d1), np.asarray(d2)], axis=1)
    r = np.concatenate([np.asarray(r1), np.asarray(r2)], axis=1)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(d, order, axis=1),
            np.take_along_axis(r, order, axis=1))


def valid_hits(vals) -> "jnp.ndarray | np.ndarray":
    """Boolean (B, k) marking hits that were not masked out.

    Stays in the caller's domain: a numpy input is compared with numpy (no
    device round-trip — this runs on the host assembly path per batch)."""
    import numpy as np
    if isinstance(vals, np.ndarray):
        return vals < float(MASKED) * 0.5
    return vals < MASKED * 0.5
