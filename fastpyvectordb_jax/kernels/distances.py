"""Batched distance kernels — the matmul core of the engine.

The reference computes query-corpus distances with NumPy BLAS GEMM
(parallel_search.py:246-311, vectordb_optimized.py:650-721).  Here the same
math is one jitted XLA matmul on the device, with:

  * cosine via pre-cached corpus inverse norms (no per-query corpus pass),
  * L2 via the ||a||^2 + ||b||^2 - 2ab expansion (squared domain inside the
    kernel; sqrt applied only to the final top-k values),
  * dot as the negated inner product,
  * an optional validity/filter mask fused as ``where(mask, d, +inf)``
    (the reference applies the same masking idea at
    vectordb_optimized.py:686-692 but cannot fuse it into the GEMM).

All functions are shape-polymorphic pure functions; callers are responsible
for padding to compile-friendly bucket shapes (core/store.py does this).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import DistanceMetric

# A large-but-finite sentinel used to disqualify masked-out rows.  Using +inf
# directly breaks `top_k` tie-handling on some backends when every row is
# masked; a finite sentinel keeps the lattice total.  A numpy (not jnp)
# scalar: materializing a device array at import time would initialize the
# XLA backend and break jax.distributed.initialize on multi-host jobs.
MASKED = np.float32(3.0e38)


def matmul_precision(compute_dtype) -> jax.lax.Precision:
    """float32 compute means *exact* float32: without a stated precision a
    GPU may run an f32 product in TF32 (about three decimal digits), so
    request Precision.HIGHEST.  bfloat16 compute keeps the fast default."""
    return (jax.lax.Precision.HIGHEST
            if jnp.dtype(compute_dtype) == jnp.float32
            else jax.lax.Precision.DEFAULT)


def _norms_sq(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.einsum("nd,nd->n", v, v, preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


@jax.jit
def _corpus_stats_jit(v):
    # f32 ACCUMULATION via preferred_element_type, never an astype: an
    # eager astype of a bf16 serving corpus materializes a full-size f32
    # copy on device (at 5Mx768 that is +14.3 GB)
    sq = _norms_sq(v)
    rinv = jnp.where(sq > 0, jax.lax.rsqrt(jnp.maximum(sq, 1e-30)), 0.0)
    return sq, rinv


def host_exact_scores(q: "np.ndarray", cand: "np.ndarray",
                      metric: DistanceMetric) -> "np.ndarray":
    """Exact metric over gathered candidates on the HOST: q (B, D) f32 x
    cand (B, C, D) f32 -> (B, C) scores, lower = closer.  One shared
    implementation behind Collection._exact_rescore and
    BigCollection._exact_host (identical metric algebra used to live in
    both and could drift)."""
    cross = np.einsum("bd,bcd->bc", q, cand, optimize=True)
    if metric == DistanceMetric.COSINE:
        qn = np.linalg.norm(q, axis=1, keepdims=True)
        cn = np.linalg.norm(cand, axis=2)
        return 1.0 - cross / np.maximum(qn * cn, 1e-30)
    if metric == DistanceMetric.L2:
        qsq = np.einsum("bd,bd->b", q, q)
        csq = np.einsum("bcd,bcd->bc", cand, cand, optimize=True)
        return np.sqrt(np.maximum(qsq[:, None] + csq - 2.0 * cross, 0.0))
    return -cross


def corpus_stats(vectors: jnp.ndarray) -> dict:
    """Per-row cached statistics for the corpus buffer.

    Returns dict with:
      ``sq``: (N,) float32 squared L2 norms (for the L2 expansion)
      ``rinv``: (N,) float32 reciprocal norms (for cosine; 0-norm rows -> 0)
    """
    sq, rinv = _corpus_stats_jit(vectors)
    return {"sq": sq, "rinv": rinv}


def scores(
    queries: jnp.ndarray,
    vectors: jnp.ndarray,
    metric: DistanceMetric,
    *,
    corpus_sq: Optional[jnp.ndarray] = None,
    corpus_rinv: Optional[jnp.ndarray] = None,
    compute_dtype: jnp.dtype = jnp.float32,
) -> jnp.ndarray:
    """(B, D) x (N, D) -> (B, N) score matrix; lower = closer.

    For L2 the returned scores are *squared* distances (rank-equivalent);
    callers take sqrt of the k winners only (kernels/topk.py).
    """
    q = queries.astype(jnp.float32)
    v = vectors
    prec = matmul_precision(compute_dtype)

    def mm(a, b):
        return jnp.dot(a.astype(compute_dtype), b.astype(compute_dtype).T,
                       preferred_element_type=jnp.float32, precision=prec)

    if metric == DistanceMetric.COSINE:
        qsq = _norms_sq(q)
        qinv = jnp.where(qsq > 0, jax.lax.rsqrt(jnp.maximum(qsq, 1e-30)), 0.0)
        qn = q * qinv[:, None]
        if corpus_rinv is None:
            corpus_rinv = corpus_stats(v)["rinv"]
        return 1.0 - mm(qn, v) * corpus_rinv[None, :]
    elif metric == DistanceMetric.L2:
        if corpus_sq is None:
            corpus_sq = corpus_stats(v)["sq"]
        qsq = _norms_sq(q)
        d2 = qsq[:, None] + corpus_sq[None, :] - 2.0 * mm(q, v)
        return jnp.maximum(d2, 0.0)
    elif metric == DistanceMetric.DOT:
        return -mm(q, v)
    raise ValueError(f"unknown metric {metric}")


def mask_scores(s: jnp.ndarray, mask: Optional[jnp.ndarray]) -> jnp.ndarray:
    """Disqualify rows where ``mask`` is False (mask shape (N,) or (B, N))."""
    if mask is None:
        return s
    if mask.ndim == 1:
        mask = mask[None, :]
    return jnp.where(mask, s, MASKED)


@functools.partial(
    jax.jit,
    static_argnames=("metric", "k", "compute_dtype", "sqrt_l2", "approx"),
)
def search_kernel(
    queries: jnp.ndarray,
    vectors: jnp.ndarray,
    corpus_sq: jnp.ndarray,
    corpus_rinv: jnp.ndarray,
    mask: Optional[jnp.ndarray],
    *,
    metric: DistanceMetric,
    k: int,
    compute_dtype: str = "float32",
    sqrt_l2: bool = True,
    approx: bool = False,
):
    """Fused distances + masked top-k.  Returns (dists (B,k), rows (B,k)).

    Replaces the reference's GEMM + argpartition pipeline
    (parallel_search.py:246-311) and its post-hoc filter loop
    (vectordb_optimized.py:550-573) with a single compiled dispatch.

    ``approx=True`` selects with ``lax.approx_max_k`` (recall_target
    0.99 per element).  On the CPU and the GPU XLA has no approximate
    lowering for it and turns it into a sort of each row, so there it
    returns exact results (kernels/select.py decides whether ``auto``
    uses it).
    """
    cd = jnp.dtype(compute_dtype)
    s = scores(
        queries,
        vectors,
        metric,
        corpus_sq=corpus_sq,
        corpus_rinv=corpus_rinv,
        compute_dtype=cd,
    )
    s = mask_scores(s, mask)
    if approx:
        # selection stays f32 even for bf16 compute: this path returns the
        # picks directly, and bf16 scores would round near neighbours into
        # ties
        neg_vals, rows = jax.lax.approx_max_k(-s, k, recall_target=0.99)
    else:
        neg_vals, rows = jax.lax.top_k(-s, k)
    vals = -neg_vals
    if metric == DistanceMetric.L2 and sqrt_l2:
        vals = jnp.where(vals >= MASKED, vals, jnp.sqrt(jnp.maximum(vals, 0.0)))
    return vals, rows
