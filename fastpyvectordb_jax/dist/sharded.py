"""Multi-chip sharded exact search with distributed top-k merge.

The device rendition of the reference's chunked thread fan-out
(parallel_search.py:313-368: per-chunk local top-k, host merge): the corpus
is row-sharded across the mesh's "data" axis, every device computes its
shard's distances and a *local* top-k, the (vals, global-row) partials are
``all_gather``-ed across devices, and a final top-k of n_dev*k entries
yields the global result — the `_merge_top_k` pattern (parallel_search.py:137-156)
as a collective.

Optionally the query batch is simultaneously sharded over a "query" axis
(2-D mesh), giving query-data parallelism the reference cannot express.

Also provides ``sharded_kmeans_step`` — the distributed training step for
IVF/PQ codebooks: per-shard assignment + partial sums, ``psum`` over the
data axis, centroid update.  This is the framework's "training loop".
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core.types import DistanceMetric
from ..kernels.distances import MASKED, matmul_precision
from .mesh import DATA_AXIS, QUERY_AXIS


def _local_scores(q, v, metric, compute_dtype, vsq=None, rinv=None):
    prec = matmul_precision(compute_dtype)

    def mm(a, b):
        return jnp.dot(a.astype(compute_dtype), b.astype(compute_dtype).T,
                       preferred_element_type=jnp.float32, precision=prec)

    qf = q.astype(jnp.float32)
    vf = v.astype(jnp.float32)
    if metric == DistanceMetric.COSINE:
        qn = qf / jnp.maximum(jnp.linalg.norm(qf, axis=1, keepdims=True), 1e-30)
        if rinv is None:
            vsq = jnp.einsum("nd,nd->n", vf, vf,
                             preferred_element_type=jnp.float32,
                             precision=jax.lax.Precision.HIGHEST)
            rinv = jnp.where(vsq > 0,
                             jax.lax.rsqrt(jnp.maximum(vsq, 1e-30)), 0.0)
        return 1.0 - mm(qn, vf) * rinv[None, :]
    if metric == DistanceMetric.L2:
        if vsq is None:
            vsq = jnp.einsum("nd,nd->n", vf, vf,
                             preferred_element_type=jnp.float32,
                             precision=jax.lax.Precision.HIGHEST)
        qsq = jnp.einsum("bd,bd->b", qf, qf, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        return jnp.maximum(qsq[:, None] + vsq[None, :] - 2.0 * mm(qf, vf), 0.0)
    return -mm(qf, vf)


def build_sharded_search(mesh: Mesh, *, metric: DistanceMetric, k: int,
                         compute_dtype: str = "float32", sqrt_l2: bool = True,
                         with_stats: bool = False):
    """Compile a sharded search fn over ``mesh``.

    Returned fn signature: (queries (B, D) [sharded on QUERY axis if the
    mesh has one], vectors (N, D) sharded on DATA, valid (N,) sharded on
    DATA) -> (dists (B, k), rows (B, k)) fully replicated.
    """
    has_query_axis = QUERY_AXIS in mesh.axis_names
    q_spec = P(QUERY_AXIS, None) if has_query_axis else P(None, None)
    out_spec = (q_spec, q_spec)
    metric = DistanceMetric.parse(metric)

    def local(q, v, valid, *stats):
        shard_rows = v.shape[0]
        vsq, rinv = stats if stats else (None, None)
        s = _local_scores(q, v, metric, jnp.dtype(compute_dtype),
                          vsq=vsq, rinv=rinv)
        s = jnp.where(valid[None, :], s, MASKED)
        kk = min(k, shard_rows)
        neg, idx = jax.lax.top_k(-s, kk)
        gidx = idx + jax.lax.axis_index(DATA_AXIS) * shard_rows
        # all_gather partials over the data ring: (ndev, B, kk)
        vals_g = jax.lax.all_gather(-neg, DATA_AXIS)
        idx_g = jax.lax.all_gather(gidx, DATA_AXIS)
        ndev, b, _ = vals_g.shape
        vals_f = jnp.moveaxis(vals_g, 0, 1).reshape(b, ndev * kk)
        idx_f = jnp.moveaxis(idx_g, 0, 1).reshape(b, ndev * kk)
        neg2, pos = jax.lax.top_k(-vals_f, min(k, ndev * kk))
        vals = -neg2
        rows = jnp.take_along_axis(idx_f, pos, axis=1)
        if metric == DistanceMetric.L2 and sqrt_l2:
            vals = jnp.where(vals >= MASKED, vals,
                             jnp.sqrt(jnp.maximum(vals, 0.0)))
        return vals, rows

    in_specs = (q_spec, P(DATA_AXIS, None), P(DATA_AXIS))
    if with_stats:
        in_specs = in_specs + (P(DATA_AXIS), P(DATA_AXIS))
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=in_specs,
        out_specs=out_spec,
        check_vma=False,
    )
    return jax.jit(fn)


def build_sharded_kmeans_step(mesh: Mesh, *, k: int):
    """Compile one distributed Lloyd's step: data sharded on DATA axis,
    centroids replicated; partial sums/counts are ``psum``-ed across
    devices.

    This is the multi-chip "training step" for IVF cells and PQ codebooks.
    """

    def local(data, weights, centroids):
        csq = jnp.einsum("kd,kd->k", centroids, centroids,
                         preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        dist = csq[None, :] - 2.0 * jnp.dot(
            data, centroids.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST)
        a = jnp.argmin(dist, axis=1)
        onehot = jax.nn.one_hot(a, k, dtype=jnp.float32) * weights[:, None]
        sums = jax.lax.psum(
            jnp.dot(onehot.T, data, preferred_element_type=jnp.float32,
                                    precision=jax.lax.Precision.HIGHEST),
            DATA_AXIS)
        counts = jax.lax.psum(onehot.sum(axis=0), DATA_AXIS)
        alive = counts > 0
        new_c = jnp.where(alive[:, None],
                          sums / jnp.maximum(counts, 1.0)[:, None], centroids)
        return new_c, counts

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P(None, None)),
        out_specs=(P(None, None), P(None)),
        check_vma=False,
    )
    return jax.jit(fn)


class ShardedSearcher:
    """Holds a row-sharded corpus + compiled search fns keyed by (k, B)."""

    def __init__(self, mesh: Mesh, vectors, valid, *,
                 metric: DistanceMetric, compute_dtype: str = "float32"):
        from .mesh import shard_corpus
        self.mesh = mesh
        ndata = mesh.shape[DATA_AXIS]
        n = vectors.shape[0]
        if n % ndata:
            raise ValueError(f"corpus rows {n} not divisible by data axis "
                             f"{ndata}; pad to a power-of-two bucket first")
        self.vectors, self.valid = shard_corpus(mesh, vectors, valid)
        self.metric = DistanceMetric.parse(metric)
        self.compute_dtype = compute_dtype
        # per-row stats once at construction, not per search call — the
        # corpus is immutable here, so recomputing the O(N*D) norms pass
        # inside every query batch wasted roughly half the B=1 kernel
        # (row-wise ops keep the DATA sharding under jit)
        from ..kernels.distances import corpus_stats
        stats = corpus_stats(self.vectors)  # sharding propagates under jit
        self.vsq, self.rinv = stats["sq"], stats["rinv"]
        self._fns = {}

    def search(self, queries, k: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
        if k not in self._fns:
            self._fns[k] = build_sharded_search(
                self.mesh, metric=self.metric, k=k,
                compute_dtype=self.compute_dtype, with_stats=True)
        return self._fns[k](queries, self.vectors, self.valid,
                            self.vsq, self.rinv)
