"""Core shared types for the device-resident vector engine.

Capability parity with the reference engine's result/config types
(reference: vectordb_optimized.py:40-53, 191-200) but designed for a
device-resident, fixed-shape engine:

- ``DistanceMetric`` values are our own names (not hnswlib space strings).
- ``CollectionConfig`` replaces HNSW hyperparameters (M / ef_construction /
  ef_search) with device-relevant knobs: compute dtype for the distance
  matmul and the ANN/quantization mode.  ``max_elements`` is not needed — device
  buffers grow by power-of-two doubling (see core/store.py).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import numpy as np


class DistanceMetric(str, enum.Enum):
    """Distance metrics. Semantics (lower score = closer for all three):

    - COSINE: ``1 - cos_sim(q, v)``
    - L2:     Euclidean distance ``||q - v||``
    - DOT:    negative inner product ``-<q, v>``

    The reference's brute-force path uses the same conventions
    (vectordb_optimized.py:667-683); its HNSW path returns squared L2, a
    divergence we do not reproduce.
    """

    COSINE = "cosine"
    L2 = "l2"
    DOT = "ip"  # value kept as "ip" for reference-config compatibility

    @classmethod
    def parse(cls, value: "DistanceMetric | str") -> "DistanceMetric":
        if isinstance(value, DistanceMetric):
            return value
        v = str(value).lower()
        aliases = {
            "cosine": cls.COSINE,
            "l2": cls.L2,
            "euclidean": cls.L2,
            "ip": cls.DOT,
            "dot": cls.DOT,
            "inner_product": cls.DOT,
        }
        if v not in aliases:
            raise ValueError(f"Unknown distance metric: {value!r}")
        return aliases[v]


@dataclasses.dataclass
class SearchResult:
    """One search hit (reference: vectordb_optimized.py:40-46)."""

    id: str
    score: float
    metadata: dict
    vector: Optional[np.ndarray] = None

    def to_dict(self, include_vector: bool = False) -> dict:
        d = {"id": self.id, "score": float(self.score), "metadata": self.metadata}
        if include_vector and self.vector is not None:
            d["vector"] = np.asarray(self.vector).tolist()
        return d


@dataclasses.dataclass
class CollectionConfig:
    """Per-collection configuration (reference: vectordb_optimized.py:191-200).

    Device-specific fields:
      compute_dtype: dtype used for the distance matmul.  "float32" is
        exact (Precision.HIGHEST); "bfloat16" runs on the tensor cores at
        ~1e-3 relative distance error.
      storage_dtype: dtype of the device-resident corpus buffer.
      index: "flat" (exact scan — the default), "ivf" (clustered
        approximate scan).
    """

    name: str
    dimensions: int
    metric: DistanceMetric = DistanceMetric.COSINE
    compute_dtype: str = "float32"
    storage_dtype: str = "float32"
    index: str = "flat"
    # IVF parameters (used when index == "ivf"):
    ivf_nlist: int = 0  # 0 => auto (~sqrt(N))
    ivf_nprobe: int = 32
    # Over-fetch factor for filtered ANN search; the exact path fuses the
    # filter mask into top-k and never over-fetches.
    overfetch: int = 10
    # top-k selection for the exact scan: "exact" (lax.top_k), "approx"
    # (lax.approx_max_k; on the CPU and the GPU XLA lowers it to a sort of
    # each row, which returns exact results and is slower than top_k), or
    # "auto" (exact, as the faster choice on both).
    topk: str = "auto"
    # durability: "snapshot" (reference parity — state persists only on
    # save(), vectordb_optimized.py:306-331) or "wal" (every mutation is
    # logged to a checksummed write-ahead log first and replayed over the
    # last snapshot on load; persist/wal.py).  Requires a base_path.
    durability: str = "snapshot"
    # fsync the WAL on every append (true durability against power loss;
    # ~10-100x slower appends on most filesystems) vs flush-only (survives
    # process crashes, the common case).
    wal_fsync: bool = False
    # Index-rebuild policy when drift fires (Collection._index_rebuild_due:
    # >25% tail growth or >50% mass delete): "background" rebuilds in a
    # daemon thread and atomically swaps the new index in — searches keep
    # serving through the stale index + exact tail merge and are never
    # blocked by a minutes-long k-means; "inline" rebuilds synchronously
    # inside the triggering search call (deterministic; the round-2
    # behavior).
    rebuild: str = "background"

    def __post_init__(self) -> None:
        self.metric = DistanceMetric.parse(self.metric)
        if self.dimensions <= 0:
            raise ValueError("dimensions must be positive")
        if self.rebuild not in ("background", "inline"):
            raise ValueError(
                f"rebuild must be 'background' or 'inline', got "
                f"{self.rebuild!r}")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["metric"] = self.metric.value
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CollectionConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def as_f32_matrix(x: Any, dims: Optional[int] = None, name: str = "vectors",
                  allow_device: bool = False):
    """Coerce input to a contiguous float32 (N, D) matrix, validating dims.

    With ``allow_device=True`` jax arrays stay on device — shape/dtype
    validation needs no host transfer, and bouncing a query batch through
    numpy costs two copies per search call."""
    if allow_device and not isinstance(x, np.ndarray) \
            and type(x).__module__.startswith("jax"):
        arr = x
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.ndim != 2:
            raise ValueError(f"{name} must be 1-D or 2-D, got shape {arr.shape}")
        if dims is not None and arr.shape[1] != dims:
            raise ValueError(
                f"{name} dimensionality {arr.shape[1]} does not match "
                f"collection dimensions {dims}")
        import jax.numpy as jnp
        return arr.astype(jnp.float32) if arr.dtype != jnp.float32 else arr
    arr = np.ascontiguousarray(np.asarray(x, dtype=np.float32))
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.ndim != 2:
        raise ValueError(f"{name} must be 1-D or 2-D, got shape {arr.shape}")
    if dims is not None and arr.shape[1] != dims:
        raise ValueError(
            f"{name} dimensionality {arr.shape[1]} does not match collection "
            f"dimensions {dims}"
        )
    return arr
