"""Device-mesh helpers for multi-chip sharded search.

The reference has no distributed execution at all (SURVEY.md §2.12); its
"parallelism" is a ThreadPoolExecutor over corpus chunks
(parallel_search.py:313-368).  The device equivalent is a
``jax.sharding.Mesh``: the corpus's N axis is sharded across devices
("data" axis) and query batches can additionally be sharded across a
"query" axis; top-k merges are collectives inside ``shard_map`` (NCCL
over NVLink between the cards of one host).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"     # corpus rows
QUERY_AXIS = "query"   # query batch


def make_mesh(n_devices: Optional[int] = None,
              query_parallel: int = 1) -> Mesh:
    """1-D corpus mesh, or 2-D (query, data) when query_parallel > 1."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if n > len(devices):
        # a silent [:n] truncation would hand back fewer shards than the
        # caller planned capacity for (or crash in the 2-D reshape with a
        # bare numpy error)
        raise ValueError(f"requested {n} devices, only {len(devices)} "
                         "available")
    devices = np.asarray(devices[:n])
    if query_parallel > 1:
        if n % query_parallel:
            raise ValueError(
                f"{n} devices not divisible by query_parallel={query_parallel}")
        grid = devices.reshape(query_parallel, n // query_parallel)
        return Mesh(grid, (QUERY_AXIS, DATA_AXIS))
    return Mesh(devices, (DATA_AXIS,))


def shard_corpus(mesh: Mesh, *arrays):
    """Place arrays row-sharded along the mesh's data axis.  Row counts must
    be divisible by the data-axis size (pad first: core/store.py buckets are
    powers of two, so any pow2 mesh divides them)."""
    out = []
    for a in arrays:
        spec = P(DATA_AXIS, *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out) if len(out) != 1 else out[0]


def replicate(mesh: Mesh, *arrays):
    out = [jax.device_put(a, NamedSharding(mesh, P())) for a in arrays]
    return tuple(out) if len(out) != 1 else out[0]
