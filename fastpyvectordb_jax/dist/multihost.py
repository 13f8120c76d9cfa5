"""Multi-host / multi-slice runtime helpers.

Single-host multi-chip needs nothing beyond ``make_mesh`` (dist/mesh.py);
this module covers multi-host pods: ``jax.distributed.initialize`` wiring,
global mesh construction, and host-local corpus shard placement via
``jax.make_array_from_process_local_data``.  Collectives ride NVLink
between the cards of one host and the network between hosts — the mesh
axis order below keeps the data-parallel top-k merge within a host where
possible.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import DATA_AXIS, QUERY_AXIS

# set after the first successful jax.distributed.initialize in this process
_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize the JAX distributed runtime (no-op on single host).

    Pass all three arguments (or set ``JAX_NUM_PROCESSES``): nothing in a
    GPU cluster's environment describes it to JAX.
    """
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if not (coordinator_address or num_processes):
        return  # single host: nothing to wire
    # NOTE: do not touch jax.process_count()/jax.devices() here — reading
    # them initializes the local XLA backend, after which
    # jax.distributed.initialize refuses to run.  Idempotency is tracked
    # by a module flag set on first success; the error-message sniff is
    # only a fallback for processes that initialized outside this module.
    global _initialized
    if _initialized:
        return
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
        _initialized = True
    except RuntimeError as e:
        msg = str(e).lower()
        # jax's repeated-call error reads 'should only be called once'
        if "already" not in msg and "called once" not in msg:
            raise
        _initialized = True


def global_mesh(query_parallel: int = 1) -> Mesh:
    """Mesh over every device in the job (all hosts).

    The DATA axis (corpus rows) is the fastest-varying axis so the
    per-query top-k all_gather stays within a host where possible.
    """
    from .mesh import make_mesh
    return make_mesh(query_parallel=query_parallel)


def shard_local_corpus(mesh: Mesh, local_rows: np.ndarray):
    """Assemble a globally row-sharded array from each host's local rows.

    Every process passes its own (n_local, D) block; the result is a global
    (sum n_local, D) array sharded over the DATA axis without any host ever
    materializing the full corpus — the multi-host version of the
    out-of-core story.
    """
    spec = P(DATA_AXIS, *([None] * (local_rows.ndim - 1)))
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, spec), local_rows)
