"""Worker for tests/test_multihost.py — one of two localhost
``jax.distributed`` processes exercising the real multi-controller path:
initialize -> global mesh -> shard_local_corpus -> one sharded search.

Usage: python multihost_worker.py <process_id> <num_processes> <port>
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=2 "
    + os.environ.get("XLA_FLAGS", ""))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_LOCAL, D, B, K = 128, 32, 4, 5


def main() -> None:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    # initialize the distributed runtime BEFORE importing the package —
    # module-level jax use anywhere in the import graph would pin the
    # local-only XLA backend and make initialize() refuse to run
    from fastpyvectordb_jax.dist import multihost
    multihost.initialize(coordinator_address=f"localhost:{port}",
                         num_processes=nproc, process_id=pid)
    from fastpyvectordb_jax.core.types import DistanceMetric
    from fastpyvectordb_jax.dist.sharded import build_sharded_search
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == nproc * 2, len(jax.devices())

    mesh = multihost.global_mesh()

    # deterministic per-process corpus block: every process can reconstruct
    # the FULL corpus for the ground-truth check without any host ever
    # holding it on device
    blocks = [np.random.default_rng(seed).standard_normal(
        (N_LOCAL, D)).astype(np.float32) for seed in range(nproc)]
    local = blocks[pid]
    full = np.concatenate(blocks, axis=0)

    v_global = multihost.shard_local_corpus(mesh, local)
    valid_global = multihost.shard_local_corpus(
        mesh, np.ones((N_LOCAL,), dtype=bool))
    assert v_global.shape == (nproc * N_LOCAL, D)

    q = np.random.default_rng(99).standard_normal((B, D)).astype(np.float32)
    fn = build_sharded_search(mesh, metric=DistanceMetric.COSINE, k=K)
    dists, rows = fn(q, v_global, valid_global)
    dists, rows = np.asarray(dists), np.asarray(rows)  # replicated outputs

    # exact ground truth on host
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    vn = full / np.linalg.norm(full, axis=1, keepdims=True)
    gt = 1.0 - qn @ vn.T
    gt_rows = np.argsort(gt, axis=1)[:, :K]
    gt_vals = np.take_along_axis(gt, gt_rows, axis=1)

    np.testing.assert_allclose(dists, gt_vals, atol=1e-4)
    assert all(set(r) == set(g) for r, g in zip(rows.tolist(),
                                                gt_rows.tolist()))
    print(f"MULTIHOST_OK pid={pid} devices={len(jax.devices())}", flush=True)


if __name__ == "__main__":
    main()
