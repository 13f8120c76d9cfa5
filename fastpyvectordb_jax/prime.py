"""Compile-cache priming for fresh machines (ROADMAP #11).

XLA compiles the serving kernels once per (shape bucket, dtype, metric)
combination, and a cold compile delays the first query of each.  This
tool walks the serving grid — the power-of-two query-batch buckets the
engine pads to (core/store.py / quant/scan.py) times the configured
corpus sizes — and compiles everything into the persistent cache
(``jax_compilation_cache_dir``), so the first production query is a cache
hit.

Usage (on the serving machine, before traffic):

    python -m fastpyvectordb_jax.prime --dims 768 --rows 1000000 \
        --metric cosine --modes exact,int8

The cache goes where ``JAX_COMPILATION_CACHE_DIR`` says, else to
``.jax_cache`` at the checkout's root (fastpyvectordb_jax/compile_cache.py);
``--cache`` overrides both.

Priming runs REAL tiny-data compiles at full shapes: buffers are
allocated at the true corpus size (shape drives the compile), filled with
~1 row of data.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List


def _bucket_batches(max_batch: int) -> List[int]:
    out, b = [], 8
    while b <= max_batch:
        out.append(b)
        b <<= 1
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="prime the XLA compile cache")
    ap.add_argument("--dims", type=int, default=768)
    ap.add_argument("--rows", type=int, action="append", default=None,
                    help="corpus size(s) to prime (repeatable); buffers "
                    "grow in pow2 buckets, so prime the bucket ceiling")
    ap.add_argument("--metric", default="cosine")
    ap.add_argument("--max-batch", type=int, default=1024)
    ap.add_argument("--k", type=int, action="append", default=None,
                    help="top-k value(s) to prime (k is a static compile "
                    "argument; repeatable, default 10)")
    ap.add_argument("--modes", default="exact,int8,binary",
                    help="comma list: exact | int8 | binary")
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--cache", default=None,
                    help="compile cache directory (default: "
                    "compile_cache.cache_dir())")
    args = ap.parse_args(argv)

    import jax

    from . import compile_cache
    args.cache = compile_cache.enable(args.cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    import numpy as np

    from .core.collection import Collection
    from .core.types import CollectionConfig

    rows_list = args.rows or [1 << 20]
    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    batches = _bucket_batches(args.max_batch)
    rng = np.random.default_rng(0)

    for rows in rows_list:
        cap = 1
        while cap < rows:
            cap <<= 1
        col = Collection(CollectionConfig(
            name="prime", dimensions=args.dims, metric=args.metric,
            compute_dtype=args.compute_dtype, topk="auto"))
        # fill to the real row count with zero rows — compiled programs
        # depend on shapes only, and the quantized-scan code tensors are
        # sized by the live count, so priming must match it
        t0 = time.perf_counter()
        filled = 0
        while filled < rows:
            nchunk = int(min(250_000, rows - filled))
            col.insert_batch(np.zeros((nchunk, args.dims), np.float32),
                             [f"p{filled + i}" for i in range(nchunk)])
            filled += nchunk
        print(json.dumps({"filled_rows": rows,
                          "s": round(time.perf_counter() - t0, 1)}),
              flush=True)
        scans = {}
        if "int8" in modes:
            scans["int8"] = col.enable_quantized_scan("int8")
        if "binary" in modes:
            scans["binary"] = col.enable_quantized_scan("binary")
        ks = args.k or [10]
        for b in batches:
            q = rng.standard_normal((b, args.dims)).astype(np.float32)
            t0 = time.perf_counter()
            for k in ks:
                if "exact" in modes:
                    col._store.search(q, k, col.config.metric,
                                      compute_dtype=args.compute_dtype,
                                      topk=col.config.topk)
                for scan in scans.values():
                    scan.search(q, k)
            print(json.dumps({
                "primed": {"rows_bucket": cap, "batch_bucket": b,
                           "k": ks, "modes": modes},
                "s": round(time.perf_counter() - t0, 1)}), flush=True)
    print(json.dumps({"cache": args.cache, "done": True}))


if __name__ == "__main__":
    main()
