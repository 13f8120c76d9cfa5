"""Tracing / profiling utilities.

The reference's observability is per-request ``took_ms`` plus benchmark
percentile reports (SURVEY.md §5: server.py:366-389, benchmark.py:174-225).
Here the same surface plus real device tracing:

  * ``QueryTimer`` — reservoir-sampled latency recorder with p50/p95/p99
    and JSON export/compare-friendly output (the benchmark CLI reuses it).
  * ``trace`` — context manager around ``jax.profiler`` writing a
    TensorBoard-loadable device trace for kernel-level inspection.
  * ``annotate`` — named trace region for host-side phases.
"""

from __future__ import annotations

import contextlib
import json
import random
import time
from pathlib import Path
from typing import Iterator

import numpy as np


class QueryTimer:
    """Thread-compatible latency recorder with reservoir sampling."""

    def __init__(self, capacity: int = 10_000, seed: int = 0):
        self.capacity = capacity
        self.samples: list = []
        self.count = 0
        self.total = 0.0
        self._rng = random.Random(seed)

    @contextlib.contextmanager
    def measure(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(time.perf_counter() - t0)

    def add(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        if len(self.samples) < self.capacity:
            self.samples.append(seconds)
        else:
            j = self._rng.randrange(self.count)
            if j < self.capacity:
                self.samples[j] = seconds

    def summary(self) -> dict:
        if not self.samples:
            return {"count": 0}
        arr = np.asarray(self.samples)
        return {
            "count": self.count,
            # exact running mean — the reservoir is for percentiles only
            "mean_ms": float(self.total / self.count * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p95_ms": float(np.percentile(arr, 95) * 1e3),
            "p99_ms": float(np.percentile(arr, 99) * 1e3),
            "qps": self.count / self.total if self.total else 0.0,
        }

    def export(self, path) -> None:
        Path(path).write_text(json.dumps(self.summary(), indent=2))

    def reset(self) -> None:
        self.samples.clear()
        self.count = 0
        self.total = 0.0


@contextlib.contextmanager
def trace(log_dir: str = "fvdb_trace",
          host_tracer_level: int = 2) -> Iterator[str]:
    """Capture a device trace viewable in TensorBoard / Perfetto."""
    import jax
    opts = jax.profiler.ProfileOptions()
    opts.host_tracer_level = host_tracer_level
    jax.profiler.start_trace(log_dir, profiler_options=opts)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside an active trace (host + device timeline)."""
    import jax
    with jax.profiler.TraceAnnotation(name):
        yield
