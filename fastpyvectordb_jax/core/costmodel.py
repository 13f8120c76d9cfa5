"""Per-query work of each serving mode, computed from its shapes.

``Collection.optimize()`` ranks serving modes by their measured
wall-clock time.  This module only says what each mode must read from
device memory and compute for one query, so that a measured time can be
read against the device's rooflines (``benchmarks/peaks.py``) and so that
bytes alone are never mistaken for cost: IVF-PQ's grouped ADC streams the
fewest bytes of all modes but its one-hot expansion does ``rows * M * K``
multiply-adds.

    bytes = stream_bytes + gather_rows * row_bytes
    flops = 2 * multiply-adds
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ModeCost:
    """Per-query work of one serving mode (batch-amortized)."""
    stream_bytes: float     # bytes streamed per query, amortized over B
    flops: float            # 2 * multiply-adds per query
    gather_rows: float = 0.0
    row_bytes: float = 0.0

    @property
    def bytes(self) -> float:
        return self.stream_bytes + self.gather_rows * self.row_bytes


def exact_cost(n: int, d: int, store_bytes: int, batch: int) -> ModeCost:
    """Fused GEMM scan: corpus streamed once per batch, n*d MACs/query."""
    return ModeCost(stream_bytes=n * d * store_bytes / batch,
                    flops=2.0 * n * d)


def quantized_cost(n: int, d: int, kind: str, code_bytes: float,
                   store_bytes: int, rerank_rows: int,
                   batch: int, pq_k: int = 16) -> ModeCost:
    """Two-stage compressed scan + exact re-rank of ``rerank_rows``.

    int8/int4/binary coarse stages do n*d MACs per query; flat PQ-ADC
    does M*K MACs per row via the one-hot expand (``code_bytes`` is then
    M and ``pq_k`` is K)."""
    if kind == "pq":
        flops = 2.0 * n * code_bytes * pq_k
    else:
        flops = 2.0 * n * d
    return ModeCost(stream_bytes=n * code_bytes / batch,
                    flops=flops + 2.0 * rerank_rows * d,
                    gather_rows=float(rerank_rows),
                    row_bytes=d * store_bytes)


def ivf_cost(n: int, d: int, cell_bytes: float, nlist: int, nprobe: int,
             overflow: int, store_bytes: int, rerank_rows: int,
             batch: int, slack: float = 1.25,
             pq_k: int = 0) -> ModeCost:
    """Grouped (cell-major) IVF / IVF-PQ: the probed fraction of cells
    streams once per batch; IVF-PQ's ADC one-hot does M*K MACs per
    scored row (``pq_k`` > 0 switches the flops term; ``cell_bytes``
    is then M).  Routing adds a B x nlist matmul.  At large batch most
    cells are touched by some query, so the stream term uses
    min(nprobe/nlist * batch, 1) coverage."""
    frac = min(1.0, nprobe / max(nlist, 1))
    rows = frac * n * slack + overflow
    coverage = min(1.0, frac * batch)     # distinct-cell fraction per batch
    stream = (coverage * n * slack + overflow) * cell_bytes / batch
    if pq_k > 0:
        flops = 2.0 * rows * cell_bytes * pq_k
    else:
        flops = 2.0 * rows * d
    return ModeCost(stream_bytes=stream,
                    flops=flops + 2.0 * nlist * d + 2.0 * rerank_rows * d,
                    gather_rows=float(rerank_rows),
                    row_bytes=d * store_bytes)


def graph_cost(d: int, store_bytes: int, beam: int, iters: int,
               expand: int, degree: int) -> ModeCost:
    """Serial beam search: ``iters`` data-dependent rounds, each gathering
    ``beam*expand`` neighbor lists then ``beam*expand*degree`` candidate
    rows."""
    rows = float(iters) * beam * expand * degree
    return ModeCost(stream_bytes=0.0, flops=2.0 * rows * d,
                    gather_rows=rows, row_bytes=d * store_bytes)
