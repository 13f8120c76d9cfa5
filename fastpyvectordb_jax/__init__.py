"""fastpyvectordb_jax — a JAX vector index-and-query framework for GPUs.

A from-scratch JAX/XLA re-design of the capabilities of FastPyVectorDB
(reference: jcolano/fastpyvectordb): device-resident exact search with
fused filter masks and top-k, quantized scans (int8 / int4 / binary
Hamming / PQ), IVF ANN, shard_map multi-device distributed search, plus host-side feature layers (embedders,
BM25 hybrid search, property graph, realtime events, REST/WS serving) and a
ChromaDB-style high-level client.
"""

from .core.types import (  # noqa: F401
    CollectionConfig,
    DistanceMetric,
    SearchResult,
)
from .core.filters import Filter, FilterOp  # noqa: F401
from .core.collection import Collection  # noqa: F401
from .core.bigcollection import BigCollection  # noqa: F401
from .core.vectordb import VectorDB  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "CollectionConfig",
    "DistanceMetric",
    "SearchResult",
    "Filter",
    "FilterOp",
    "Collection",
    "BigCollection",
    "VectorDB",
    "__version__",
]


def __getattr__(name):
    # Lazy imports for the heavier feature layers so `import fastpyvectordb_jax`
    # stays cheap and optional deps (aiohttp, sentence-transformers) aren't
    # touched until used.
    if name in ("Client", "QueryResult", "GetResult"):
        from . import api
        return getattr(api, name)
    if name in ("get_embedder", "MockEmbedder", "Embedder"):
        from . import embeddings
        return getattr(embeddings, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
