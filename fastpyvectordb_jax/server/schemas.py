"""Pydantic request/response schemas for the REST server.

Parity with the reference's schema block (server.py:30-129,
server_full.py), adapted to this engine's richer filter trees (a ``where``
dict or a serialized Filter expression tree, core/filters.py).
"""

from __future__ import annotations

from typing import Literal, Any, Dict, List, Optional

from pydantic import BaseModel, Field


class CreateCollectionRequest(BaseModel):
    name: str
    dimensions: int = Field(gt=0)
    metric: str = "cosine"
    index: str = "flat"
    # serving knobs (CollectionConfig): bfloat16 compute halves device
    # memory streaming AND query-upload bytes; topk="auto" is the
    # platform's choice of selection (kernels/select.py)
    compute_dtype: Literal["float32", "bfloat16"] = "float32"
    storage_dtype: Literal["float32", "bfloat16"] = "float32"
    topk: Literal["exact", "approx", "auto"] = "auto"


class InsertVectorRequest(BaseModel):
    vector: List[float]
    id: Optional[str] = None
    metadata: Optional[Dict[str, Any]] = None


class InsertBatchRequest(BaseModel):
    vectors: List[List[float]]
    ids: Optional[List[str]] = None
    metadatas: Optional[List[Dict[str, Any]]] = None


class InsertTextRequest(BaseModel):
    text: str
    id: Optional[str] = None
    metadata: Optional[Dict[str, Any]] = None


class SearchRequest(BaseModel):
    vector: Optional[List[float]] = None
    text: Optional[str] = None
    k: int = 10
    where: Optional[Dict[str, Any]] = None
    filter_tree: Optional[Dict[str, Any]] = None
    include_vectors: bool = False
    exact: Optional[bool] = None
    # validated: a typo like "exat" must 422, not silently route to the
    # approximate path
    mode: Literal["auto", "exact", "ann", "quantized"] = "auto"


class BuildIndexRequest(BaseModel):
    kind: str = "ivf"            # ivf | ivfpq | graph | int8 | binary | pq
    params: Dict[str, Any] = {}


class SearchBatchRequest(BaseModel):
    vectors: Optional[List[List[float]]] = None
    texts: Optional[List[str]] = None
    k: int = 10
    where: Optional[Dict[str, Any]] = None
    filter_tree: Optional[Dict[str, Any]] = None
    exact: Optional[bool] = None
    # same contract as SearchRequest: a typo must 422, and a client
    # demanding exact results must not silently get the approximate path
    mode: Literal["auto", "exact", "ann", "quantized"] = "auto"


class SearchHit(BaseModel):
    id: str
    score: float
    metadata: Dict[str, Any] = {}
    vector: Optional[List[float]] = None


class SearchResponse(BaseModel):
    results: List[SearchHit]
    took_ms: float


class SearchBatchResponse(BaseModel):
    results: List[List[SearchHit]]
    took_ms: float


class CollectionInfo(BaseModel):
    name: str
    dimensions: int
    metric: str
    count: int
    index: str


# --- graph ---------------------------------------------------------------

class CreateNodeRequest(BaseModel):
    labels: Optional[List[str]] = None
    properties: Optional[Dict[str, Any]] = None
    id: Optional[str] = None


class UpdateNodeRequest(BaseModel):
    properties: Optional[Dict[str, Any]] = None
    add_labels: Optional[List[str]] = None
    remove_labels: Optional[List[str]] = None
    merge: bool = True


class CreateEdgeRequest(BaseModel):
    source: str
    target: str
    type: str
    properties: Optional[Dict[str, Any]] = None
    id: Optional[str] = None


class CreateHyperedgeRequest(BaseModel):
    nodes: List[str]
    type: str
    properties: Optional[Dict[str, Any]] = None
    id: Optional[str] = None


class GraphQueryRequest(BaseModel):
    query: str


class TraverseRequest(BaseModel):
    start: str
    max_depth: int = 3
    edge_type: Optional[str] = None
    direction: str = "out"


class ShortestPathRequest(BaseModel):
    source: str
    target: str
    edge_type: Optional[str] = None


class EmbedRequest(BaseModel):
    text: str


class EmbedBatchRequest(BaseModel):
    texts: List[str]
