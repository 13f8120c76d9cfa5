"""HybridGraphVectorDB: property graph joined with device vector search.

Parity with the reference (hybrid_graph_vector.py:127-616): nodes and edges
carry embeddings searchable by similarity; the flagship
``semantic_graph_search`` finds vector seeds on the device, expands them
through the graph hop-by-hop with decayed scoring, applies label/property
filters, and ranks by the combined score.

Architectural differences from the reference:
  * no UnifiedIDRegistry (hybrid_graph_vector.py:44-105) — the core
    Collection natively keys vectors by string id, so graph ids are used
    directly; edge embeddings live in a second Collection;
  * node labels/properties are mirrored into vector-store metadata
    (labels as a space-delimited ``_labels`` token string), so filtered
    vector search uses the fused device mask instead of over-fetch k*10 +
    post-filter (hybrid_graph_vector.py:267-331).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.collection import Collection
from ..core.filters import Filter
from ..core.types import CollectionConfig, DistanceMetric
from .graph import GraphDB
from .model import Edge, Node


@dataclasses.dataclass
class ScoredNode:
    node: Node
    score: float
    vector_score: float = 0.0
    graph_score: float = 0.0
    hops: int = 0
    seed_id: Optional[str] = None


def _labels_token(labels) -> str:
    return " " + " ".join(sorted(labels)) + " " if labels else " "


class HybridGraphVectorDB:
    def __init__(self, path: Optional[str] = None, dimensions: int = 768,
                 metric: "DistanceMetric | str" = "cosine"):
        self.path = Path(path) if path else None
        self.dimensions = dimensions
        self.metric = DistanceMetric.parse(metric)
        gp = str(self.path / "graph") if self.path else None
        self.graph = GraphDB(gp)
        self.node_vectors = Collection(
            CollectionConfig(name="nodes", dimensions=dimensions,
                             metric=self.metric),
            base_path=(self.path / "node_vectors") if self.path else None)
        self.edge_vectors = Collection(
            CollectionConfig(name="edges", dimensions=dimensions,
                             metric=self.metric),
            base_path=(self.path / "edge_vectors") if self.path else None)

    # ------------------------------------------------------------------
    def add_node_with_embedding(self, labels=None, properties=None,
                                embedding=None, id: Optional[str] = None
                                ) -> Node:
        node = self.graph.create_node(labels, properties, id)
        if embedding is not None:
            meta = dict(node.properties)
            meta["_labels"] = _labels_token(node.labels)
            self.node_vectors.insert(np.asarray(embedding, dtype=np.float32),
                                     node.id, meta)
        return node

    def add_edge_with_embedding(self, source: str, target: str, type: str,
                                embedding=None, properties=None,
                                id: Optional[str] = None) -> Edge:
        edge = self.graph.create_edge(source, target, type, properties, id)
        if embedding is not None:
            meta = dict(edge.properties)
            meta["_type"] = type
            meta["_source"] = source
            meta["_target"] = target
            self.edge_vectors.insert(np.asarray(embedding, dtype=np.float32),
                                     edge.id, meta)
        return edge

    def update_node(self, node_id: str, properties=None, add_labels=None,
                    remove_labels=None, merge: bool = True):
        """Update the graph node AND re-mirror its labels/properties into
        the vector-store metadata — graph.update_node alone leaves the
        mirror stale, so filtered vector_search would keep matching the
        old labels/properties."""
        node = self.graph.update_node(node_id, properties=properties,
                                      add_labels=add_labels,
                                      remove_labels=remove_labels,
                                      merge=merge)
        self.refresh_node_metadata(node_id)
        return node

    def refresh_node_metadata(self, node_id: str) -> bool:
        """Re-mirror a node's current labels/properties into the vector
        store (no re-embedding).  Returns False when the node has no
        embedding."""
        node = self.graph.get_node(node_id)
        if node is None or self.node_vectors.get(node_id) is None:
            return False
        meta = dict(node.properties)
        meta["_labels"] = _labels_token(node.labels)
        self.node_vectors.update_metadata(node_id, meta, merge=False)
        return True

    def set_node_embedding(self, node_id: str, embedding) -> None:
        if self.graph.get_node(node_id) is None:
            raise ValueError(f"node {node_id!r} does not exist")
        node = self.graph.get_node(node_id)
        meta = dict(node.properties)
        meta["_labels"] = _labels_token(node.labels)
        self.node_vectors.upsert(np.asarray(embedding, dtype=np.float32),
                                 node_id, meta)

    def delete_node(self, node_id: str) -> bool:
        for eid in list(self.graph._adjacency.all_edges(node_id)):
            self.edge_vectors.delete(eid)
        self.node_vectors.delete(node_id)
        return self.graph.delete_node(node_id)

    # ------------------------------------------------------------------
    def _filters(self, labels: Optional[Sequence[str]],
                 properties: Optional[dict]) -> Optional[Filter]:
        parts: List[Filter] = []
        for lab in labels or ():
            parts.append(Filter.contains("_labels", f" {lab} "))
        for k, v in (properties or {}).items():
            parts.append(Filter.eq(k, v))
        if not parts:
            return None
        return parts[0] if len(parts) == 1 else Filter.and_(parts)

    def _to_similarity(self, score: float) -> float:
        """distance -> similarity; cosine: 1 - d (hybrid_graph_vector.py:317),
        others: 1/(1+d) monotone mapping."""
        if self.metric == DistanceMetric.COSINE:
            return 1.0 - score
        if self.metric == DistanceMetric.DOT:
            # dot scores are -<q,v> (negative when similar); the old
            # max(score, 0) clamp mapped every good hit to exactly 1.0.
            # Sigmoid keeps the ordering and discriminates.
            import math
            return 1.0 / (1.0 + math.exp(min(max(score, -30.0), 30.0)))
        return 1.0 / (1.0 + max(score, 0.0))

    def vector_search(self, query, k: int = 10,
                      labels: Optional[Sequence[str]] = None,
                      properties: Optional[dict] = None
                      ) -> List[ScoredNode]:
        filt = self._filters(labels, properties)
        hits = self.node_vectors.search(
            np.asarray(query, dtype=np.float32), k, filter=filt)
        out = []
        for h in hits:
            node = self.graph.get_node(h.id)
            if node is None:
                continue
            sim = self._to_similarity(h.score)
            out.append(ScoredNode(node=node, score=sim, vector_score=sim))
        return out

    def edge_vector_search(self, query, k: int = 10,
                           edge_type: Optional[str] = None
                           ) -> List[Tuple[Edge, float]]:
        filt = Filter.eq("_type", edge_type) if edge_type else None
        hits = self.edge_vectors.search(
            np.asarray(query, dtype=np.float32), k, filter=filt)
        out = []
        for h in hits:
            e = self.graph.get_edge(h.id)
            if e is not None:
                out.append((e, self._to_similarity(h.score)))
        return out

    # ------------------------------------------------------------------
    def semantic_graph_search(self, query, k: int = 10,
                              expand_hops: int = 2,
                              vector_weight: float = 0.7,
                              graph_weight: float = 0.3,
                              labels: Optional[Sequence[str]] = None,
                              properties: Optional[dict] = None,
                              edge_type: Optional[str] = None
                              ) -> List[ScoredNode]:
        """Vector seeds + BFS expansion with hop-decayed scoring.

        Expanded node score (reference formula, hybrid_graph_vector.py:
        408-416): ``vector_weight * best_seed_sim / (1 + hop) +
        graph_weight / hop``.  Seeds keep their full vector similarity.
        """
        seeds = self.vector_search(query, max(k * 2, 4))
        best: Dict[str, ScoredNode] = {}
        for s in seeds:
            best[s.node.id] = ScoredNode(
                node=s.node, score=vector_weight * s.vector_score,
                vector_score=s.vector_score, graph_score=0.0, hops=0,
                seed_id=s.node.id)

        frontier = [(s.node.id, s.vector_score, s.node.id) for s in seeds]
        from .graph import NATIVE_TRAVERSAL_THRESHOLD
        snap = (self.graph._csr("both", edge_type)
                if (expand_hops > 0 and frontier and
                    len(self.graph._edges) >= NATIVE_TRAVERSAL_THRESHOLD)
                else None)
        if snap is not None:
            # native attributed multi-source BFS (native/graph.cpp): one
            # C traversal replaces O(frontier) Python dict/set work per
            # hop.  Seeds are passed best-similarity-first so equal-hop
            # first-reach attribution prefers the higher-scoring seed
            # (the Python loop takes an exact max over reachers; the
            # difference is bounded by the seed-sim gap at that hop).
            # Seeds always keep their hop-0 vector score here — the
            # Python loop can re-score a weak seed as another seed's
            # hop-1 neighbor when that combined score is higher.
            csr, node_ids, idx = snap
            order = sorted(range(len(seeds)),
                           key=lambda i: -seeds[i].vector_score)
            kept = [seeds[i] for i in order if seeds[i].node.id in idx]
            seed_rows = np.asarray([idx[s.node.id] for s in kept],
                                   dtype=np.int32)
            nodes_r, hops_r, seed_r = csr.bfs_attributed(
                seed_rows, expand_hops)
            for nrow, hop, si in zip(nodes_r.tolist(), hops_r.tolist(),
                                     seed_r.tolist()):
                if hop == 0:
                    continue  # seeds already carry their full score
                sd = kept[si]
                v = vector_weight * sd.vector_score / (1.0 + hop)
                gscore = graph_weight / hop
                score = v + gscore
                nb_id = node_ids[nrow]
                cur = best.get(nb_id)
                if cur is None or score > cur.score:
                    best[nb_id] = ScoredNode(
                        node=self.graph.get_node(nb_id), score=score,
                        vector_score=v, graph_score=gscore, hops=hop,
                        seed_id=sd.node.id)
        else:
            for hop in range(1, expand_hops + 1):
                nxt = []
                for node_id, seed_sim, seed_id in frontier:
                    for nb in self.graph.neighbors(node_id, "both",
                                                   edge_type):
                        v = vector_weight * seed_sim / (1.0 + hop)
                        gscore = graph_weight / hop
                        score = v + gscore
                        cur = best.get(nb.id)
                        if cur is None or score > cur.score:
                            best[nb.id] = ScoredNode(
                                node=nb, score=score, vector_score=v,
                                graph_score=gscore, hops=hop,
                                seed_id=seed_id)
                            nxt.append((nb.id, seed_sim, seed_id))
                frontier = nxt

        out = list(best.values())
        if labels:
            labs = set(labels)
            out = [r for r in out if labs & r.node.labels]
        if properties:
            out = [r for r in out
                   if all(r.node.properties.get(pk) == pv
                          for pk, pv in properties.items())]
        out.sort(key=lambda r: (-r.score, r.node.id))
        return out[:k]

    def graph_search_with_reranking(self, start_id: str, query,
                                    max_depth: int = 2, k: int = 10
                                    ) -> List[ScoredNode]:
        """Traverse from a known node, rerank reachable nodes by vector
        similarity to the query (hybrid_graph_vector.py:459-511)."""
        paths = self.graph.traverse(start_id, max_depth=max_depth,
                                    direction="both")
        reachable = {p[-1] for p in paths}
        reachable.discard(start_id)
        if not reachable:
            return []
        # get_batch tolerates ids without embeddings (None rows) — no
        # per-id pre-filter lookups needed
        rows = self.node_vectors.get_batch(list(reachable),
                                           include_vectors=True)
        q = np.asarray(query, dtype=np.float32)
        qn = q / max(np.linalg.norm(q), 1e-30)
        out = []
        for r in rows:
            if r is None:
                continue
            v = r["vector"]
            vn = v / max(np.linalg.norm(v), 1e-30)
            sim = float(qn @ vn)
            out.append(ScoredNode(node=self.graph.get_node(r["id"]),
                                  score=sim, vector_score=sim))
        out.sort(key=lambda r: (-r.score, r.node.id))
        return out[:k]

    # ------------------------------------------------------------------
    def save(self) -> None:
        if self.path is None:
            raise ValueError("HybridGraphVectorDB has no path")
        self.graph.save()
        self.node_vectors.save()
        self.edge_vectors.save()

    def stats(self) -> dict:
        return {**self.graph.stats(),
                "node_embeddings": self.node_vectors.count(),
                "edge_embeddings": self.edge_vectors.count()}
