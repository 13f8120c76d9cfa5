"""HybridCollection: vector + BM25 keyword search with score fusion.

Parity with the reference's HybridCollection (hybrid_search.py:222-477):
configured ``text_fields`` (or every string metadata field) are indexed into
BM25 on insert and removed on delete; ``keyword_search`` is pure BM25 with
post-filtering; ``hybrid_search`` over-fetches from both systems, min-max
normalizes each score space (vector distance -> similarity ``1 - d/max_d``,
BM25 -> score/max), α-blends, filters, and returns combined results with
per-component scores.

Unlike the reference (which subclasses the *legacy* engine,
hybrid_search.py:33), this subclasses the one core Collection, so hybrid
collections get the fused-mask device search path for the vector stage.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence


from ..core.collection import Collection
from ..core.filters import Filter
from ..core.types import CollectionConfig, as_f32_matrix
from ..persist.format import load_container, save_container
from .bm25 import BM25Config, BM25Index

BM25_FILE = "bm25.fpvt"


@dataclasses.dataclass
class HybridSearchResult:
    id: str
    score: float          # fused score (higher = better)
    vector_score: float   # normalized vector similarity in [0, 1]
    keyword_score: float  # normalized BM25 in [0, 1]
    metadata: dict


def make_bm25(bm25_config: Optional[BM25Config] = None, impl: str = "auto"):
    """BM25 backend factory: the C++ engine (native/bm25.cpp) when a
    toolchain is available, else the pure-Python index."""
    if impl in ("auto", "native"):
        from .. import native
        if native.available():
            cfg = bm25_config or BM25Config()
            return native.NativeBM25(cfg.k1, cfg.b)
        if impl == "native":
            raise RuntimeError("native BM25 requested but unavailable")
    return BM25Index(bm25_config)


def bm25_from_dict(d: dict, impl: str = "auto"):
    if d.get("native"):
        from .. import native
        if impl != "python" and native.available():
            return native.NativeBM25.from_dict(d)
        if "postings" in d:  # postings-style native dict: load directly
            return BM25Index.from_dict(d)
        # legacy texts-style dict without a toolchain: replay the
        # retained texts into the Python index
        cfg = d.get("config", {})
        idx = BM25Index(BM25Config(**{k: v for k, v in cfg.items()
                                      if k in ("k1", "b")}))
        for doc_id, text in d.get("texts", {}).items():
            idx.add_document(doc_id, text)
        return idx
    return BM25Index.from_dict(d)


class HybridCollection(Collection):
    def __init__(self, config: CollectionConfig,
                 base_path: Optional[Path] = None,
                 text_fields: Optional[Sequence[str]] = None,
                 bm25_config: Optional[BM25Config] = None,
                 bm25_impl: str = "auto"):
        self.text_fields = list(text_fields) if text_fields else None
        self._bm25_impl = bm25_impl
        self._bm25 = make_bm25(bm25_config, bm25_impl)
        super().__init__(config, base_path)

    def _after_snapshot_load(self) -> None:
        # Runs between the snapshot load and WAL replay (Collection.
        # __init__): the BM25 snapshot must land FIRST so replayed
        # mutations layer on top of it — loading it after replay would
        # discard the keyword index of every document recovered from the
        # WAL while vector search still finds them.
        if self.base_path is not None and \
                (self.base_path / BM25_FILE).exists():
            self._load_bm25()

    # ------------------------------------------------------------------
    def _indexable_text(self, metadata: Optional[dict]) -> str:
        if not metadata:
            return ""
        if self.text_fields is not None:
            parts = [str(metadata[f]) for f in self.text_fields
                     if f in metadata]
        else:
            parts = [v for k, v in metadata.items() if isinstance(v, str)]
        return " ".join(parts)

    def insert_batch(self, vectors, ids=None, metadatas=None) -> List[str]:
        # the BM25 update rides under the SAME lock as the vector insert:
        # the core Collection serializes all CRUD, and callers (the
        # server's executor threads) rely on that — unlocked BM25 dict
        # mutations race (lost _total_len updates, dict-changed-size
        # during a concurrent remove's iteration)
        with self._lock:
            out_ids = super().insert_batch(vectors, ids, metadatas)
            metas = (metadatas if metadatas is not None
                     else [None] * len(out_ids))
            for rid, meta in zip(out_ids, metas):
                text = self._indexable_text(meta)
                if text:
                    self._bm25.add_document(rid, text)
        return out_ids

    def delete_batch(self, ids: Sequence[str]) -> int:
        with self._lock:
            n = super().delete_batch(ids)
            for rid in ids:
                self._bm25.remove_document(str(rid))
        return n

    def update_metadata(self, id: str, metadata: dict, merge: bool = True
                        ) -> bool:
        with self._lock:
            return self._update_metadata_locked(id, metadata, merge)

    def _update_metadata_locked(self, id: str, metadata: dict,
                                merge: bool) -> bool:
        ok = super().update_metadata(id, metadata, merge)
        if ok:
            row = self._id_to_row[str(id)]
            text = self._indexable_text(self._metadata[row])
            if text:
                self._bm25.add_document(str(id), text)
            else:
                # the update removed every indexable field — leaving the
                # old tokens in place would keep serving stale keyword
                # hits and skew n_docs/avg_doc_len
                self._bm25.remove_document(str(id))
        return ok

    # ------------------------------------------------------------------
    def keyword_search(self, query: str, k: int = 10,
                       filter: Optional[Filter] = None
                       ) -> List[HybridSearchResult]:
        fetch = k * 10 if filter is not None else k
        hits = self._bm25.search(query, fetch)
        out = []
        for rid, score in hits:
            row = self._id_to_row.get(rid)
            if row is None:
                continue
            meta = self._metadata[row] or {}
            if filter is not None and not filter.evaluate(meta):
                continue
            out.append(HybridSearchResult(
                id=rid, score=score, vector_score=0.0, keyword_score=score,
                metadata=dict(meta)))
            if len(out) >= k:
                break
        return out

    def hybrid_search(self, query_vector, query_text: str, k: int = 10,
                      alpha: float = 0.5,
                      vector_weight: Optional[float] = None,
                      keyword_weight: Optional[float] = None,
                      filter: Optional[Filter] = None,
                      fetch_factor: int = 5) -> List[HybridSearchResult]:
        """Fused search.  ``alpha`` is the vector weight; explicit
        vector_weight/keyword_weight override it (normalized), mirroring
        hybrid_search.py:393-395."""
        if vector_weight is not None or keyword_weight is not None:
            vw = vector_weight if vector_weight is not None else 0.5
            kw = keyword_weight if keyword_weight is not None else 0.5
            total = vw + kw
            alpha = vw / total if total > 0 else 0.5
        q = as_f32_matrix(query_vector, self.config.dimensions)

        fetch = max(k * fetch_factor, k)
        # push the filter into the vector stage (fused mask): a selective
        # filter would otherwise eat nearly the whole global top-fetch in
        # the post-filter below and leave the fusion BM25-only
        vec_hits = self.search_batch(q, k=fetch, filter=filter)[0]
        kw_hits = self._bm25.search(query_text, fetch)

        # normalize vector distances -> similarity in [0, 1]
        vec_scores = {}
        if vec_hits:
            from ..core.types import DistanceMetric
            if self.config.metric == DistanceMetric.DOT:
                # dot scores are -<q,v> and usually negative; the
                # 1 - s/max_d form (reference hybrid_search.py:427-434)
                # assumes nonnegative distances — min-max instead
                lo = min(h.score for h in vec_hits)
                hi = max(h.score for h in vec_hits)
                if hi == lo:
                    # single hit / all tied: they are the best matches we
                    # have — similarity 1.0, not 0 (zero would let any
                    # weak keyword match outrank a perfect vector match)
                    for h in vec_hits:
                        vec_scores[h.id] = 1.0
                else:
                    span = hi - lo
                    for h in vec_hits:
                        vec_scores[h.id] = (hi - h.score) / span
            else:
                max_d = max(h.score for h in vec_hits) or 1.0
                if max_d <= 0:
                    max_d = 1.0
                for h in vec_hits:
                    vec_scores[h.id] = 1.0 - h.score / max_d

        kw_scores = {}
        if kw_hits:
            max_s = max(s for _, s in kw_hits) or 1.0
            for rid, s in kw_hits:
                kw_scores[rid] = s / max_s

        out = []
        for rid in set(vec_scores) | set(kw_scores):
            row = self._id_to_row.get(rid)
            if row is None:
                continue
            meta = self._metadata[row] or {}
            if filter is not None and not filter.evaluate(meta):
                continue
            vs = vec_scores.get(rid, 0.0)
            ks = kw_scores.get(rid, 0.0)
            out.append(HybridSearchResult(
                id=rid, score=alpha * vs + (1.0 - alpha) * ks,
                vector_score=vs, keyword_score=ks, metadata=dict(meta)))
        out.sort(key=lambda r: (-r.score, r.id))
        return out[:k]

    # ------------------------------------------------------------------
    def save(self) -> None:
        # BM25 sidecar FIRST: Collection.save() truncates the WAL, and a
        # crash between the truncate and this write would lose the
        # keyword index for every WAL-covered document (replay would have
        # nothing to rebuild it from).  Written before, a crash during
        # super().save() leaves the old snapshot + full WAL: replay
        # re-adds the documents and add_document is idempotent.
        self._save_bm25()
        super().save()

    def _save_bm25(self) -> None:
        import numpy as _np
        from .. import native
        if isinstance(self._bm25, getattr(native, "NativeBM25", ())):
            # binary C-ABI export: reload imports postings directly
            # instead of re-tokenizing the whole corpus (ROADMAP #21)
            sections = {
                "bm25": {"config": {"k1": self._bm25.k1, "b": self._bm25.b},
                         "native": True, "blob": True,
                         "ids": self._bm25.doc_ids},
                "bm25_blob": _np.frombuffer(self._bm25.export_blob(),
                                            dtype=_np.uint8),
                "text_fields": self.text_fields,
            }
        else:
            sections = {"bm25": self._bm25.to_dict(),
                        "text_fields": self.text_fields}
        save_container(self.base_path / BM25_FILE, sections,
                       meta={"kind": "bm25"})

    def _load_bm25(self) -> None:
        from .. import native
        c = load_container(self.base_path / BM25_FILE)
        d = c.read("bm25")
        if d.get("blob"):
            blob = bytes(c.read("bm25_blob"))
            cfg = d.get("config", {})
            k1, b = cfg.get("k1", 1.5), cfg.get("b", 0.75)
            if self._bm25_impl != "python" and native.available():
                self._bm25 = native.NativeBM25.from_blob(
                    blob, d.get("ids", []), k1, b)
            else:
                # no toolchain: decode the blob host-side into the
                # pure-Python index (still no re-tokenize)
                postings, doc_len = native.decode_bm25_blob(blob)
                ids = d.get("ids", [])
                self._bm25 = BM25Index.from_dict({
                    "config": {"k1": k1, "b": b},
                    "postings": {t: {ids[u]: tf for u, tf in p.items()
                                     if u < len(ids) and ids[u] is not None}
                                 for t, p in postings.items()},
                    "doc_len": {ids[u]: dl for u, dl in doc_len.items()
                                if u < len(ids) and ids[u] is not None}})
        else:
            self._bm25 = bm25_from_dict(d, self._bm25_impl)
        tf = c.read("text_fields")
        self.text_fields = list(tf) if tf else None
