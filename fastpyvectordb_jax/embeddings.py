"""Pluggable text embedders.

Capability parity with the reference's provider layer (embeddings.py:49-514):
an ``Embedder`` ABC, OpenAI / Cohere / sentence-transformers providers, a
deterministic ``MockEmbedder`` test fake, a disk-cached wrapper, and a
``get_embedder`` factory with "auto" resolution.

Device-side addition: ``JaxTransformerEmbedder`` — a small flax-free pure-JAX
transformer encoder with a hashing tokenizer that runs embedding on the device
itself (the reference can only embed via torch or external APIs).  With
deterministic random init it serves as a drop-in featurizer; real weights
can be loaded from an FPVT container.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from abc import ABC, abstractmethod
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np


class Embedder(ABC):
    """Text -> vector provider (reference ABC: embeddings.py:49-88)."""

    @property
    @abstractmethod
    def dimensions(self) -> int: ...

    @property
    @abstractmethod
    def model_name(self) -> str: ...

    @abstractmethod
    def embed(self, text: str) -> np.ndarray: ...

    def embed_batch(self, texts: Sequence[str], batch_size: int = 32
                    ) -> np.ndarray:
        out = [self.embed(t) for t in texts]
        return np.stack(out) if out else np.empty((0, self.dimensions),
                                                  dtype=np.float32)

    def embed_with_metadata(self, text: str) -> dict:
        return {"embedding": self.embed(text), "model": self.model_name,
                "dimensions": self.dimensions}


class MockEmbedder(Embedder):
    """Deterministic hash-seeded embedder — the test fake for the whole
    framework (reference: embeddings.py:343-371)."""

    def __init__(self, dimensions: int = 384):
        self._dims = dimensions

    @property
    def dimensions(self) -> int:
        return self._dims

    @property
    def model_name(self) -> str:
        return f"mock-{self._dims}d"

    def embed(self, text: str) -> np.ndarray:
        seed = int.from_bytes(
            hashlib.sha256(text.encode("utf-8")).digest()[:4], "big")
        v = np.random.RandomState(seed).randn(self._dims).astype(np.float32)
        return v / np.linalg.norm(v)


class HashingEmbedder(Embedder):
    """Dependency-free bag-of-words feature-hashing embedder.

    Useful offline baseline (the reference's retrieval demo ships a similar
    BoW fallback, examples/retrieval_demo.py:1-40): tokens are hashed into
    ``dimensions`` buckets with a signed hash, l2-normalized.  Texts sharing
    vocabulary are actually close — unlike MockEmbedder."""

    def __init__(self, dimensions: int = 384):
        self._dims = dimensions

    @property
    def dimensions(self) -> int:
        return self._dims

    @property
    def model_name(self) -> str:
        return f"hashing-bow-{self._dims}d"

    def embed(self, text: str) -> np.ndarray:
        import re
        v = np.zeros(self._dims, dtype=np.float32)
        for tok in re.findall(r"\b\w+\b", text.lower()):
            h = hashlib.md5(tok.encode("utf-8")).digest()
            idx = int.from_bytes(h[:4], "big") % self._dims
            sign = 1.0 if h[4] & 1 else -1.0
            v[idx] += sign
        n = np.linalg.norm(v)
        return v / n if n > 0 else v


class SentenceTransformerEmbedder(Embedder):
    """Local sentence-transformers models (reference: embeddings.py:200-256).
    Lazy model load; dimensions discovered from the model."""

    def __init__(self, model_name: str = "all-MiniLM-L6-v2",
                 device: Optional[str] = None):
        self._model_name = model_name
        self._device = device
        self._model = None
        self._dims: Optional[int] = None
        self._lock = threading.Lock()

    def _ensure(self):
        if self._model is None:
            with self._lock:
                if self._model is None:
                    from sentence_transformers import SentenceTransformer
                    self._model = SentenceTransformer(self._model_name,
                                                      device=self._device)
                    self._dims = int(
                        self._model.get_sentence_embedding_dimension())
        return self._model

    @property
    def dimensions(self) -> int:
        if self._dims is None:
            self._ensure()
        return self._dims

    @property
    def model_name(self) -> str:
        return self._model_name

    def embed(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: Sequence[str], batch_size: int = 32
                    ) -> np.ndarray:
        model = self._ensure()
        out = model.encode(list(texts), batch_size=batch_size,
                           show_progress_bar=len(texts) > 100,
                           convert_to_numpy=True)
        return np.ascontiguousarray(out, dtype=np.float32)


_OPENAI_DIMS = {
    "text-embedding-3-small": 1536,
    "text-embedding-3-large": 3072,
    "text-embedding-ada-002": 1536,
}


class OpenAIEmbedder(Embedder):
    """OpenAI embeddings API (reference: embeddings.py:95-193).  Supports the
    v3 models' ``dimensions`` reduction parameter."""

    def __init__(self, model_name: str = "text-embedding-3-small",
                 api_key: Optional[str] = None,
                 dimensions: Optional[int] = None):
        self._model_name = model_name
        self._api_key = api_key or os.environ.get("OPENAI_API_KEY")
        default = _OPENAI_DIMS.get(model_name, 1536)
        if dimensions is not None and "3" not in model_name:
            raise ValueError("custom dimensions require a v3 model")
        self._dims = dimensions or default
        self._client = None

    def _ensure(self):
        if self._client is None:
            import openai
            self._client = openai.OpenAI(api_key=self._api_key)
        return self._client

    @property
    def dimensions(self) -> int:
        return self._dims

    @property
    def model_name(self) -> str:
        return self._model_name

    def embed(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: Sequence[str], batch_size: int = 512
                    ) -> np.ndarray:
        client = self._ensure()
        out = np.empty((len(texts), self._dims), dtype=np.float32)
        kwargs = {}
        if self._model_name in ("text-embedding-3-small",
                                "text-embedding-3-large") and \
                self._dims != _OPENAI_DIMS[self._model_name]:
            kwargs["dimensions"] = self._dims
        for s in range(0, len(texts), batch_size):
            chunk = list(texts[s: s + batch_size])
            resp = client.embeddings.create(model=self._model_name,
                                            input=chunk, **kwargs)
            # API may reorder; restore by index
            for item in resp.data:
                out[s + item.index] = np.asarray(item.embedding,
                                                 dtype=np.float32)
        return out


_COHERE_DIMS = {
    "embed-english-v3.0": 1024,
    "embed-multilingual-v3.0": 1024,
    "embed-english-light-v3.0": 384,
}


class CohereEmbedder(Embedder):
    """Cohere embeddings API (reference: embeddings.py:263-336)."""

    def __init__(self, model_name: str = "embed-english-v3.0",
                 api_key: Optional[str] = None,
                 input_type: str = "search_document"):
        self._model_name = model_name
        self._api_key = api_key or os.environ.get("COHERE_API_KEY")
        self._dims = _COHERE_DIMS.get(model_name, 1024)
        self.input_type = input_type
        self._client = None

    def _ensure(self):
        if self._client is None:
            import cohere
            self._client = cohere.Client(self._api_key)
        return self._client

    @property
    def dimensions(self) -> int:
        return self._dims

    @property
    def model_name(self) -> str:
        return self._model_name

    def embed(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: Sequence[str], batch_size: int = 96
                    ) -> np.ndarray:
        client = self._ensure()
        outs: List[np.ndarray] = []
        for s in range(0, len(texts), batch_size):
            resp = client.embed(texts=list(texts[s: s + batch_size]),
                                model=self._model_name,
                                input_type=self.input_type)
            outs.append(np.asarray(resp.embeddings, dtype=np.float32))
        return (np.concatenate(outs) if outs
                else np.empty((0, self._dims), dtype=np.float32))


class JaxTransformerEmbedder(Embedder):
    """Transformer encoder embedder on the device (pure JAX).

    Hashing tokenizer -> embedding table -> ``n_layers`` pre-LN transformer
    blocks -> masked mean pooling -> l2 normalize, all inside one jitted
    function running on the device.  Weights default to deterministic random
    init (a strong random-features text encoder); ``load``/``save`` move
    them through the FPVT container format.
    """

    def __init__(self, dimensions: int = 384, n_layers: int = 2,
                 n_heads: int = 6, vocab_size: int = 32768,
                 max_len: int = 128, seed: int = 0,
                 model_name: str = "jax-mini-encoder"):
        import jax
        import jax.numpy as jnp
        self._jax, self._jnp = jax, jnp
        self._dims = dimensions
        self.n_layers, self.n_heads = n_layers, n_heads
        self.vocab_size, self.max_len = vocab_size, max_len
        self._model_name = model_name
        self.params = self._init_params(seed)
        self._forward = jax.jit(self._apply)

    # -- tokenizer ---------------------------------------------------------
    def tokenize(self, text: str) -> np.ndarray:
        import re
        toks = re.findall(r"\b\w+\b", text.lower())[: self.max_len]
        ids = [int.from_bytes(hashlib.md5(t.encode()).digest()[:4], "big")
               % (self.vocab_size - 1) + 1 for t in toks]
        ids += [0] * (self.max_len - len(ids))  # 0 = pad
        return np.asarray(ids, dtype=np.int32)

    # -- model -------------------------------------------------------------
    def _init_params(self, seed: int) -> dict:
        jax, jnp = self._jax, self._jnp
        d, h = self._dims, self.n_heads
        keys = jax.random.split(jax.random.PRNGKey(seed), 2 + 6 * self.n_layers)
        s = 1.0 / np.sqrt(d)
        p = {
            "tok": jax.random.normal(keys[0], (self.vocab_size, d)) * s,
            "pos": jax.random.normal(keys[1], (self.max_len, d)) * s,
            "layers": [],
        }
        for i in range(self.n_layers):
            k = keys[2 + 6 * i: 8 + 6 * i]
            p["layers"].append({
                "wq": jax.random.normal(k[0], (d, d)) * s,
                "wk": jax.random.normal(k[1], (d, d)) * s,
                "wv": jax.random.normal(k[2], (d, d)) * s,
                "wo": jax.random.normal(k[3], (d, d)) * s,
                "w1": jax.random.normal(k[4], (d, 4 * d)) * s,
                "w2": jax.random.normal(k[5], (4 * d, d)) * (s / 2),
            })
        return p

    def _apply(self, params, ids):
        jnp = self._jnp
        jax = self._jax
        d, h = self._dims, self.n_heads
        hd = d // h
        mask = (ids != 0)
        x = params["tok"][ids] + params["pos"][None, : ids.shape[1]]

        def ln(y):
            mu = y.mean(-1, keepdims=True)
            var = ((y - mu) ** 2).mean(-1, keepdims=True)
            return (y - mu) * jax.lax.rsqrt(var + 1e-6)

        neg = jnp.where(mask[:, None, None, :], 0.0, -1e9)
        for lp in params["layers"]:
            y = ln(x)
            b, t, _ = y.shape
            q = (y @ lp["wq"]).reshape(b, t, h, hd).transpose(0, 2, 1, 3)
            k = (y @ lp["wk"]).reshape(b, t, h, hd).transpose(0, 2, 1, 3)
            v = (y @ lp["wv"]).reshape(b, t, h, hd).transpose(0, 2, 1, 3)
            att = jax.nn.softmax(
                q @ k.transpose(0, 1, 3, 2) / np.sqrt(hd) + neg, axis=-1)
            o = (att @ v).transpose(0, 2, 1, 3).reshape(b, t, d)
            x = x + o @ lp["wo"]
            y = ln(x)
            x = x + jax.nn.gelu(y @ lp["w1"]) @ lp["w2"]
        x = ln(x)
        m = mask[:, :, None].astype(x.dtype)
        pooled = (x * m).sum(1) / jnp.maximum(m.sum(1), 1.0)
        return pooled / jnp.maximum(
            jnp.linalg.norm(pooled, axis=-1, keepdims=True), 1e-9)

    @property
    def dimensions(self) -> int:
        return self._dims

    @property
    def model_name(self) -> str:
        return self._model_name

    def embed(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: Sequence[str], batch_size: int = 64
                    ) -> np.ndarray:
        outs = []
        for s in range(0, len(texts), batch_size):
            chunk = texts[s: s + batch_size]
            ids = np.stack([self.tokenize(t) for t in chunk])
            pad = (-len(chunk)) % 8  # bucket batch for compile reuse
            if pad:
                ids = np.pad(ids, ((0, pad), (0, 0)))
            out = np.asarray(self._forward(self.params, self._jnp.asarray(ids)))
            outs.append(out[: len(chunk)].astype(np.float32))
        return (np.concatenate(outs) if outs
                else np.empty((0, self._dims), dtype=np.float32))

    def save(self, path) -> None:
        from .persist.format import save_container
        sections = {"tok": np.asarray(self.params["tok"]),
                    "pos": np.asarray(self.params["pos"])}
        for i, lp in enumerate(self.params["layers"]):
            for name, w in lp.items():
                sections[f"l{i}.{name}"] = np.asarray(w)
        save_container(Path(path), sections, meta={
            "kind": "jax_embedder", "dims": self._dims,
            "n_layers": self.n_layers, "n_heads": self.n_heads,
            "vocab_size": self.vocab_size, "max_len": self.max_len,
            "model_name": self._model_name})

    @classmethod
    def load(cls, path) -> "JaxTransformerEmbedder":
        from .persist.format import load_container
        import jax.numpy as jnp
        c = load_container(path)
        m = c.meta
        emb = cls(dimensions=m["dims"], n_layers=m["n_layers"],
                  n_heads=m["n_heads"], vocab_size=m["vocab_size"],
                  max_len=m["max_len"], model_name=m["model_name"])
        emb.params["tok"] = jnp.asarray(np.asarray(c.read("tok")))
        emb.params["pos"] = jnp.asarray(np.asarray(c.read("pos")))
        for i in range(m["n_layers"]):
            for name in ("wq", "wk", "wv", "wo", "w1", "w2"):
                emb.params["layers"][i][name] = jnp.asarray(
                    np.asarray(c.read(f"l{i}.{name}")))
        return emb


class CachedEmbedder(Embedder):
    """Disk-cached wrapper keyed by sha256(text) (reference:
    embeddings.py:374-448)."""

    def __init__(self, base: Embedder, cache_dir: str = ".embedding_cache"):
        self.base = base
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self._path = self.cache_dir / f"{base.model_name.replace('/', '_')}.json"
        self._cache: dict = {}
        self._lock = threading.Lock()
        self._dirty = 0          # misses since the last disk flush
        self._flush_every = 2048
        if self._path.exists():
            try:
                self._cache = json.loads(self._path.read_text())
            except (OSError, json.JSONDecodeError):
                self._cache = {}

    @staticmethod
    def _key(text: str) -> str:
        return hashlib.sha256(text.encode("utf-8")).hexdigest()[:32]

    @property
    def dimensions(self) -> int:
        return self.base.dimensions

    @property
    def model_name(self) -> str:
        return self.base.model_name

    def embed(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: Sequence[str], batch_size: int = 32
                    ) -> np.ndarray:
        keys = [self._key(t) for t in texts]
        out = np.empty((len(texts), self.dimensions), dtype=np.float32)
        with self._lock:  # membership must be read under the lock too
            missing_idx = [i for i, k in enumerate(keys)
                           if k not in self._cache]
        if missing_idx:
            fresh = self.base.embed_batch([texts[i] for i in missing_idx],
                                          batch_size)
            with self._lock:
                for j, i in enumerate(missing_idx):
                    self._cache[keys[i]] = fresh[j].tolist()
                # rewriting the whole JSON file per batch is O(cache)
                # disk I/O — quadratic over a large ingest.  Small caches
                # keep write-through (cross-instance visibility, cheap);
                # large ones flush every _flush_every misses and on
                # flush()/clear()/__del__.
                self._dirty += len(missing_idx)
                if (self._dirty >= self._flush_every
                        or len(self._cache) <= 4096):
                    self._flush_locked()
        with self._lock:
            for i, k in enumerate(keys):
                out[i] = np.asarray(self._cache[k], dtype=np.float32)
        return out

    def _flush_locked(self) -> None:
        tmp = self._path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self._cache))
        os.replace(tmp, self._path)
        self._dirty = 0

    def flush(self) -> None:
        """Persist pending cache entries (also called by __del__)."""
        with self._lock:
            if self._dirty:
                self._flush_locked()

    def __del__(self):  # best-effort final flush
        try:
            self.flush()
        except Exception:
            pass

    def clear(self) -> None:
        with self._lock:
            self._cache = {}
            self._dirty = 0
            if self._path.exists():
                self._path.unlink()


def get_embedder(provider: str = "auto", model: Optional[str] = None,
                 cache: bool = False, cache_dir: str = ".embedding_cache",
                 **kwargs) -> Embedder:
    """Factory (reference: embeddings.py:455-514).

    providers: auto | mock | hashing | jax | sentence-transformers |
    openai | cohere.  "auto" picks openai if OPENAI_API_KEY is set, else
    sentence-transformers if importable, else mock.
    """
    provider = provider.lower()
    if provider == "auto":
        if os.environ.get("OPENAI_API_KEY"):
            provider = "openai"
        else:
            try:
                import sentence_transformers  # noqa: F401
                provider = "sentence-transformers"
            except ImportError:
                provider = "mock"
    if provider == "mock":
        emb: Embedder = MockEmbedder(**kwargs)
    elif provider == "hashing":
        emb = HashingEmbedder(**kwargs)
    elif provider == "jax":
        emb = JaxTransformerEmbedder(**({"model_name": model} if model else {}),
                                     **kwargs)
    elif provider in ("sentence-transformers", "sbert", "st"):
        emb = SentenceTransformerEmbedder(model or "all-MiniLM-L6-v2", **kwargs)
    elif provider == "openai":
        emb = OpenAIEmbedder(model or "text-embedding-3-small", **kwargs)
    elif provider == "cohere":
        emb = CohereEmbedder(model or "embed-english-v3.0", **kwargs)
    else:
        raise ValueError(f"unknown embedding provider {provider!r}")
    if cache:
        emb = CachedEmbedder(emb, cache_dir)
    return emb


class EmbeddingCollection:
    """Low-level text wrapper over a core Collection (reference:
    embeddings.py:521-609): stores raw text under the ``_text`` metadata
    key and embeds transparently on add/search.  The high-level api.Client
    is the friendlier interface; this exists for engine-level use."""

    def __init__(self, collection, embedder: Embedder):
        if embedder.dimensions != collection.config.dimensions:
            raise ValueError(
                f"embedder dims {embedder.dimensions} != collection dims "
                f"{collection.config.dimensions}")
        self.collection = collection
        self.embedder = embedder

    def add_text(self, text: str, id: Optional[str] = None,
                 metadata: Optional[dict] = None) -> str:
        meta = dict(metadata or {})
        meta["_text"] = text
        return self.collection.insert(self.embedder.embed(text), id, meta)

    def add_texts(self, texts: Sequence[str],
                  ids: Optional[Sequence[str]] = None,
                  metadatas: Optional[Sequence[dict]] = None) -> List[str]:
        metas = [dict(m) for m in metadatas] if metadatas is not None \
            else [{} for _ in texts]
        for m, t in zip(metas, texts):
            m["_text"] = t
        return self.collection.insert_batch(
            self.embedder.embed_batch(list(texts)), ids, metas)

    def search_text(self, query: str, k: int = 10, filter=None):
        hits = self.collection.search(self.embedder.embed(query), k, filter)
        for h in hits:
            h.metadata.setdefault("_text", None)
        return hits

    def get_text(self, id: str) -> Optional[str]:
        row = self.collection.get(id)
        return row["metadata"].get("_text") if row else None

    def count(self) -> int:
        return self.collection.count()
