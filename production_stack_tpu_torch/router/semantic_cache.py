"""Semantic cache: serve repeated-meaning chat requests without an engine.

Capability parity with reference src/vllm_router/experimental/semantic_cache/
(semantic_cache.py:1-353 + db_adapters/faiss_adapter.py:30-134 +
semantic_cache_integration.py:25-306): embed the request messages, nearest-
neighbor against cached request embeddings, and short-circuit the router
when similarity clears a threshold; store non-streaming completions after
they finish. Differences by design:

  * the vector index is this repo's native C++ flat-IP index
    (native/vecindex.cpp) with a numpy fallback — not a FAISS wheel;
  * the default embedder is a dependency-free feature-hashing embedder
    (deterministic across replicas), with sentence-transformers as an
    optional drop-in when the wheel exists — the reference hard-requires it;
  * persistence is the index's own binary format + a JSON metadata file,
    not pickles (no code execution on load).

Gated behind the ``SemanticCache`` feature gate (ALPHA, off by default),
like the reference (feature_gates.py).
"""

import ctypes
import itertools
import json
import math
import os
import threading
import time
from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Tuple

import numpy as np

from production_stack_tpu_torch.kvcache import _native
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

DEFAULT_SIMILARITY_THRESHOLD = 0.95
DEFAULT_DIM = 384

# canonical home is proxy.py (keeps this numpy-heavy module out of the
# hot path's imports); re-exported here because the knobs are consumed
# by SemanticCache.cacheable/check
from production_stack_tpu_torch.router.proxy import CACHE_CONTROL_FIELDS  # noqa: E402,F401


# ---------------------------------------------------------------- embedders

class Embedder(ABC):
    dim: int

    @abstractmethod
    def embed(self, text: str) -> np.ndarray:
        """-> L2-normalized float32 [dim]."""


class HashingEmbedder(Embedder):
    """Deterministic feature-hashing embedder (no model download).

    Words and character trigrams are hashed into `dim` buckets with a
    +/- sign (the classic hashing trick), tf-weighted, L2-normalized.
    Inner product then behaves like an n-gram cosine similarity: near-1.0
    for same meaning-ish strings with small edits, low for unrelated text.
    Deterministic across processes/replicas (blake2b, not PYTHONHASHSEED).
    """

    def __init__(self, dim: int = DEFAULT_DIM):
        self.dim = dim

    def _features(self, text: str):
        text = " ".join(text.lower().split())
        for word in text.split(" "):
            yield "w:" + word
        padded = f"  {text} "
        for i in range(len(padded) - 2):
            yield "c:" + padded[i:i + 3]

    def embed(self, text: str) -> np.ndarray:
        import hashlib
        vec = np.zeros(self.dim, np.float32)
        for feat in self._features(text):
            h = int.from_bytes(
                hashlib.blake2b(feat.encode(), digest_size=8).digest(),
                "little")
            idx = (h >> 1) % self.dim
            sign = 1.0 if h & 1 else -1.0
            vec[idx] += sign
        norm = float(np.linalg.norm(vec))
        return vec / norm if norm > 0 else vec


class SentenceTransformerEmbedder(Embedder):
    """Optional wrapper over sentence-transformers (reference default
    all-MiniLM-L6-v2, semantic_cache.py); only usable when the wheel and
    model weights are present."""

    def __init__(self, model_name: str = "all-MiniLM-L6-v2"):
        from sentence_transformers import SentenceTransformer  # lazy
        self._model = SentenceTransformer(model_name)
        self.dim = self._model.get_sentence_embedding_dimension()

    def embed(self, text: str) -> np.ndarray:
        vec = np.asarray(self._model.encode([text])[0], np.float32)
        norm = float(np.linalg.norm(vec))
        return vec / norm if norm > 0 else vec


class EngineEmbedder(Embedder):
    """Embed via a serving engine's /v1/embeddings endpoint — the REAL
    model path (models/encoder.py behind engine/server.py), so the
    router process stays model-free and the encoder runs where the
    accelerator is. Mirrors the reference's real-model embedder
    (semantic_cache.py sentence-transformers) without pulling torch
    into the router.

    Spec form: ``engine:http://host:port`` or
    ``engine:http://host:port#model-name``. Synchronous HTTP with a
    bounded timeout — check()/store() already run on executor threads,
    never on the event loop. The embedding dim is discovered by a probe
    at construction, retried over ~15s to ride out the router-before-
    engine startup race; if the endpoint never answers, construction
    RAISES and the router fails fast (k8s restarts it until the engine
    is up) — silently downgrading an explicitly configured real-model
    embedder to hashing geometry would flip hit/miss behavior with one
    log line as the only trace. Runtime failures are bounded by the
    cache's breaker (SemanticCache._embed_guarded)."""

    def __init__(self, url: str, model: Optional[str] = None,
                 timeout_s: float = 3.0, probe_retries: int = 5,
                 probe_delay_s: float = 3.0):
        self.url = url.rstrip("/") + "/v1/embeddings"
        self.model = model
        self.timeout_s = timeout_s
        last_err = None
        for attempt in range(probe_retries):
            try:
                self.dim = len(self._fetch("dimension probe"))
                return
            except Exception as e:      # noqa: BLE001 — urllib raises
                last_err = e            # URLError/OSError/HTTPError/...
                if attempt + 1 < probe_retries:
                    logger.info(
                        "engine embedder probe %d/%d failed (%s); "
                        "retrying in %.0fs", attempt + 1, probe_retries,
                        e, probe_delay_s)
                    time.sleep(probe_delay_s)
        raise RuntimeError(
            f"engine embedder endpoint {self.url} unreachable after "
            f"{probe_retries} probes: {last_err}")

    def _fetch(self, text: str) -> np.ndarray:
        import urllib.request
        payload = {"input": [text]}
        if self.model:
            payload["model"] = self.model
        req = urllib.request.Request(
            self.url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            data = json.loads(resp.read())
        return np.asarray(data["data"][0]["embedding"], np.float32)

    def embed(self, text: str) -> np.ndarray:
        vec = self._fetch(text)
        norm = float(np.linalg.norm(vec))
        return vec / norm if norm > 0 else vec


def make_embedder(spec: str = "hashing", dim: int = DEFAULT_DIM) -> Embedder:
    if spec == "hashing":
        return HashingEmbedder(dim)
    if spec.startswith("engine:"):
        # no hashing fallback here, deliberately: the operator asked for
        # real-model embeddings; a dead endpoint fails router startup
        # (EngineEmbedder docstring) rather than silently serving a
        # different similarity geometry
        rest = spec[len("engine:"):]
        url, _, model = rest.partition("#")
        return EngineEmbedder(url, model or None)
    if spec.startswith("sentence-transformers/") or spec == "minilm":
        name = spec.split("/", 1)[1] if "/" in spec else "all-MiniLM-L6-v2"
        try:
            return SentenceTransformerEmbedder(name)
        except Exception as e:
            logger.warning("sentence-transformers unavailable (%s); "
                           "falling back to hashing embedder", e)
            return HashingEmbedder(dim)
    raise ValueError(f"unknown embedder {spec!r}")


# ---------------------------------------------------------------- index

class VectorIndex(ABC):
    """FlatIP semantics: add/replace by id, top-k search, swap-remove."""

    @abstractmethod
    def add(self, vec: np.ndarray, vid: int) -> None: ...

    @abstractmethod
    def remove(self, vid: int) -> bool: ...

    @abstractmethod
    def search(self, vec: np.ndarray, k: int) -> \
        Tuple[List[float], List[int]]: ...

    @abstractmethod
    def __len__(self) -> int: ...

    @abstractmethod
    def save(self, path: str) -> None: ...


class NativeVectorIndex(VectorIndex):
    """ctypes binding of native/vecindex.cpp (psvi_*)."""

    def __init__(self, dim: int, _handle=None):
        self._lib = _native.load()
        if self._lib is None:
            raise RuntimeError("libpskv.so unavailable")
        self.dim = dim
        self._h = _handle if _handle is not None else \
            self._lib.psvi_new(dim)

    @classmethod
    def load(cls, path: str) -> Optional["NativeVectorIndex"]:
        lib = _native.load()
        if lib is None:
            return None
        h = lib.psvi_load(path.encode())
        if not h:
            return None
        return cls(lib.psvi_dim(h), _handle=h)

    def _as_fp(self, vec: np.ndarray):
        vec = np.ascontiguousarray(vec, np.float32)
        return vec, vec.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def add(self, vec: np.ndarray, vid: int) -> None:
        keepalive, ptr = self._as_fp(vec)
        self._lib.psvi_add(self._h, ptr, vid)

    def remove(self, vid: int) -> bool:
        return bool(self._lib.psvi_remove(self._h, vid))

    def search(self, vec: np.ndarray, k: int):
        keepalive, ptr = self._as_fp(vec)
        scores = np.empty(k, np.float32)
        ids = np.empty(k, np.int64)
        n = self._lib.psvi_search(
            self._h, ptr, k,
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return scores[:n].tolist(), ids[:n].tolist()

    def __len__(self) -> int:
        return int(self._lib.psvi_size(self._h))

    def save(self, path: str) -> None:
        if self._lib.psvi_save(self._h, path.encode()) != 0:
            raise OSError(f"failed to save vector index to {path}")

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.psvi_free(h)
            self._h = None


class NumpyVectorIndex(VectorIndex):
    """Pure-numpy fallback with identical semantics + file format."""

    _MAGIC, _VERSION = 0x50535649, 1

    def __init__(self, dim: int):
        self.dim = dim
        # contiguous row matrix grown by doubling: search is a single
        # matvec, no per-query stack/copy (mirrors the native buffer)
        self._data = np.empty((16, dim), np.float32)
        self._n = 0
        self._ids: List[int] = []
        self._pos: Dict[int, int] = {}
        self._lock = threading.Lock()

    @classmethod
    def load(cls, path: str) -> Optional["NumpyVectorIndex"]:
        try:
            with open(path, "rb") as f:
                raw = f.read(12)
                if len(raw) < 12:  # truncated header
                    return None
                hdr = np.frombuffer(raw, np.uint32)
                if hdr[0] != cls._MAGIC or hdr[1] != cls._VERSION:
                    return None
                dim = int(hdr[2])
                (n,) = np.frombuffer(f.read(8), np.uint64)
                n = int(n)
                ids = np.frombuffer(f.read(8 * n), np.int64)
                data = np.frombuffer(f.read(4 * n * dim),
                                     np.float32).reshape(n, dim)
            ix = cls(dim)
            for i in range(n):
                ix.add(data[i], int(ids[i]))
            return ix
        except (OSError, ValueError, MemoryError, OverflowError):
            # ValueError: truncated payload; MemoryError/OverflowError:
            # absurd on-disk count from a corrupt header
            return None

    def add(self, vec: np.ndarray, vid: int) -> None:
        vec = np.ascontiguousarray(vec, np.float32)
        with self._lock:
            row = self._pos.get(vid)
            if row is not None:
                self._data[row] = vec
                return
            if self._n == len(self._data):
                grown = np.empty((2 * len(self._data), self.dim),
                                 np.float32)
                grown[:self._n] = self._data[:self._n]
                self._data = grown
            self._data[self._n] = vec
            self._pos[vid] = self._n
            self._ids.append(vid)
            self._n += 1

    def remove(self, vid: int) -> bool:
        with self._lock:
            row = self._pos.pop(vid, None)
            if row is None:
                return False
            last = self._n - 1
            if row != last:
                self._data[row] = self._data[last]
                self._ids[row] = self._ids[last]
                self._pos[self._ids[row]] = row
            self._ids.pop()
            self._n = last
            return True

    def search(self, vec: np.ndarray, k: int):
        with self._lock:
            if not self._n:
                return [], []
            scores = self._data[:self._n] @ np.asarray(vec, np.float32)
            order = np.argsort(-scores)[:k]
            return scores[order].tolist(), [self._ids[i] for i in order]

    def __len__(self) -> int:
        with self._lock:
            return self._n

    def save(self, path: str) -> None:
        with self._lock:
            n = self._n
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(np.asarray([self._MAGIC, self._VERSION, self.dim],
                                   np.uint32).tobytes())
                f.write(np.asarray([n], np.uint64).tobytes())
                f.write(np.asarray(self._ids, np.int64).tobytes())
                if n:
                    f.write(self._data[:n].tobytes())
            os.replace(tmp, path)


def make_index(dim: int) -> VectorIndex:
    if _native.load() is not None:
        return NativeVectorIndex(dim)
    return NumpyVectorIndex(dim)


def load_index(path: str) -> Optional[VectorIndex]:
    ix = NativeVectorIndex.load(path) if _native.load() is not None else None
    return ix if ix is not None else NumpyVectorIndex.load(path)


# ---------------------------------------------------------------- cache

class SemanticCache:
    """check() before routing, store() after completion (non-streaming).

    Request text = concatenated chat messages (role + content), matching
    the reference's extraction (semantic_cache.py). Per-request knobs in
    the body mirror the reference integration: ``skip_cache: true``
    bypasses, ``cache_similarity_threshold`` overrides the default.
    """

    INDEX_FILE = "semantic_index.bin"
    META_FILE = "semantic_meta.json"

    # embedder circuit breaker: after this many CONSECUTIVE embed
    # failures the cache disables itself for the cooldown (requests
    # route straight to engines — a sick embedding endpoint must never
    # queue the whole router behind its timeout), then lets one request
    # probe again (half-open)
    EMBED_BREAKER_THRESHOLD = 3
    EMBED_BREAKER_COOLDOWN_S = 30.0

    def __init__(self, embedder: Optional[Embedder] = None,
                 threshold: float = DEFAULT_SIMILARITY_THRESHOLD,
                 max_entries: int = 4096,
                 persist_dir: Optional[str] = None):
        self.embedder = embedder or HashingEmbedder()
        self.threshold = threshold
        self.max_entries = max_entries
        self.persist_dir = persist_dir
        self.hits = 0
        self.misses = 0
        self.last_lookup_s = 0.0
        self._embed_failures = 0
        self._embed_retry_at = 0.0
        self._lock = threading.Lock()
        self._meta: Dict[int, dict] = {}
        self._order: List[int] = []          # insertion order for eviction
        self._ids = itertools.count()
        self.index: VectorIndex = make_index(self.embedder.dim)
        if persist_dir:
            self._load_persisted()

    # -- request plumbing ------------------------------------------------

    @staticmethod
    def request_text(body: dict) -> Optional[str]:
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            return None
        parts = []
        for m in messages:
            if not isinstance(m, dict):
                return None
            content = m.get("content", "")
            if isinstance(content, list):  # multimodal: text parts only
                content = " ".join(p.get("text", "") for p in content
                                   if isinstance(p, dict))
            parts.append(f"{m.get('role', '')}: {content}")
        return "\n".join(parts)

    @staticmethod
    def cacheable(body: dict) -> bool:
        """Only plain single-choice text completions are cacheable: a
        cached answer can't honor tools / response_format / n>1 /
        logprobs, so requests carrying them must always reach an engine."""
        return not (body.get("stream") or body.get("skip_cache")
                    or body.get("tools") or body.get("tool_choice")
                    or body.get("response_format") or body.get("logprobs")
                    or body.get("n", 1) != 1)

    # -- core ------------------------------------------------------------

    def _embed_guarded(self, text: str) -> Optional[np.ndarray]:
        """embed() behind the consecutive-failure breaker: None = the
        cache is sitting out this request (open circuit or a fresh
        failure); the caller treats it as 'no cache', never an error —
        an embedding outage must cost one log line, not requests."""
        now = time.monotonic()
        with self._lock:
            if (self._embed_failures >= self.EMBED_BREAKER_THRESHOLD
                    and now < self._embed_retry_at):
                return None
        try:
            vec = self.embedder.embed(text)
        except Exception as e:   # noqa: BLE001 — any transport failure
            with self._lock:
                self._embed_failures += 1
                self._embed_retry_at = (time.monotonic()
                                        + self.EMBED_BREAKER_COOLDOWN_S)
                tripped = (self._embed_failures
                           == self.EMBED_BREAKER_THRESHOLD)
            (logger.warning if tripped else logger.info)(
                "semantic-cache embed failed (%s)%s", e,
                f"; breaker OPEN for {self.EMBED_BREAKER_COOLDOWN_S:.0f}s"
                if tripped else "")
            return None
        with self._lock:
            self._embed_failures = 0
        return vec

    def check(self, body: dict) -> Optional[dict]:
        """Cached response for a semantically-equivalent request, or None."""
        if not self.cacheable(body):
            return None
        text = self.request_text(body)
        if text is None:
            return None
        threshold = float(body.get("cache_similarity_threshold",
                                   self.threshold))
        t0 = time.monotonic()
        vec = self._embed_guarded(text)
        if vec is None:
            return None
        # k > 1: in multi-model deployments the global nearest neighbor may
        # belong to another model; take the best same-model hit instead
        scores, ids = self.index.search(vec, 8)
        # check() runs on executor threads: counter read-modify-writes
        # must hold the lock or concurrent lookups lose increments
        with self._lock:
            self.last_lookup_s = time.monotonic() - t0
        for score, vid in zip(scores, ids):
            if score < threshold:
                break
            with self._lock:
                meta = self._meta.get(vid)
            if meta is not None and meta.get("model") == body.get("model"):
                with self._lock:
                    self.hits += 1
                response = dict(meta["response"])
                response["cached"] = True
                return response
        with self._lock:
            self.misses += 1
        return None

    def store(self, body: dict, response: dict) -> bool:
        if not self.cacheable(body):
            return False
        text = self.request_text(body)
        if text is None:
            return False
        vec = self._embed_guarded(text)
        if vec is None:
            return False
        with self._lock:
            vid = next(self._ids)
        # the vector must be in the index BEFORE vid is registered in
        # _order: a concurrent store() may evict vid the moment it is
        # registered, and index.remove of a not-yet-added vid would no-op,
        # orphaning the vector forever
        self.index.add(vec, vid)
        with self._lock:
            self._meta[vid] = {"model": body.get("model"),
                               "response": response}
            self._order.append(vid)
            evict = []
            while len(self._order) > self.max_entries:
                old = self._order.pop(0)
                self._meta.pop(old, None)
                evict.append(old)
        for old in evict:
            self.index.remove(old)
        return True

    # -- persistence -----------------------------------------------------

    def persist(self) -> None:
        if not self.persist_dir:
            return
        os.makedirs(self.persist_dir, exist_ok=True)
        self.index.save(os.path.join(self.persist_dir, self.INDEX_FILE))
        tmp = os.path.join(self.persist_dir, self.META_FILE + ".tmp")
        with self._lock:
            payload = {"next_id": next(self._ids),
                       "order": self._order,
                       "meta": {str(k): v for k, v in self._meta.items()}}
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, os.path.join(self.persist_dir, self.META_FILE))

    def _load_persisted(self) -> None:
        index_path = os.path.join(self.persist_dir, self.INDEX_FILE)
        meta_path = os.path.join(self.persist_dir, self.META_FILE)
        if not (os.path.exists(index_path) and os.path.exists(meta_path)):
            return
        try:
            with open(meta_path) as f:
                payload = json.load(f)
            loaded = load_index(index_path)
            if loaded is None:
                return
            if loaded.dim != self.embedder.dim:
                logger.warning(
                    "semantic cache restore skipped: persisted index dim "
                    "%d != embedder dim %d (embedder changed?)",
                    loaded.dim, self.embedder.dim)
                return
            self.index = loaded
            self._meta = {int(k): v for k, v in payload["meta"].items()}
            self._order = list(payload["order"])
            self._ids = itertools.count(int(payload["next_id"]))
            logger.info("semantic cache restored: %d entries",
                        len(self._meta))
        except (OSError, ValueError, KeyError) as e:
            logger.warning("semantic cache restore failed: %s", e)

    # -- metrics ---------------------------------------------------------

    @property
    def hit_ratio(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def __len__(self) -> int:
        with self._lock:
            return len(self._meta)
