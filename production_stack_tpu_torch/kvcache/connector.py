"""Engine-side KV connector: moves KV chunks between the device pool and
the tiers (``production_stack_tpu/kvcache/connector.py``).

The engine builds one from ``EngineConfig.kv_transfer_config`` (the
reference engine's ``--kv-transfer-config``); roles ``kv_producer`` /
``kv_consumer`` split prefill and decode pools for disaggregated
prefill, ``kv_both`` does both.

  consumer path: ``prefetch()`` runs on the caller's thread at
    request-add time: chain-hash the prompt, walk the tiers until the
    first miss (pipeline.py), and copy the hits into host tensors
    (pinned where the engine runs on CUDA). ``inject()`` runs on the
    engine loop at slot assignment and only enqueues each chunk's H2D
    copy and scatter into the slot's blocks (``runner.inject_chunk``):
    no host I/O on the loop.

  producer path: ``on_prefill_progress()`` (after each prefill chunk),
    ``on_finish()`` and ``on_migrate()`` enqueue each new chunk's gather
    out of the pool (``runner.extract_chunk``, a fresh device tensor) on
    the engine's stream, so the read is ordered before any later step
    reuses the slot, then its copy into pinned host memory with
    ``non_blocking=True`` and a CUDA event. The engine loop never waits
    for the D2H: the writer thread waits on the event, serializes and
    writes through the tiers. The device tensors ride the work item
    until the copy has landed, and the save queue's bound (64 items)
    bounds the pinned memory.

Chunk value layout: k_bytes + v_bytes, each [L, chunk, Hkv, D] in the
wire dtype, C-order, then a blake2b-8 digest of both. The wire dtype is
the pool's (bfloat16 or float32), and bfloat16 for an int8 pool, which
dequantizes on the way out and re-quantizes on the way in; the key
namespace (chunks.model_fingerprint) is that of the wire dtype, so a
bf16-pool producer serves an int8-pool consumer. Keys and bytes are the
JAX package's: a JAX engine and a port engine share one tier.
"""

import dataclasses
import hashlib
import queue
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from production_stack_tpu_torch.kvcache.chunks import (ChunkHasher,
                                                       model_fingerprint)
from production_stack_tpu_torch.kvcache.store import (KVStore, RemoteStore,
                                                      TieredStore,
                                                      make_store)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

_WIRE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class KVTransferConfig:
    """Parsed form of the engine's --kv-transfer-config JSON."""
    kv_role: str = "kv_both"            # kv_producer | kv_consumer | kv_both
    chunk_size: int = 256
    local_cpu_gb: float = 0.0           # host-DRAM tier budget
    local_disk_path: Optional[str] = None
    local_disk_gb: float = 16.0
    remote_url: Optional[str] = None    # tpukv://host:port
    # remote-tier failure bounds: a dead or hung cache server degrades
    # to recompute, never stalls admission — per-op socket timeouts plus
    # a breaker that short-circuits every remote call after
    # `remote_breaker_threshold` consecutive failures for
    # `remote_breaker_cooldown_s` (store.RemoteStore)
    remote_connect_timeout_s: float = 2.0
    remote_io_timeout_s: float = 5.0
    remote_breaker_threshold: int = 3
    remote_breaker_cooldown_s: float = 10.0
    # wall-clock budget of one prefetch's tier walk, accounted per
    # remaining chunk (chunk i of n must land by budget*(i+1)/n); past
    # it the request prefills the rest
    prefetch_timeout_s: float = 2.0
    # up to `prefetch_workers` chunk reads in flight while earlier
    # chunks are consumed; `prefetch_pipeline: false` reads one at a
    # time (the fair-share deadlines apply either way)
    prefetch_pipeline: bool = True
    prefetch_workers: int = 4
    # per-tier codec, e.g. {"disk": "int8", "remote": "int4"}
    # (codec.py: raw | int8 | int4 | fp8); unmapped tiers hold the
    # connector's bytes as they are
    tier_codecs: Optional[dict] = None

    @classmethod
    def from_dict(cls, d: dict) -> "KVTransferConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        ignored = {k: v for k, v in d.items() if k not in known}
        if ignored:
            logger.warning("kv_transfer_config: ignoring keys %s",
                           sorted(ignored))
        return cls(**{k: v for k, v in d.items() if k in known})

    @property
    def enabled(self) -> bool:
        return (self.local_cpu_gb > 0 or bool(self.local_disk_path)
                or bool(self.remote_url))

    @property
    def is_producer(self) -> bool:
        return self.kv_role in ("kv_producer", "kv_both")

    @property
    def is_consumer(self) -> bool:
        return self.kv_role in ("kv_consumer", "kv_both")


@dataclasses.dataclass
class Prefetch:
    """Host-side KV of a prompt's cached prefix, ready to inject."""
    keys: List[bytes]
    # per-chunk (k, v) host tensors [L, chunk, Hkv, D] in the wire dtype
    chunks: List[Tuple[torch.Tensor, torch.Tensor]]
    cached_tokens: int                  # capped at len(prompt) - 1
    # wall seconds of the tier walk (the request paid it before queueing)
    wait_s: float = 0.0


def tensor_bytes(t: torch.Tensor) -> bytes:
    """A host tensor's bytes, C-order."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


class KVConnector:
    _DIGEST_BYTES = 8
    # engine-thread dedup of keys already queued or saved
    _SEEN_CAP = 65536

    def __init__(self, runner, model_cfg, engine_cfg, cfg: KVTransferConfig,
                 store: Optional[KVStore] = None):
        self.runner = runner
        self.cfg = cfg
        self.chunk_size = cfg.chunk_size
        # the namespace is the WIRE dtype's: an int8 pool moves bf16
        # chunks, so int8 and bf16 engines of one model share a tier
        wire = ("bfloat16" if runner.cache.quantized
                else str(runner.cache.k.dtype).replace("torch.", ""))
        if wire not in _WIRE_DTYPES:
            raise ValueError(f"KV tiering does not support kv dtype "
                             f"{wire!r} (supported: {list(_WIRE_DTYPES)})")
        self.wire_dtype = _WIRE_DTYPES[wire]
        self.hasher = ChunkHasher(
            cfg.chunk_size, namespace=model_fingerprint(model_cfg, wire))
        self.store = store if store is not None else make_store(
            local_cpu_bytes=int(cfg.local_cpu_gb * (1 << 30)),
            local_disk_path=cfg.local_disk_path,
            local_disk_bytes=int(cfg.local_disk_gb * (1 << 30)),
            remote_url=cfg.remote_url,
            remote_connect_timeout_s=cfg.remote_connect_timeout_s,
            remote_io_timeout_s=cfg.remote_io_timeout_s,
            remote_breaker_threshold=cfg.remote_breaker_threshold,
            remote_breaker_cooldown_s=cfg.remote_breaker_cooldown_s)
        if self.store is None:
            raise ValueError("KV transfer enabled but no tier configured")
        self._chunk_shape = (model_cfg.num_layers, cfg.chunk_size,
                             model_cfg.num_kv_heads, model_cfg.head_dim_)
        self._chunk_numel = int(np.prod(self._chunk_shape))
        self._chunk_bytes = self._chunk_numel * self.wire_dtype.itemsize
        # host chunks of a CUDA engine sit in pinned memory, so their
        # copies to and from the card run asynchronously
        self._pinned = runner.device.type == "cuda"
        if cfg.tier_codecs and store is None:
            # the tiers the connector built take their codecs; a store
            # handed in is used as it is
            from production_stack_tpu_torch.kvcache.codec import \
                apply_tier_codecs
            self.store = apply_tier_codecs(
                self.store, dict(cfg.tier_codecs), dtype=wire,
                head_dim=model_cfg.head_dim_,
                chunk_body_bytes=2 * self._chunk_bytes)
        self._fetcher = None
        if cfg.is_consumer:
            from production_stack_tpu_torch.kvcache.pipeline import \
                PipelinedFetcher
            self._fetcher = PipelinedFetcher(
                workers=cfg.prefetch_workers if cfg.prefetch_pipeline
                else 1)
        # writer thread: lists of work items; bounded, so a slow tier
        # backpressures into dropped saves, never into the engine loop
        self._save_q: "queue.Queue" = queue.Queue(maxsize=64)
        # lists queued and not yet written (flush waits for 0)
        self._pending = 0
        self._pending_cv = threading.Condition()
        self._stop = threading.Event()
        self._writer = threading.Thread(target=self._writer_loop,
                                        name="kv-writer", daemon=True)
        self._writer.start()
        self._seen_keys: "dict[bytes, None]" = {}
        self.queries = 0
        self.query_tokens = 0
        self.hit_tokens = 0
        # hit tokens of chunks this process never published or fetched
        # before: another replica produced them
        self.foreign_hit_tokens = 0
        self.chunk_hits = 0
        self.chunk_misses = 0       # walk-terminating misses
        self.bytes_loaded = 0       # tier bytes materialized by prefetch
        self.bytes_saved = 0        # tier bytes written through
        self.published_chunks = 0   # producer: chunks written through
        self.progress_published_chunks = 0   # ...of which mid-prefill
        self.rejected_chunks = 0    # size/checksum-invalid values
        self.prefetch_deadline_hits = 0
        # walks cut because ONE chunk blew its fair-share slice
        self.prefetch_chunk_deadline_hits = 0
        # chunk reads issued while an earlier chunk was being consumed
        self.pipelined_fetches = 0
        self.dropped_saves = 0
        # chunk hits by the tier that served them (cpu / disk / remote)
        self.tier_hits: "dict[str, int]" = {}
        # kvplane migration: chunks published by migrate_out here (the
        # source) / pulled warm by the warm endpoint (the destination)
        self.migrated_chunks = 0
        self.warmed_chunks = 0
        # the owning engine's phase histograms (kv_prefetch, kv_publish);
        # None records nothing
        self.phase_recorder = None

    # -- consumer path --------------------------------------------------

    def prefetch(self, prompt_tokens: Sequence[int],
                 salt: str = "") -> Optional[Prefetch]:
        """Fetch the longest cached chunk-prefix into host memory, off
        the engine loop. The last prompt token is never served from the
        tiers (prefill must compute first-token logits), so hits are
        capped at len(prompt) - 1. ``salt`` keys KV variants (a LoRA
        adapter's name)."""
        if not self.cfg.is_consumer:
            return None
        n = len(prompt_tokens)
        self.queries += 1
        self.query_tokens += n
        keys = self.hasher.chunk_keys(prompt_tokens, salt=salt)
        chunks: List[Tuple[torch.Tensor, torch.Tensor]] = []
        hit_keys: List[bytes] = []
        foreign: List[bool] = []
        t0 = time.monotonic()
        fetched, walk = self._fetcher.fetch_walk(
            keys, self.store.get_with_tier, self.cfg.prefetch_timeout_s)
        if walk.deadline_hits or walk.chunk_deadline_hits:
            self.prefetch_deadline_hits += 1
            self.prefetch_chunk_deadline_hits += walk.chunk_deadline_hits
        elif len(fetched) < len(keys):
            self.chunk_misses += 1
        self.pipelined_fetches += walk.pipelined_fetches
        for key, val, tier in fetched:
            kv = self._deserialize(key, val)
            if kv is None:
                break
            self.chunk_hits += 1
            if tier:
                self.tier_hits[tier] = self.tier_hits.get(tier, 0) + 1
            self.bytes_loaded += len(val)
            foreign.append(key not in self._seen_keys)
            chunks.append(kv)
            hit_keys.append(key)
        wait_s = time.monotonic() - t0
        if self.phase_recorder is not None:
            self.phase_recorder.observe("kv_prefetch", wait_s)
        if not chunks:
            return None
        cached = min(len(chunks) * self.chunk_size, n - 1)
        self.hit_tokens += cached
        for i, is_foreign in enumerate(foreign):
            if is_foreign:
                self.foreign_hit_tokens += max(
                    0, min(self.chunk_size, cached - i * self.chunk_size))
        return Prefetch(keys=hit_keys, chunks=chunks, cached_tokens=cached,
                        wait_s=wait_s)

    def inject(self, prefetch: Prefetch, slot: int) -> None:
        """Enqueue the cached chunks' copies into the slot's blocks
        (engine loop, under the engine lock)."""
        for i, (k, v) in enumerate(prefetch.chunks):
            self.runner.inject_chunk(slot, i * self.chunk_size, k, v)
        self.mark_seen(prefetch.keys)

    def mark_seen(self, keys) -> None:
        """Record keys the tier already holds (no re-publish at finish),
        also where the HBM prefix pool covered the prompt and the
        prefetched chunks are dropped without injection."""
        for key in keys:
            self._mark_seen(key)

    # -- producer path --------------------------------------------------

    def on_prefill_progress(self, seq, salt: str = "") -> None:
        """Publish the full PROMPT chunks prefilled so far, so a decode
        engine can pull the prefix while later chunks still prefill.
        Keys dedup through the seen set, so on_finish skips them."""
        if not self.cfg.is_producer:
            return
        self._publish(seq, seq.prompt_tokens[:seq.num_prefilled],
                      seq.slot, salt, progress=True)

    def on_finish(self, seq, salt: str = "") -> None:
        """Publish a finished sequence's full chunks, before its slot is
        released. The last sampled token is excluded: its KV position
        was never computed (decode writes the KV of its input)."""
        if not self.cfg.is_producer:
            return
        self._publish(seq, (seq.prompt_tokens + seq.output_tokens)[:-1],
                      seq.slot, salt)

    def on_migrate(self, seq, salt: str = "") -> List[bytes]:
        """Publish a LIVE sequence's computed full chunks for kvplane
        migration and return every key of that range (published ones
        included: the destination warms them all). A mid-prefill victim
        publishes its prefilled prompt prefix; a decoding one publishes
        as ``on_finish``. ``flush()`` afterwards makes it tier-visible."""
        if not self.cfg.is_producer:
            return []
        if seq.num_prefilled < len(seq.prompt_tokens):
            tokens = seq.prompt_tokens[:seq.num_prefilled]
        else:
            tokens = (seq.prompt_tokens + seq.output_tokens)[:-1]
        n_chunks = self.hasher.num_full_chunks(len(tokens))
        if n_chunks == 0:
            return []
        keys = self.hasher.chunk_keys(tokens, salt=salt)[:n_chunks]
        self._publish(seq, tokens, seq.slot, salt)
        self.migrated_chunks += len(keys)
        return keys

    def _publish(self, seq, tokens, slot: int, salt: str,
                 progress: bool = False) -> None:
        n_chunks = self.hasher.num_full_chunks(len(tokens))
        if n_chunks == 0 or slot < 0:
            return
        # the key chain rides the sequence and extends incrementally:
        # progressive publish runs once per prefill chunk
        state = seq.kv_publish_state
        start_chunk = state[0] if state else 0
        new_keys, state = self.hasher.chain_keys(tokens, salt=salt,
                                                 state=state)
        seq.kv_publish_state = state
        work = []
        for i, key in enumerate(new_keys, start=start_chunk):
            if key in self._seen_keys:
                continue
            k_dev, v_dev = self.runner.extract_chunk(
                slot, i * self.chunk_size, self.chunk_size)
            # a chunk counts as progress-published only once its put
            # succeeds, on the writer thread
            work.append((key, *self._to_host(k_dev, v_dev), progress))
            self._mark_seen(key)
        if not work:
            return
        with self._pending_cv:
            self._pending += 1
        try:
            self._save_q.put_nowait(work)
        except queue.Full:
            with self._pending_cv:
                self._pending -= 1
                self._pending_cv.notify_all()
            self.dropped_saves += len(work)
            for item in work:   # a later finish may retry them
                self._seen_keys.pop(item[0], None)

    @staticmethod
    def _to_host(k_dev: torch.Tensor, v_dev: torch.Tensor):
        """(k host, v host, CUDA event or None, device tensors to keep
        alive): on CUDA the copies into pinned memory are enqueued on
        the current stream and an event is recorded behind them; the
        caller never waits. On the CPU the gathered tensors are the host
        copies already."""
        if k_dev.device.type != "cuda":
            return k_dev, v_dev, None, None
        k = torch.empty(k_dev.shape, dtype=k_dev.dtype, pin_memory=True)
        v = torch.empty(v_dev.shape, dtype=v_dev.dtype, pin_memory=True)
        k.copy_(k_dev, non_blocking=True)
        v.copy_(v_dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return k, v, event, (k_dev, v_dev)

    def _writer_loop(self) -> None:
        while not self._stop.is_set():
            try:
                work = self._save_q.get(timeout=0.2)
            except queue.Empty:
                continue
            t0 = time.monotonic()
            try:
                for key, k, v, event, _dev, progress in work:
                    try:
                        if event is not None:
                            event.synchronize()   # the D2H has landed
                        val = self._serialize(k, v)
                        if self.store.put(key, val):
                            self.bytes_saved += len(val)
                            self.published_chunks += 1
                            if progress:
                                self.progress_published_chunks += 1
                    except Exception as e:   # never kill the writer
                        logger.warning("KV save failed: %s", e)
            finally:
                del work
                if self.phase_recorder is not None:
                    # one write-through batch: the D2H wait,
                    # serialization and the tier puts
                    self.phase_recorder.observe(
                        "kv_publish", time.monotonic() - t0)
                with self._pending_cv:
                    self._pending -= 1
                    self._pending_cv.notify_all()

    # -- serialization ---------------------------------------------------

    @classmethod
    def _digest(cls, data) -> bytes:
        return hashlib.blake2b(data, digest_size=cls._DIGEST_BYTES).digest()

    def _serialize(self, k: torch.Tensor, v: torch.Tensor) -> bytes:
        """Host chunks -> the tier value (k bytes, v bytes, digest)."""
        body = tensor_bytes(k) + tensor_bytes(v)
        return body + self._digest(body)

    def _deserialize(self, key: bytes, val: bytes) -> \
            Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """A tier value -> (k, v) host tensors in the wire dtype (one
        copy, into pinned memory on a CUDA engine), or None for a value
        of the wrong size or digest, which is rejected."""
        want = 2 * self._chunk_bytes + self._DIGEST_BYTES
        if len(val) != want:
            logger.warning("KV chunk size mismatch: %d != %d (evicting "
                           "%s)", len(val), want, key.hex()[:16])
            self._reject(key)
            return None
        body = memoryview(val)[:-self._DIGEST_BYTES]
        if self._digest(body) != val[-self._DIGEST_BYTES:]:
            logger.warning("KV chunk checksum mismatch (evicting %s)",
                           key.hex()[:16])
            self._reject(key)
            return None
        buf = torch.empty(2 * self._chunk_bytes, dtype=torch.uint8,
                          pin_memory=self._pinned)
        buf.numpy()[:] = np.frombuffer(body, np.uint8)
        kv = buf.view(self.wire_dtype)
        n = self._chunk_numel
        return (kv[:n].view(self._chunk_shape),
                kv[n:].view(self._chunk_shape))

    def _reject(self, key: bytes) -> None:
        """Invalid tier value: count it and delete the poisoned key so
        the next producer pass can republish a good copy."""
        self.rejected_chunks += 1
        try:
            self.store.delete(key)
        except Exception:      # deletion is best-effort cleanup
            pass
        self._seen_keys.pop(key, None)

    # -- misc ------------------------------------------------------------

    def _mark_seen(self, key: bytes) -> None:
        self._seen_keys[key] = None
        while len(self._seen_keys) > self._SEEN_CAP:
            self._seen_keys.pop(next(iter(self._seen_keys)))

    @property
    def hit_rate(self) -> float:
        return self.hit_tokens / self.query_tokens if self.query_tokens \
            else 0.0

    def remote_breaker_open(self) -> bool:
        """True while the remote tier (if any) is being skipped."""
        stores = self.store.tiers if isinstance(self.store, TieredStore) \
            else [self.store]
        # a codec-wrapped tier hides the RemoteStore one level down
        stores = [getattr(s, "inner", s) for s in stores]
        return any(s.breaker_open() for s in stores
                   if isinstance(s, RemoteStore))

    def codec_stats(self) -> list:
        """Per-tier codec accounting ({tier, codec, bytes_in/out,
        rejects}); empty without tier_codecs."""
        from production_stack_tpu_torch.kvcache.codec import codec_stats_of
        return codec_stats_of(self.store)

    def warm_keys(self, keys: List[bytes]) -> Tuple[int, int]:
        """Pull raw chunk values for ``keys`` through the tier walk so
        hits promote into this replica's fastest tier (the kvplane
        migration's destination). Returns (warmed, missed)."""
        warmed = missed = 0
        for key in keys:
            val, _tier = self.store.get_with_tier(key)
            if val is None:
                missed += 1
            else:
                warmed += 1
                self.warmed_chunks += 1
                self._mark_seen(key)
        return warmed, missed

    def tier_stats(self) -> dict:
        """{tier_name: {bytes, count, ...}} for the occupancy gauges."""
        try:
            return self.store.tier_stats()
        except Exception as e:    # a sick tier must not break /load
            logger.warning("KV tier stats failed: %s", e)
            return {}

    def stats_report(self) -> dict:
        """Counters served on /load's ``kv_cache`` block (and folded into
        /metrics): what the cache-aware router and the disagg, kvshare
        and kvplane control loops read."""
        return {
            "role": self.cfg.kv_role,
            "queries": self.queries,
            "query_tokens": self.query_tokens,
            "hit_tokens": self.hit_tokens,
            "foreign_hit_tokens": self.foreign_hit_tokens,
            "hit_rate": round(self.hit_rate, 4),
            "chunk_hits": self.chunk_hits,
            "chunk_misses": self.chunk_misses,
            "bytes_loaded": self.bytes_loaded,
            "bytes_saved": self.bytes_saved,
            "published_chunks": self.published_chunks,
            "progress_published_chunks": self.progress_published_chunks,
            "rejected_chunks": self.rejected_chunks,
            "dropped_saves": self.dropped_saves,
            "prefetch_deadline_hits": self.prefetch_deadline_hits,
            "prefetch_chunk_deadline_hits":
                self.prefetch_chunk_deadline_hits,
            "pipelined_fetches": self.pipelined_fetches,
            "migrated_chunks": self.migrated_chunks,
            "warmed_chunks": self.warmed_chunks,
            "codecs": self.codec_stats(),
            "tier_hits": dict(self.tier_hits),
            "remote_breaker_open": self.remote_breaker_open(),
            # the remote tier's occupancy is the cache server's own; its
            # local entry carries only the breaker state (no bytes)
            "tiers": {name: {"bytes": st.get("bytes", 0),
                             "count": st.get("count", 0)}
                      for name, st in self.tier_stats().items()
                      if "bytes" in st},
        }

    def flush(self, timeout: float = 30.0) -> None:
        """Block until every queued save is written (tests, migration,
        shutdown), or the timeout passes."""
        deadline = time.monotonic() + timeout
        with self._pending_cv:
            while self._pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._pending_cv.wait(left)

    def close(self) -> None:
        self.flush(timeout=5.0)
        self._stop.set()
        self._writer.join(timeout=5.0)
        if self._fetcher is not None:
            self._fetcher.close()
        self.store.close()
