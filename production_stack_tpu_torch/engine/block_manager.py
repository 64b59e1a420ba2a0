"""Host-side allocator + prefix cache for the paged KV pool: a copy of
``production_stack_tpu/engine/block_manager.py``, with the chunk hasher
of ``production_stack_tpu/kvcache/chunks.py`` it keys prefixes by.

Pure bookkeeping over the block pool in models/kv.py — never touches the
device. Called only under the engine lock (admission, decode-window
extension, finish/abort), so it needs no locking of its own.

Prefix caching is block *sharing*: a finished sequence's full blocks
stay in the pool, registered under chain hashes of their token content
(ChunkHasher — chunk i's key digests chunk i's tokens AND chunk i-1's
key, so equal keys imply an identical full prefix). A new prompt that
matches a chain of registered blocks points its block table at them
(refcount++), paying zero copies.

Invariants:
- Block 0 (trash) is never allocated.
- A sequence writes only into blocks it exclusively owns: matching is
  capped so shared blocks are always fully-written full blocks, and a
  prompt always recomputes at least its final position (a sampled
  token needs live logits).
- Registered blocks with refcount 0 sit in an LRU; allocation prefers
  the free list and evicts LRU-registered blocks only when it is empty.
"""

import collections
import hashlib
import struct
from typing import Dict, List, Optional, Sequence, Tuple


def model_fingerprint(cfg, kv_dtype: str = "bfloat16") -> str:
    """Cache-key namespace: everything the KV layout/values depend on
    (the same digest as the JAX package's, so keys agree across the
    two)."""
    raw = (f"{cfg.name}|L{cfg.num_layers}|H{cfg.num_kv_heads}"
           f"|D{cfg.head_dim_}|rope{cfg.rope_theta}|{kv_dtype}")
    return hashlib.blake2b(raw.encode(), digest_size=8).hexdigest()


class ChunkHasher:
    """Chained blake2b keys over full token chunks: chunk i's key digests
    its tokens (little-endian int32) and chunk i-1's digest, so equal
    keys imply an identical whole prefix."""

    def __init__(self, chunk_size: int, namespace: str = ""):
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        self.chunk_size = chunk_size
        self.namespace = namespace

    def chunk_keys(self, tokens: Sequence[int],
                   salt: str = "") -> List[bytes]:
        """Keys for every *full* chunk of `tokens`, in order."""
        keys, _ = self.chain_keys(tokens, salt=salt)
        return keys

    def chain_keys(self, tokens: Sequence[int], salt: str = "",
                   state: Optional[Tuple[int, bytes]] = None,
                   ) -> Tuple[List[bytes], Tuple[int, bytes]]:
        """Incremental chunk_keys: (new_keys, state'), where state =
        (chunks_already_keyed, previous_digest) from an earlier call
        over a PREFIX of the same token stream."""
        start = 0
        prev = (self.namespace + ("|" + salt if salt else "")).encode()
        if state is not None:
            start, prev = state
        keys: List[bytes] = []
        n = len(tokens) // self.chunk_size
        for i in range(start, n):
            chunk = tokens[i * self.chunk_size:(i + 1) * self.chunk_size]
            h = hashlib.blake2b(digest_size=16)
            h.update(prev)
            h.update(struct.pack(f"<{len(chunk)}i", *chunk))
            digest = h.digest()
            keys.append(self.namespace.encode() + b":"
                        + digest.hex().encode())
            prev = digest
        return keys, (max(n, start), prev)


class BlockManager:
    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_caching: bool = False,
                 namespace: str = ""):
        if num_blocks < 2:
            raise ValueError("pool needs at least one non-trash block")
        self.num_blocks = num_blocks          # includes trash block 0
        self.block_size = block_size
        self.hasher = (ChunkHasher(block_size, namespace="blk|" + namespace)
                       if enable_prefix_caching else None)
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}        # block -> refcount (>= 1)
        self._by_key: Dict[bytes, int] = {}   # chain key -> block
        self._key_of: Dict[int, bytes] = {}   # block -> chain key
        # registered blocks with refcount 0, insertion order = LRU
        self._evictable: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        # prefix-cache admissions that matched a block / matched none
        self.hits = 0
        self.misses = 0
        # pool telemetry (plain ints, read at scrape time): allocation
        # failures split by why the pool refused — zero allocatable
        # blocks (exhausted), or fewer than the request needs
        # (fragmented)
        self.allocs = 0
        self.blocks_allocated = 0
        self.alloc_failures_exhausted = 0
        self.alloc_failures_fragmented = 0
        self.cache_evictions = 0
        # optional observer called with the pool usage at every
        # allocation attempt (the metrics layer's occupancy histogram)
        self.on_alloc_occupancy = None

    # -- capacity --------------------------------------------------------

    @property
    def available(self) -> int:
        """Blocks allocatable right now (free + evictable-cached)."""
        return len(self._free) + len(self._evictable)

    @property
    def active_blocks(self) -> int:
        """Blocks held by live sequences."""
        return len(self._ref)

    @property
    def usage(self) -> float:
        return self.active_blocks / float(self.num_blocks - 1)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def frag_report(self) -> dict:
        """Point-in-time census of the pool (plain-int reads): block
        states and the allocation-failure classification, served in
        ``/load``'s ``kv_pool`` block and folded into ``/metrics``."""
        return {
            "num_blocks": self.num_blocks - 1,   # allocatable, no trash
            "free": len(self._free),
            "active": self.active_blocks,
            "cached": len(self._evictable),
            "usage": round(self.usage, 4),
            "allocs": self.allocs,
            "blocks_allocated": self.blocks_allocated,
            "alloc_failures_exhausted": self.alloc_failures_exhausted,
            "alloc_failures_fragmented": self.alloc_failures_fragmented,
            "cache_evictions": self.cache_evictions,
            "free_contiguity": round(self.free_contiguity(), 4),
        }

    def free_contiguity(self) -> float:
        """Fraction of adjacent free-block-id pairs: 1.0 when the free
        list is one dense run."""
        if len(self._free) < 2:
            return 1.0
        s = sorted(self._free)
        runs = sum(1 for a, b in zip(s, s[1:]) if b == a + 1)
        return runs / (len(s) - 1)

    def blocks_for(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)

    # -- allocation ------------------------------------------------------

    def _take_one(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        if self._evictable:
            blk, _ = self._evictable.popitem(last=False)   # LRU out
            key = self._key_of.pop(blk)
            del self._by_key[key]
            self.cache_evictions += 1
            return blk
        return None

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh exclusive blocks (refcount 1), or None — all-or-
        nothing, so a failed admission/extension never leaks blocks."""
        if n <= 0:
            return None if n < 0 else []
        self.allocs += 1
        if self.on_alloc_occupancy is not None:
            self.on_alloc_occupancy(self.usage)
        if self.available < n:
            if self.available == 0:
                self.alloc_failures_exhausted += 1
            else:
                self.alloc_failures_fragmented += 1
            return None
        out = []
        for _ in range(n):
            blk = self._take_one()
            self._ref[blk] = 1
            out.append(blk)
        self.blocks_allocated += n
        return out

    def free(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block; refcount-0 registered blocks
        become LRU-evictable (their KV stays valid in the pool), others
        return to the free list."""
        for blk in blocks:
            r = self._ref.get(blk, 0) - 1
            if r > 0:
                self._ref[blk] = r
                continue
            self._ref.pop(blk, None)
            if blk in self._key_of:
                self._evictable[blk] = None    # MRU end
            else:
                self._free.append(blk)

    # -- prefix sharing --------------------------------------------------

    def prefix_keys(self, tokens: Sequence[int],
                    salt: str = "") -> List[bytes]:
        """Chain keys for the matchable prefix of a prompt: full blocks
        covering at most len(tokens)-1 positions (the sequence never
        writes into a shared block and always recomputes at least one
        position). Deterministic — callers may cache per prompt to
        avoid re-hashing on deferred admissions."""
        if self.hasher is None or len(tokens) < 2:
            return []
        usable = (len(tokens) - 1) // self.block_size
        if not usable:
            return []
        return self.hasher.chunk_keys(
            list(tokens[:usable * self.block_size]), salt=salt)

    def match_keys(self, keys: Sequence[bytes],
                   record_stats: bool = True) -> Tuple[List[int], int]:
        """Longest registered block chain along `keys` -> (pinned block
        ids, covered token count). Matched blocks are pinned
        (refcount++) — the caller owns them like alloc'd ones and must
        free() them. record_stats=False skips the hit/miss counters (a
        deferred admission's retries count once)."""
        blocks: List[int] = []
        for key in keys:
            blk = self._by_key.get(key)
            if blk is None:
                break
            blocks.append(blk)
        if record_stats and self.hasher is not None:
            if blocks:
                self.hits += 1
            else:
                self.misses += 1
        for blk in blocks:
            r = self._ref.get(blk, 0)
            if r == 0:
                self._evictable.pop(blk, None)
            self._ref[blk] = r + 1
        return blocks, len(blocks) * self.block_size

    def register(self, tokens: Sequence[int], blocks: Sequence[int],
                 salt: str = "") -> int:
        """Register a finished sequence's full blocks for sharing.
        `tokens` must be exactly the WRITTEN positions' tokens
        (prompt + output[:-1]); only blocks fully covered by them are
        registered. Duplicate content (key already registered from
        another sequence) keeps the existing block. Call BEFORE
        free()ing the sequence's blocks. Returns blocks registered."""
        if self.hasher is None:
            return 0
        n = min(len(tokens) // self.block_size, len(blocks))
        if not n:
            return 0
        keys = self.hasher.chunk_keys(
            list(tokens[:n * self.block_size]), salt=salt)
        count = 0
        for key, blk in zip(keys, blocks):
            if key in self._by_key or blk in self._key_of:
                # shared-prefix blocks re-register under their own key
                # (skip), duplicates keep the first copy
                continue
            self._by_key[key] = blk
            self._key_of[blk] = key
            count += 1
        return count

    def register_incremental(self, tokens: Sequence[int],
                             blocks: Sequence[int], state,
                             salt: str = ""):
        """Progressive register() for live sequences: key and register
        only blocks completed SINCE the previous call, threading the
        hasher's (chunks_keyed, digest) chain state — O(new blocks)
        per prefill chunk where re-keying from scratch would make a
        long prompt's hashing quadratic (kvcache/chunks.chain_keys).
        Returns the new state; pass it back on the next call."""
        if self.hasher is None:
            return state
        n = min(len(tokens) // self.block_size, len(blocks))
        start = state[0] if state else 0
        if n <= start:
            return state
        new_keys, state = self.hasher.chain_keys(
            list(tokens[:n * self.block_size]), salt=salt, state=state)
        for key, blk in zip(new_keys, blocks[start:n]):
            if key in self._by_key or blk in self._key_of:
                continue
            self._by_key[key] = blk
            self._key_of[blk] = key
        return state
