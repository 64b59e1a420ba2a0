"""Token-chunk prefix hashing for KV reuse
(``production_stack_tpu/kvcache/chunks.py``).

KV for a token depends on the whole prefix before it, so chunk keys are
a hash *chain*: chunk i's key digests chunk i's tokens together with
chunk i-1's key. Two prompts sharing a prefix produce identical keys
exactly up to their longest common chunk-aligned prefix; lookup walks
the chain until the first miss. Only full chunks are stored (a partial
tail is recomputed).

Keys are identical across processes, replicas and the two packages (a
JAX engine and a port engine share one tier namespace): hashlib.blake2b
over a canonical little-endian int32 packing, never Python's salted
hash(). The paged pool's prefix cache (engine/block_manager.py) keys its
blocks with the same hasher.
"""

import hashlib
import struct
from typing import List, Optional, Sequence, Tuple

DEFAULT_CHUNK_SIZE = 256


def chain_digest_bytes(data: bytes, chunk_bytes: int,
                       digest_size: int = 12) -> List[bytes]:
    """Chained digests of ``data``'s full ``chunk_bytes`` chunks: the
    byte-level analogue of ``ChunkHasher.chain_keys`` (digest i folds
    digest i-1), which the router's prefix ring computes over prompts."""
    out: List[bytes] = []
    prev = b""
    for i in range(0, len(data) - chunk_bytes + 1, chunk_bytes):
        h = hashlib.blake2b(digest_size=digest_size)
        h.update(prev)
        h.update(data[i:i + chunk_bytes])
        prev = h.digest()
        out.append(prev)
    return out


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

    def __init__(self, chunk_size: int = DEFAULT_CHUNK_SIZE,
                 namespace: str = ""):
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        self.chunk_size = chunk_size
        self.namespace = namespace

    def num_full_chunks(self, num_tokens: int) -> int:
        return num_tokens // self.chunk_size

    def chunk_keys(self, tokens: Sequence[int],
                   salt: str = "") -> List[bytes]:
        """Keys for every *full* chunk of `tokens`, in order. ``salt``
        extends the namespace for variants that give other KV from the
        same tokens (a LoRA adapter's name), so adapter and base chunks
        never collide."""
        keys, _ = self.chain_keys(tokens, salt=salt)
        return keys

    def chain_keys(self, tokens: Sequence[int], salt: str = "",
                   state: Optional[Tuple[int, bytes]] = None,
                   ) -> Tuple[List[bytes], Tuple[int, bytes]]:
        """Incremental chunk_keys: (new_keys, state'), where state =
        (chunks_already_keyed, previous_digest) from an earlier call
        over a PREFIX of the same token stream (progressive publish
        keys only the new chunks of each prefill chunk)."""
        start = 0
        prev = (self.namespace + ("|" + salt if salt else "")).encode()
        if state is not None:
            start, prev = state
        keys: List[bytes] = []
        n = self.num_full_chunks(len(tokens))
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
