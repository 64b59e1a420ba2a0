"""Per-tier KV chunk codecs: raw / int8 / int4 / fp8
(``production_stack_tpu/kvcache/codec.py``, byte for byte).

The slow tiers tolerate lossy codecs: decode bandwidth is not their
bottleneck, capacity is. ``CodecStore`` wraps one tier, encodes on
``put`` and decodes on ``get``, and re-appends the connector's own
full-chunk digest after decode, so ``KVConnector._deserialize`` still
checks what the engine will consume. Every encoded payload carries its
own trailing blake2b-8 over the encoded bytes (header included), so a
replica killed mid-PUT or a corrupt disk block reads as a MISS
(counted and evicted), never as dequantized garbage.

Encoded payload layout::

    b"KQ" | codec_id (1B) | version (1B) | codec body | blake2b-8

Codecs:

- ``raw``  — identity (1.0x), still checksummed.
- ``int8`` — symmetric per-row absmax over the head dim, f32 scales
  (~1.9x on bf16).
- ``int4`` — symmetric group quantization, 32 values per f32 scale,
  two values per byte (~3.2x on bf16).
- ``fp8``  — an e4m3 cast (2.0x).

The payloads are the JAX package's, bit for bit, so a port engine and a
JAX engine read each other's tiers. The JAX codecs take bfloat16 and
e4m3 from ``ml_dtypes``, which the port does not use:

- bfloat16 bodies widen to f32 by a 16-bit shift and narrow by
  round-to-nearest-even on the bits, NaN to 0x7fc0 with its sign, as
  ``ml_dtypes`` rounds (torch's cast writes another NaN);
- e4m3 encodes through torch's cast, which saturates where
  ``ml_dtypes`` gives NaN: magnitudes above 464 (the midpoint between
  448, the largest finite e4m3, and 480) and infinities are first
  mapped to NaN with their sign; e4m3 decodes through a 256-entry
  table whose NaN entries carry ``ml_dtypes``' f32 NaN (0x7fc00000
  with the sign).

Bodies are numpy views of bytes on the host; nothing here touches a
device.
"""

import hashlib
import struct
from typing import Dict, List, Optional

import numpy as np
import torch

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

MAGIC = b"KQ"
VERSION = 1
DIGEST_BYTES = 8
HEADER = struct.Struct("<2sBB")

_INT4_GROUP = 32
# body dtypes (the connector's wire dtype) and their item sizes
_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}
# |x| above this rounds past e4m3's largest finite value (448): NaN
_FP8_LIMIT = 464.0
_fp8_table: Optional[np.ndarray] = None


def _digest(payload: bytes) -> bytes:
    return hashlib.blake2b(payload, digest_size=DIGEST_BYTES).digest()


def _dtype_name(dtype) -> str:
    name = str(dtype).replace("torch.", "")
    if name not in _ITEMSIZE:
        raise ValueError(f"KV codec body dtype {dtype!r} unsupported "
                         f"(have: {sorted(_ITEMSIZE)})")
    return name


def bf16_bits(arr: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits (uint16), round to nearest even, NaN to
    0x7fc0 with its sign: the ``ml_dtypes`` cast, exactly."""
    u = np.ascontiguousarray(arr, np.float32).view(np.uint32)
    out = ((u + (0x7FFF + ((u >> 16) & 1))) >> 16).astype(np.uint16)
    nan = np.isnan(arr)
    if nan.any():
        out[nan] = np.where(u[nan] >> 31 != 0, 0xFFC0, 0x7FC0)
    return out


def to_f32(body: bytes, dtype: str) -> np.ndarray:
    """A body's values as a flat float32 array (exact)."""
    if dtype == "bfloat16":
        return (np.frombuffer(body, np.uint16).astype(np.uint32)
                << 16).view(np.float32)
    return np.frombuffer(body, np.dtype(dtype)).astype(np.float32)


def from_f32(arr: np.ndarray, dtype: str) -> bytes:
    """float32 values as body bytes in `dtype` (rounded as numpy and
    ``ml_dtypes`` round)."""
    if dtype == "bfloat16":
        return bf16_bits(arr).tobytes()
    return np.ascontiguousarray(arr.astype(dtype)).tobytes()


def _fp8_available() -> bool:
    return hasattr(torch, "float8_e4m3fn")


def fp8_encode(f32: np.ndarray) -> bytes:
    """float32 -> e4m3fn bytes as ``ml_dtypes`` casts them (NaN past
    +-464 and at +-inf, where torch's cast saturates)."""
    x = np.ascontiguousarray(f32, np.float32)
    over = np.abs(x) > _FP8_LIMIT
    if over.any():
        x = np.where(over, np.copysign(np.float32(np.nan), x), x)
    return torch.from_numpy(x).to(torch.float8_e4m3fn).view(
        torch.uint8).numpy().tobytes()


def fp8_decode(data: bytes) -> np.ndarray:
    """e4m3fn bytes -> float32 (exact; NaN as ``ml_dtypes`` gives it)."""
    global _fp8_table
    if _fp8_table is None:
        codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
        table = codes.view(torch.float8_e4m3fn).float().numpy().copy()
        bits = table.view(np.uint32)
        nan = np.isnan(table)
        bits[nan] = (bits[nan] & 0x80000000) | 0x7FC00000
        _fp8_table = table
    return _fp8_table[np.frombuffer(data, np.uint8)]


class Codec:
    """Encode/decode one chunk body (the connector's ``k+v`` bytes,
    WITHOUT its trailing digest). ``decode`` must reproduce the exact
    original byte length; lossy codecs reproduce approximate values.
    ``dtype``: the body's dtype (``"bfloat16"``, ``"float32"`` or
    ``"float16"``, or the torch dtype)."""

    name = "raw"
    codec_id = 0

    def __init__(self, dtype, head_dim: int):
        self.dtype = _dtype_name(dtype)
        self.itemsize = _ITEMSIZE[self.dtype]
        self.head_dim = int(head_dim)

    def encode(self, body: bytes) -> bytes:
        raise NotImplementedError

    def decode(self, data: bytes, body_len: int) -> bytes:
        raise NotImplementedError

    def _rows(self, body: bytes) -> np.ndarray:
        """Body as float32 rows over the head dim (the scale
        granularity: one (layer, position, head) vector per row)."""
        arr = to_f32(body, self.dtype)
        if arr.size % self.head_dim:
            raise ValueError(
                f"body of {arr.size} elems not divisible by head_dim "
                f"{self.head_dim}")
        return arr.reshape(-1, self.head_dim)


class RawCodec(Codec):
    name = "raw"
    codec_id = 0

    def encode(self, body: bytes) -> bytes:
        return body

    def decode(self, data: bytes, body_len: int) -> bytes:
        if len(data) != body_len:
            raise ValueError(f"raw payload {len(data)}B != body "
                             f"{body_len}B")
        return data


class Int8Codec(Codec):
    """Symmetric absmax int8, one f32 scale per head-dim row."""

    name = "int8"
    codec_id = 1

    def encode(self, body: bytes) -> bytes:
        rows = self._rows(body)
        scale = np.abs(rows).max(axis=1) / 127.0
        scale = np.maximum(scale, 1e-12).astype(np.float32)
        q = np.clip(np.rint(rows / scale[:, None]), -127, 127) \
            .astype(np.int8)
        return scale.tobytes() + q.tobytes()

    def decode(self, data: bytes, body_len: int) -> bytes:
        n_rows = body_len // (self.head_dim * self.itemsize)
        scale_bytes = n_rows * 4
        if len(data) != scale_bytes + n_rows * self.head_dim:
            raise ValueError("int8 payload size mismatch")
        scale = np.frombuffer(data[:scale_bytes], dtype=np.float32)
        q = np.frombuffer(data[scale_bytes:], dtype=np.int8) \
            .reshape(n_rows, self.head_dim).astype(np.float32)
        return from_f32(q * scale[:, None], self.dtype)


class Int4Codec(Codec):
    """Symmetric group quantization: 32 values per f32 scale, two
    4-bit values packed per byte (~3.2x over bf16)."""

    name = "int4"
    codec_id = 2

    def encode(self, body: bytes) -> bytes:
        flat = to_f32(body, self.dtype)
        if flat.size % _INT4_GROUP:
            raise ValueError(
                f"body of {flat.size} elems not divisible by int4 "
                f"group {_INT4_GROUP}")
        groups = flat.reshape(-1, _INT4_GROUP)
        scale = np.abs(groups).max(axis=1) / 7.0
        scale = np.maximum(scale, 1e-12).astype(np.float32)
        q = np.clip(np.rint(groups / scale[:, None]), -7, 7) \
            .astype(np.int8) + 8          # [1, 15]; 0 never produced
        packed = (q[:, 0::2] << 4 | q[:, 1::2]).astype(np.uint8)
        return scale.tobytes() + packed.tobytes()

    def decode(self, data: bytes, body_len: int) -> bytes:
        n = body_len // self.itemsize
        n_groups = n // _INT4_GROUP
        scale_bytes = n_groups * 4
        if len(data) != scale_bytes + n // 2:
            raise ValueError("int4 payload size mismatch")
        scale = np.frombuffer(data[:scale_bytes], dtype=np.float32)
        packed = np.frombuffer(data[scale_bytes:], dtype=np.uint8) \
            .reshape(n_groups, _INT4_GROUP // 2)
        q = np.empty((n_groups, _INT4_GROUP), dtype=np.int8)
        q[:, 0::2] = (packed >> 4) & 0x0F
        q[:, 1::2] = packed & 0x0F
        vals = (q.astype(np.float32) - 8.0) * scale[:, None]
        return from_f32(vals, self.dtype)


class Fp8Codec(Codec):
    """Straight e4m3fn cast (2.0x over bf16), as ``ml_dtypes`` casts
    (fp8_encode / fp8_decode)."""

    name = "fp8"
    codec_id = 3

    def __init__(self, dtype, head_dim: int):
        super().__init__(dtype, head_dim)
        if not _fp8_available():
            raise ValueError("codec 'fp8' needs torch.float8_e4m3fn, "
                             "which this torch does not provide")

    def encode(self, body: bytes) -> bytes:
        return fp8_encode(to_f32(body, self.dtype))

    def decode(self, data: bytes, body_len: int) -> bytes:
        if len(data) != body_len // self.itemsize:
            raise ValueError("fp8 payload size mismatch")
        return from_f32(fp8_decode(data), self.dtype)


CODECS = {c.name: c for c in (RawCodec, Int8Codec, Int4Codec, Fp8Codec)}
_BY_ID = {c.codec_id: c for c in CODECS.values()}


def codec_names() -> List[str]:
    names = [n for n in CODECS if n != "fp8" or _fp8_available()]
    return sorted(names)


def make_codec(name: str, *, dtype, head_dim: int) -> Codec:
    if name not in CODECS:
        raise ValueError(f"unknown KV codec {name!r} "
                         f"(have: {sorted(CODECS)})")
    return CODECS[name](dtype, head_dim)


def encode_payload(codec: Codec, body: bytes) -> bytes:
    """Self-describing encoded payload: header + codec body +
    blake2b-8 over everything before the digest."""
    payload = HEADER.pack(MAGIC, codec.codec_id, VERSION) \
        + codec.encode(body)
    return payload + _digest(payload)


def decode_payload(codec: Codec, data: bytes,
                   body_len: int) -> Optional[bytes]:
    """Verify + decode one encoded payload. Returns the reconstructed
    body (exactly ``body_len`` bytes) or None for anything torn,
    truncated, or foreign — the caller treats None as a miss."""
    if len(data) < HEADER.size + DIGEST_BYTES:
        return None
    if _digest(data[:-DIGEST_BYTES]) != data[-DIGEST_BYTES:]:
        return None
    magic, codec_id, version = HEADER.unpack_from(data)
    if magic != MAGIC or version != VERSION:
        return None
    if codec_id != codec.codec_id:
        # a tier whose configured codec changed across restarts reads
        # its old entries as misses; a later publish heals them
        return None
    try:
        body = codec.decode(data[HEADER.size:-DIGEST_BYTES], body_len)
    except (ValueError, TypeError):
        return None
    return body if len(body) == body_len else None


class CodecStore:
    """One tier wrapped with a codec.

    Values crossing this boundary are the connector's serialized
    chunks (``body + blake2b-8(body)``). ``put`` strips the connector
    digest, encodes the body, and stores the checksummed encoded
    payload; ``get`` verifies the post-encode checksum, decodes, and
    re-appends a fresh connector digest over the decoded body — so the
    connector's own ``_deserialize`` integrity check is preserved
    end to end, and ``TieredStore`` hit-promotion between tiers with
    different codecs re-encodes naturally (each tier's ``put`` sees
    plain serialized chunks).

    Counters (scraped into ``tpu:kvplane_codec_*``):

    - ``bytes_in`` / ``bytes_out`` — logical body bytes entering the
      encoder vs encoded bytes written (the compression accounting).
    - ``decoded_chunks`` — successful decodes on the read path.
    - ``rejects`` — torn/corrupt encoded payloads read as misses
      (the key is deleted so a later publish heals it).
    """

    def __init__(self, inner, codec: Codec, chunk_body_bytes: int):
        self.inner = inner
        self.codec = codec
        self.chunk_body_bytes = int(chunk_body_bytes)
        self.bytes_in = 0
        self.bytes_out = 0
        self.decoded_chunks = 0
        self.rejects = 0

    @property
    def tier_name(self) -> str:
        return self.inner.tier_name

    def _strip(self, value: bytes) -> Optional[bytes]:
        body = value[:-DIGEST_BYTES]
        if len(value) < DIGEST_BYTES or _digest(body) \
                != value[-DIGEST_BYTES:]:
            return None
        return body

    def put(self, key: bytes, value: bytes) -> bool:
        body = self._strip(value)
        if body is None:
            # never encode a value that is already torn — dropping it
            # here is what keeps a mid-migration kill a miss, not a
            # quantized copy of garbage
            return False
        payload = encode_payload(self.codec, body)
        self.bytes_in += len(body)
        self.bytes_out += len(payload)
        return self.inner.put(key, payload)

    def get(self, key: bytes) -> Optional[bytes]:
        data = self.inner.get(key)
        if data is None:
            return None
        body = decode_payload(self.codec, data, self.chunk_body_bytes)
        if body is None:
            self.rejects += 1
            try:
                self.inner.delete(key)
            except Exception:  # noqa: BLE001 - best-effort eviction
                pass
            return None
        self.decoded_chunks += 1
        return body + _digest(body)

    def get_with_tier(self, key: bytes):
        val = self.get(key)
        return (val, self.tier_name) if val is not None \
            else (None, None)

    def exists(self, key: bytes) -> bool:
        return self.inner.exists(key)

    def delete(self, key: bytes) -> bool:
        return self.inner.delete(key)

    def stats(self) -> Dict:
        return self.inner.stats()

    def tier_stats(self) -> List[Dict]:
        return self.inner.tier_stats()

    def codec_stats(self) -> Dict:
        return {"tier": self.tier_name, "codec": self.codec.name,
                "bytes_in": self.bytes_in, "bytes_out": self.bytes_out,
                "decoded_chunks": self.decoded_chunks,
                "rejects": self.rejects}

    def close(self) -> None:
        self.inner.close()


def apply_tier_codecs(store, tier_codecs: Dict[str, str], *,
                      dtype, head_dim: int,
                      chunk_body_bytes: int):
    """Wrap a store (or each tier of a TieredStore) per the
    ``{tier_name: codec_name}`` map. Unmapped tiers stay unwrapped
    (identical to ``raw`` minus the header/checksum overhead), so the
    default host tier keeps the connector's bytes as they are."""
    from production_stack_tpu_torch.kvcache.store import TieredStore

    def wrap(tier):
        name = tier_codecs.get(tier.tier_name)
        if not name:
            return tier
        codec = make_codec(name, dtype=dtype, head_dim=head_dim)
        return CodecStore(tier, codec, chunk_body_bytes)

    for tier_name in tier_codecs:
        if tier_name not in ("cpu", "disk", "remote"):
            raise ValueError(f"tier_codecs names unknown tier "
                             f"{tier_name!r} (have: cpu, disk, remote)")
    if isinstance(store, TieredStore):
        return TieredStore([wrap(t) for t in store.tiers])
    return wrap(store)


def codec_stats_of(store) -> List[Dict]:
    """Flat list of codec_stats() dicts from every CodecStore layer."""
    from production_stack_tpu_torch.kvcache.store import TieredStore
    out: List[Dict] = []
    if isinstance(store, CodecStore):
        out.append(store.codec_stats())
    elif isinstance(store, TieredStore):
        for t in store.tiers:
            if isinstance(t, CodecStore):
                out.append(t.codec_stats())
    return out
