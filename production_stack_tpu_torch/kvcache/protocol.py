"""TPKV binary wire protocol (``production_stack_tpu/kvcache/protocol.py``),
spoken by the remote tier's client (store.RemoteStore), the asyncio
cache server (server.py) and the native ``pskv-server``
(``native/pskv.cpp``). Byte-identical to the JAX package's, so a port
engine and a JAX engine share one cache server. URL scheme
``tpukv://host:port``.

Frame layout (all integers big-endian):
  request:  u32 magic 'TPKV' | u8 op | u16 key_len | u64 val_len
            | key bytes | val bytes
  response: u8 status (0 OK, 1 MISSING, 2 ERROR) | u64 val_len | val bytes
"""

import struct
from typing import Tuple
from urllib.parse import urlparse

MAGIC = 0x54504B56  # "TPKV"

OP_PUT = 1
OP_GET = 2
OP_EXISTS = 3
OP_DEL = 4
OP_STATS = 5
OP_PING = 6

STATUS_OK = 0
STATUS_MISSING = 1
STATUS_ERROR = 2

MAX_VAL = 1 << 32  # 4 GiB frame cap (as the native server's)

_REQ_HDR = struct.Struct(">IBHQ")
_RESP_HDR = struct.Struct(">BQ")

REQ_HDR_SIZE = _REQ_HDR.size    # 15
RESP_HDR_SIZE = _RESP_HDR.size  # 9


def encode_request(op: int, key: bytes = b"", val: bytes = b"") -> bytes:
    if len(val) > MAX_VAL:
        raise ValueError(f"value too large: {len(val)}")
    return _REQ_HDR.pack(MAGIC, op, len(key), len(val)) + key + val


def decode_request_header(hdr: bytes) -> Tuple[int, int, int]:
    """-> (op, key_len, val_len); raises on bad magic/oversize."""
    magic, op, klen, vlen = _REQ_HDR.unpack(hdr)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic:#x}")
    if vlen > MAX_VAL:
        raise ValueError(f"frame too large: {vlen}")
    return op, klen, vlen


def encode_response(status: int, val: bytes = b"") -> bytes:
    return _RESP_HDR.pack(status, len(val)) + val


def decode_response_header(hdr: bytes) -> Tuple[int, int]:
    """-> (status, val_len)."""
    return _RESP_HDR.unpack(hdr)


def parse_url(url: str) -> Tuple[str, int]:
    """'tpukv://host:port' -> (host, port). Accepts legacy 'lm://' too."""
    parsed = urlparse(url)
    if parsed.scheme not in ("tpukv", "lm"):
        raise ValueError(f"unsupported KV remote scheme: {url!r} "
                         "(expected tpukv://host:port)")
    if not parsed.hostname or not parsed.port:
        raise ValueError(f"remote URL needs host:port, got {url!r}")
    return parsed.hostname, parsed.port


def format_url(host: str, port: int) -> str:
    return f"tpukv://{host}:{port}"
